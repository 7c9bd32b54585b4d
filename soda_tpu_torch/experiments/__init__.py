"""The H100 counterparts of the JAX package's experiment probes.

Each module here is named after the script in ``experiments/`` whose
Pallas probe it ports, runs the same cases and prints one line per case:

    python -m soda_tpu_torch.experiments.exp27_gridloop [--device cpu]
    python -m soda_tpu_torch.experiments.exp30_dma_granularity
    python -m soda_tpu_torch.experiments.exp24_stage_tax [--dists]
    python -m soda_tpu_torch.experiments.exp45_transcendental_tax [--decompose]
    python -m soda_tpu_torch.experiments.exp13_narrow_i16 [legal] [time]
    python -m soda_tpu_torch.experiments.exp29_pack_i16
    python -m soda_tpu_torch.experiments.exp16_swar_erosion
    python -m soda_tpu_torch.experiments.exp12_mosaic_reprobe [native] [swar]
        [chain] [roll] [widen]
    python -m soda_tpu_torch.experiments.exp2_diag
    python -m soda_tpu_torch.experiments.exp1_value_mode
    python -m soda_tpu_torch.experiments.exp32_dma_shift [--check]
    python -m soda_tpu_torch.experiments.exp9_layout25d

``--device cuda`` (the default) launches the kernels of ``probes.py``,
``narrow.py``, ``copyshift.py`` and ``layout25d.py`` and exits 1
without a card; ``--device cpu`` runs their plain versions and prints
their check. ``chip_smoke.py`` drives them all on the card (phases
16-18).
"""
