"""The GPU validation gate (tools/gpu_validate.py) on the CPU.

``--cpu`` runs the gate's matrix through the kernels' plain versions,
as the JAX gate's ``--interpret`` runs its matrix without a TPU; here
on a few rows, at a smaller streaming extent. The contrast float64
check runs through the plain path (the counterpart of
tests/test_f64_evidence.py). The tables are held to the JAX gate's.
"""

import pytest

from soda_tpu.tools import tpu_validate
from soda_tpu_torch.backend import tile_plan
from soda_tpu_torch.tools import gpu_validate


def test_variants_are_the_jax_gates():
  assert gpu_validate.VARIANTS == tpu_validate.VARIANTS
  assert gpu_validate.SHAPES == tpu_validate.SHAPES
  assert gpu_validate.TILE == tpu_validate.TILE
  assert gpu_validate.THRESHOLD == tpu_validate.THRESHOLD
  assert gpu_validate.KERNEL_THRESHOLDS == tpu_validate.KERNEL_THRESHOLDS


def test_ex_variants_are_the_jax_rows_in_the_ports_keys():
  """One row per JAX row, the same tag, kernel and overrides; the
  structural keys kept, the VPU-layout keys left out."""
  assert len(gpu_validate.EX_VARIANTS) == len(tpu_validate.EX_VARIANTS)
  for port, jax in zip(gpu_validate.EX_VARIANTS, tpu_validate.EX_VARIANTS):
    assert port[:3] == jax[:3]
    kept = {k: v for k, v in jax[3].items()
            if k not in tile_plan.LAYOUT_KEYS}
    assert port[3] == kept, port[0]


def test_every_row_plans_and_generates():
  """Every case of ``--variants`` gives the kernel sources the gate
  builds at once before it runs."""
  for tag, kernel, variants, ex_opts in gpu_validate.cases(True):
    assert gpu_validate.sources(kernel, variants, ex_opts), tag


@pytest.mark.parametrize('rows', [
    'blur,contrast,jacobi3d',
    'erosion+cr,blur+coarse,blur+preserve',
    'jacobi3d+peel+split,blur+stream_loop,denoise3d+peel16,xcorr+hybrid320',
])
def test_gate_passes_on_the_cpu(rows, monkeypatch, capsys):
  small = {name: (min(shape[0], 96),) + shape[1:]
           for name, shape in gpu_validate.SHAPES.items()}
  monkeypatch.setattr(gpu_validate, 'SHAPES', small)
  code = gpu_validate.main(['--cpu', '--variants', '--only', rows])
  out = capsys.readouterr().out
  assert code == 0, out
  assert out.splitlines()[0].startswith('device: cpu')
  n = len(rows.split(','))
  assert '%d/%d cases pass' % (n, n) in out


def test_gate_fails_on_a_wrong_kernel(monkeypatch, capsys):
  """A row whose outputs differ from the oracle is a FAIL and the gate
  exits nonzero."""
  def wrong(name, variants=(), ex_opts=None, device='cuda', cache=None):
    return 3, 1.0

  monkeypatch.setattr(gpu_validate, 'check', wrong)
  code = gpu_validate.main(['--cpu', '--only', 'blur'])
  out = capsys.readouterr().out
  assert code == 1 and 'FAIL(3 bad' in out and '0/1 cases pass' in out


def test_gate_needs_a_card_without_cpu(capsys):
  import torch
  if torch.cuda.is_available():
    pytest.skip('a CUDA device exists here')
  assert gpu_validate.main(['--only', 'blur']) == 1
  assert 'no CUDA device' in capsys.readouterr().err


def test_contrast_kernel_at_least_as_close_to_f64_truth():
  err_exec, err_orac = gpu_validate.contrast_f64_check(device='cpu')
  # 1.05x slack: individual cells may round either way
  assert err_exec <= err_orac * 1.05 + 1e-9, (err_exec, err_orac)
