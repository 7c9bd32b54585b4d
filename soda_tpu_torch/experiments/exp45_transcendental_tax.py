"""Experiment 45 on the H100: what denoise's divides and roots cost.

The port of experiments/exp45_transcendental_tax.py (its Pallas probe,
pallas_loop at :71). Each body (ten chained FMA, divide, reciprocal,
square root and reciprocal square root steps; denoise2d's g-stage) runs
n times on a (256, 1024) float32 block in one launch, timed as
exp24_stage_tax's. The kernel is built with --fmad=false, as the port's
stencil kernels are; rsqrt is the approximate rsqrtf (the script's
lax.rsqrt), 1 / sqrt and divisions are IEEE. See probes.chain_probe.

    python -m soda_tpu_torch.experiments.exp45_transcendental_tax
        [--device cpu] [--decompose] [--n-small 64] [--n-big 16384]

``--decompose``: the g-stage and the whole denoise2d and denoise3d
updates, each with its shifts or its rsqrt taken out. Output as
exp24_stage_tax's.
"""

from __future__ import annotations

import sys

from soda_tpu_torch.experiments import probes


def run(device='cuda', decompose=False, n_small=64, n_big=16384, log=print):
  bodies = (probes.EXP45_DECOMPOSE_BODIES if decompose else
            probes.EXP45_BODIES)
  return probes.run_chain(bodies, device, n_small, n_big, log)


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv, ('--decompose',), chain=True)
  return probes.entry(lambda: run(args.device, args.decompose, args.n_small,
                                  args.n_big))


if __name__ == '__main__':
  sys.exit(main())
