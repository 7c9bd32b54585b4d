"""Experiment 30 on the H100: what a streaming step's fixed cost is made of.

The port of experiments/exp30_dma_granularity.py (its Pallas probe,
main.make_loop_db at :110). The loop form of exp27 (a persistent grid,
a cp.async ring) at fixed total bytes (a 256^3 float32 pass), swept
over tile size (blk 2, 4, 8, 16: blk x 4 KiB a step), commit groups per
fill (split 1, 2, 4) and ring depth (2, 3, 4). See probes.stream_probe.

    python -m soda_tpu_torch.experiments.exp30_dma_granularity
        [--device cpu] [--n N]

Output as exp27_gridloop's.
"""

from __future__ import annotations

import sys

from soda_tpu_torch.experiments import probes


def run(device='cuda', n=None, log=print):
  return probes.run_stream(probes.EXP30_CASES, device, n, log)


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv, grid_edge=True)
  return probes.entry(lambda: run(args.device, args.n))


if __name__ == '__main__':
  sys.exit(main())
