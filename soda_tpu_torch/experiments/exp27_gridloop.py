"""Experiment 27 on the H100: one kernel entry per step, or a loop?

The port of experiments/exp27_gridloop.py (its Pallas probe, main.build
at :122). The same pass, y = x + 1 over a 256^3 float32 array moved
through shared memory in tiles of 16 KiB (BLK = 4: 4 x 4 KiB), runs
four ways: 'grid' (no CTA carries state to another: a tile per CTA, or
with double buffering a run of 8 tiles per CTA) against 'loop' (a
persistent grid of co-resident CTAs walking the tiles), each single
buffered (sync) and double buffered (db). See probes.stream_probe.

    python -m soda_tpu_torch.experiments.exp27_gridloop [--device cpu]
        [--n N]

On the card each case prints its cold-L2 ms, its share of the byte
bound, microseconds per step per CTA and per call back to back;
``--device cpu`` runs the plain version (N = 64, as the script's
interpret run) and prints OK where it equals x + 1.
"""

from __future__ import annotations

import sys

from soda_tpu_torch.experiments import probes


def run(device='cuda', n=None, log=print):
  return probes.run_stream(probes.EXP27_CASES, device, n, log)


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv, grid_edge=True)
  return probes.entry(lambda: run(args.device, args.n))


if __name__ == '__main__':
  sys.exit(main())
