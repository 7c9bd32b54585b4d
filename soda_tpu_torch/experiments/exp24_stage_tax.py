"""Experiment 24 on the H100: what a chained stage costs.

The port of experiments/exp24_stage_tax.py (its Pallas probe,
pallas_loop at :75). Each body (ten chained min steps on a (256, 1024)
int32 block: unshifted, rolled, rolled against the original, chunked)
runs n times in one launch; its time per iteration is the slope between
two n. A shifted step needs other CTAs' cells. On the card a chain of
shifts along one axis is one phase of the strip kernel (whole lines a
CTA, no grid barrier); roll10's two phases (chunk128's too: its chunk
does not fit a CTA) take a grid barrier each; indep10's cross taps run
in one thread-block cluster whose registers hold the block, 16 rows a
CTA, a cluster barrier before each read of margin rows from the next
CTA; the chunked bodies run in one cluster of bands of half a chunk;
the unshifted chain stays in registers. See probes.chain_probe.

    python -m soda_tpu_torch.experiments.exp24_stage_tax [--device cpu]
        [--dists] [--n-small 64] [--n-big 16384]

``--dists``: five rolls of one distance, along rows and lanes. On the
card each body prints microseconds per iteration, ns per cell per step,
grid and cluster barriers per iteration, the bound (operations over the
issue rate; a cluster body's share on the cluster's SMs too)
and the kernel's largest error against its plain version at 1, 2, 5
and n-small iterations;
``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import sys

from soda_tpu_torch.experiments import probes


def run(device='cuda', dists=False, n_small=64, n_big=16384, log=print):
  bodies = probes.EXP24_DIST_BODIES if dists else probes.EXP24_BODIES
  return probes.run_chain(bodies, device, n_small, n_big, log)


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv, ('--dists',), chain=True)
  return probes.entry(lambda: run(args.device, args.dists, args.n_small,
                                  args.n_big))


if __name__ == '__main__':
  sys.exit(main())
