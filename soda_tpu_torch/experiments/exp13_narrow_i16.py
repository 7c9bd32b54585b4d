"""Experiment 13 on the H100: which int16 ops, and at what cost a chain.

The port of experiments/exp13_narrow_i16.py (its Pallas probes,
legal_probes.run at :57 and chain_time.make at :195). ``legal``: the
script's twelve one-shot bodies on (256, 512) int16 blocks (compare and
select, subtract, bitwise ops, shifts, shifted-slice adds and 19-tap
folds over blocks with a margin); ``time``: chains of one wrap-around
shift and a min or add a step, lane or sublane, int32 against int16,
beside jnp.minimum and the packed i16x2 min (``__vmins2``, and the script's
bitwise SWAR sequence). See narrow.narrow_probe.

    python -m soda_tpu_torch.experiments.exp13_narrow_i16 [--device cpu]
        [legal] [time] [--n-small 32] [--n-big 512]

On the card each body prints its time (a one-shot body's cold-L2 ms, a
chain's µs per iteration as the slope from n-small to n-big), ps per
element-op, grid barriers, the bound and its share, the plain version's
and the library call's time, the largest error against the plain
version (a chain at 1, 2, 5 and n-small iterations) and its SASS;
``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import sys

from soda_tpu_torch.experiments import narrow, probes

N_SMALL, N_BIG = narrow.SLOPE['exp13']

GROUPS = ('legal', 'time')


def run(device='cuda', groups=GROUPS, n_small=N_SMALL, n_big=N_BIG,
        log=print):
  bodies = ((narrow.EXP13_LEGAL if 'legal' in groups else ()) +
            (narrow.EXP13_CHAIN if 'time' in groups else ()))
  return narrow.run_bodies(bodies, device, n_small, n_big, log)


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv, chain=True, n_small=N_SMALL,
                           n_big=N_BIG, groups=GROUPS)
  return probes.entry(lambda: run(args.device, args.groups, args.n_small,
                                  args.n_big))


if __name__ == '__main__':
  sys.exit(main())
