"""Experiment 29 on the H100: packed int16 pairs against the rotate tax.

The port of experiments/exp29_pack_i16.py (its Pallas probe,
pallas_loop at :72): eight bodies applied n times to a block in one
launch: unshifted int32 and int16 chains, ten rolled min steps on int32
cells and on words of two packed int16 (the signed pair min), the
pack round trip (the low half + 1, the high half kept: ``__vadd2``),
the strided roll (column j rolled by 1 + j, plus 1) and the int16 min.
The script's own interpret path computes another function for three of
them (unsigned halves, and v + 1 for the round trip and the strided
roll); this port computes the TPU's. See narrow.narrow_probe.

    python -m soda_tpu_torch.experiments.exp29_pack_i16 [--device cpu]
        [--n-small 64] [--n-big 16384]

On the card each body prints µs per iteration (the slope from n-small
to n-big), ps per element and step, the bound and its share, the plain
version's time, the largest error against it at 1, 2, 5 and n-small
iterations and its SASS; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import sys

from soda_tpu_torch.experiments import narrow, probes

N_SMALL, N_BIG = narrow.SLOPE['exp29']


def run(device='cuda', n_small=N_SMALL, n_big=N_BIG, log=print):
  return narrow.run_bodies(narrow.EXP29, device, n_small, n_big, log)


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv, chain=True, n_small=N_SMALL,
                           n_big=N_BIG)
  return probes.entry(lambda: run(args.device, args.n_small, args.n_big))


if __name__ == '__main__':
  sys.exit(main())
