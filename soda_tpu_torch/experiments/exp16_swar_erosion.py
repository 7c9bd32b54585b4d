"""Experiment 16 on the H100: erosion's min chains on packed int16 pairs.

The port of experiments/exp16_swar_erosion.py (its Pallas probes,
wide_kernel.make at :76 and swar_kernel.make at :126): erosion's two
stages, five sublane then five lane wrap-around min steps (distances 1,
2, 4, 8, 3), n times: on a (512, 2048) int16 block computed in int32
(wide), and on the same cells packed two to a 32-bit word (swar: the
signed pair min and ``__byte_perm`` funnel shifts; and the script's
bitwise sequence). Each stage walks whole columns, then whole rows, a
CTA at a time: two grid barriers an iteration. See narrow.narrow_probe.

    python -m soda_tpu_torch.experiments.exp16_swar_erosion
        [--device cpu] [--n-small 64] [--n-big 2048]

First the script's check, swar equal to wide at one iteration on its
input; then each kernel's µs per iteration, ps per cell and two-stage
iteration, the bound and share, the plain version's time and the
largest error against it at 1, 2, 5 and n-small iterations, and the
swar/wide time ratio; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import sys

import torch

from soda_tpu_torch.experiments import narrow, probes

N_SMALL, N_BIG = narrow.SLOPE['exp16']


def run(device='cuda', n_small=N_SMALL, n_big=N_BIG, log=print):
  device = probes._device(device)
  wide, swar, swar_bitwise = narrow.EXP16
  outs = [narrow.narrow_probe(body, *narrow.body_inputs(body, device))
          for body in (wide, swar, swar_bitwise)]
  same = [torch.equal(outs[0], out.view(torch.int16)) for out in outs[1:]]
  log('correctness: SWAR == wide %s, bitwise SWAR == wide %s' % tuple(
      '(exact)' if s else 'MISMATCH' for s in same))
  rows = [{'body': 'exp16 swar == wide', 'ok': all(same)}]
  rows += narrow.run_bodies(narrow.EXP16, device, n_small, n_big, log)
  if device.type == 'cuda':
    cells = wide.cells
    for row in rows[1:]:
      log('%-22s %9.1f us/iter  %6.3f ps/cell/two-stage' % (
          row['body'], row['ms'] * 1e3, row['ms'] * 1e9 / cells))
    log('swar/wide time ratio: %.2f (intrinsic), %.2f (bitwise) (>1 refutes '
        'SWAR)'
        % (rows[2]['ms'] / rows[1]['ms'], rows[3]['ms'] / rows[1]['ms']))
  return rows


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv, chain=True, n_small=N_SMALL,
                           n_big=N_BIG)
  return probes.entry(lambda: run(args.device, args.n_small, args.n_big))


if __name__ == '__main__':
  sys.exit(main())
