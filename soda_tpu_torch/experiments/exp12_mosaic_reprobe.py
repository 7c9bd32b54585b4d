"""Experiment 12 on the H100: the crash catalog, and what each op becomes.

The port of experiments/exp12_mosaic_reprobe.py (its Pallas probes,
main.run1 at :68, chain_kernel at :147, roll_kernel at :161 and
widen_kernel at :174). On the TPU it asked which int16 and packed-pair
ops, shifted-add chains, rolls and widenings Mosaic lowers; nvcc lowers
them all, so here each case must PASS (exact where the script holds it
to a numpy value) and prints the SASS of its kernel: registers, spilled
bytes (none), and the instructions that carry it (IMNMX, the pair min VIMNMX,
PRMT, IADD3, LOP3, SHF, ...). The packed min and add run twice: the
intrinsic (``__vmins2``, ``__vadd2``) and the script's bitwise
sequence. See narrow.narrow_probe.

    python -m soda_tpu_torch.experiments.exp12_mosaic_reprobe
        [--device cpu] [native] [swar] [chain] [roll] [widen]

Every group's inputs are drawn as the script's default run draws them,
whichever groups run. ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import sys

from soda_tpu_torch.experiments import narrow, probes

GROUPS = ('native', 'swar', 'chain', 'roll', 'widen')
# each group's bodies, in the script's order
GROUP_BODIES = dict(zip(GROUPS, (narrow.EXP12[:5], narrow.EXP12[5:11],
                                 narrow.EXP12[11:15], narrow.EXP12[15:16],
                                 narrow.EXP12[16:])))


def run(device='cuda', groups=GROUPS, log=print):
  bodies = tuple(b for g in GROUPS if g in groups for b in GROUP_BODIES[g])
  return narrow.run_bodies(bodies, device, log=log)


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv, groups=GROUPS)
  return probes.entry(lambda: run(args.device, args.groups))


if __name__ == '__main__':
  sys.exit(main())
