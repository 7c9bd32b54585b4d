"""Experiment 2 on the H100: op rates, shift costs and the copy ceiling.

The port of experiments/exp2_diag.py (its Pallas probes, vpu_chain.make
at :87 and probe_i16_ops at :148). ``probe_i16_ops``: int16 min, add and
mul on (32, 256) blocks (exp1's kernel). ``vpu_chain``: the script's
eight chains, n steps in one launch: a dependent float32 multiply-add
and int32/int16 doublings in registers, and a shift-add along the
sublanes (concatenated or rolled), the lanes, and the major and lane
axes of a (128, 32, 128) block, each wrapping inside a CTA's strip of
whole lines. ``dma_ceiling``: the script's copy stencil (copycat,
float32 and uint16 at (8192, 2048), ``block_rows=512``) through the
port's fused executor, as a share of ``profiling.bound_ms``. See
narrow.narrow_probe.

    python -m soda_tpu_torch.experiments.exp2_diag [--device cpu]
        [--n-small 32] [--n-big 16384]

(The script's n_big of 512 does not resolve the register chains'
slope on the card; see narrow.SLOPE.)

On the card each body prints its time, ps per element-op, the bound and
its share, the plain version's time and the largest error against it
(a chain at 1, 2, 5 and n-small iterations) and its SASS; each copy its
cold-L2 ms, GB/s and share of the bound. ``--device cpu`` runs the
plain versions, and the copy at (1024, 256).
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

import soda_tpu_torch
from soda_tpu_torch import profiling
from soda_tpu_torch.backend import reference
from soda_tpu_torch.experiments import narrow, probes

N_SMALL, N_BIG = narrow.SLOPE['exp2']

# exp2_diag.py:428-433
COPY = ('kernel: copycat\nburst width: 64\nunroll factor: 1\n'
        'iterate: 1\nborder: ignore\ncluster: none\n'
        'input dram 0 %s: a(%d, *)\n'
        'output dram 1 %s: b(0, 0) = a(0, 0)\n')
COPY_TYPES = {'float32': 'float', 'uint16': 'uint16'}
COPY_SHAPE, CPU_COPY_SHAPE = (8192, 2048), (1024, 256)
BLOCK_ROWS = 512


def copy_stencil(dtype: str, shape):
  return soda_tpu_torch.build_stencil(COPY % (COPY_TYPES[dtype], shape[-1],
                                              COPY_TYPES[dtype]))


def dma_ceiling(device, dtype: str, log=print):
  """The copy stencil once through ``get_executor(..., 'fused',
  block_rows=512)``, held equal to its input; on the card its cold-L2
  median against ``profiling.bound_ms``. Returns the row."""
  shape = COPY_SHAPE if device.type == 'cuda' else CPU_COPY_SHAPE
  stencil = copy_stencil(dtype, shape)
  ex = soda_tpu_torch.get_executor(stencil, shape, 'fused', device=device,
                                   block_rows=BLOCK_ROWS)
  args = ex.prepare(reference.make_test_inputs(stencil, shape))
  ex.launches = 0
  out, = ex.fn(*args)
  row = {'body': 'exp2 copy %s %s' % (dtype, shape), 'launches': ex.launches,
         'ok': torch.equal(out, args[0])}
  if device.type == 'cpu':
    log('copy %s %s: plain %s' % (dtype, shape, 'OK' if row['ok'] else
                                  'WRONG'))
    return row
  ms = statistics.median(profiling.cuda_times_ms(lambda: ex.fn(*args)))
  bound, bound_by = profiling.bound_ms(stencil, shape)
  moved = 2 * float(np.prod(shape)) * np.dtype(dtype).itemsize
  row.update(ms=ms, bound_ms=bound, bound_by=bound_by)
  log('copy %s %s: %.4f ms  %.1f GB/s  (share %.3f of the bound %.4f ms, '
      '%s)  %s' % (dtype, shape, ms, moved / ms / 1e6, bound / ms, bound,
                   bound_by, 'OK' if row['ok'] else 'WRONG'))
  return row


def run(device='cuda', n_small=N_SMALL, n_big=N_BIG, log=print):
  device = probes._device(device)
  rows = narrow.run_bodies(narrow.EXP2_I16 + narrow.EXP2_CHAIN, device,
                           n_small, n_big, log)
  return rows + [dma_ceiling(device, dtype, log) for dtype in COPY_TYPES]


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv, chain=True, n_small=N_SMALL,
                           n_big=N_BIG)
  return probes.entry(lambda: run(args.device, args.n_small, args.n_big))


if __name__ == '__main__':
  sys.exit(main())
