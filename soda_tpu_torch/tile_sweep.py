"""Time the fused kernel of benchmark cells at every tile that fits.

    python -m soda_tpu_torch.tile_sweep [CELL ...]

The measurement behind ``tile_plan.MAX_TILE_CELLS``. For each named
cell of ``testing.CELLS`` (default: blur, jacobi2d, erosion), builds
the kernel at every candidate tile of ``tile_plan.candidate_tiles``,
with the cap lifted, whose buffers fit shared memory, from 1,024 output
cells up. Each kernel is checked against the plain version
(``testing.check_outputs``) and timed from a cold L2 cache (median of
20 CUDA-event times). Needs a CUDA device; prints one line per tile.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from soda_tpu_torch import profiling, testing
from soda_tpu_torch.backend.fused import FusedExecutor, fused_stencil_plain
from soda_tpu_torch.backend.tile_plan import (SMEM_LIMIT, candidate_tiles,
                                               make_tile_plan)

MIN_CELLS = 1024
NO_CAP = 1 << 30


def sweep(name: str, smi: str) -> None:
  shape, overrides = next((s, o) for n, s, o in testing.CELLS if n == name)
  stencil = testing.build_cell(name, overrides)
  inputs = testing.make_test_inputs(stencil, shape)
  params = testing.make_test_params(stencil)
  default = make_tile_plan(stencil, shape).tile
  plain = None
  for tile in candidate_tiles(shape, NO_CAP):
    cells = 1
    for t in tile:
      cells *= t
    if cells < MIN_CELLS:
      continue
    if make_tile_plan(stencil, shape, tile).smem_bytes > SMEM_LIMIT:
      break
    ex = FusedExecutor(stencil, shape, tile=tile)
    args = ex.prepare(inputs, params)
    if plain is None:
      n_in = len(stencil.input_names)
      plain = dict(zip(stencil.output_names,
                       fused_stencil_plain(stencil, args[:n_in], args[n_in:])))
    got = dict(zip(stencil.output_names, ex.fn(*args)))
    testing.check_outputs(stencil, shape, got, plain, name)
    times = profiling.cuda_times_ms(lambda: ex.fn(*args))
    q1, _, q3 = statistics.quantiles(times, n=4)
    print('[sweep] %-10s tile %-14s smem %6d B  %6d CTAs  %.4f ms '
          '(quartiles %.4f-%.4f, n=%d)%s | %s' % (
              name, tile, ex.plan.smem_bytes, ex.plan.n_tiles,
              statistics.median(times), q1, q3, len(times),
              '  <- default' if tile == default else '', smi), flush=True)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('cells', nargs='*',
                      default=['blur', 'jacobi2d', 'erosion'])
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('tile_sweep: no CUDA device', file=sys.stderr)
    return 1
  smi = profiling.nvidia_smi_line()
  for name in args.cells:
    sweep(name, smi)
  return 0


if __name__ == '__main__':
  sys.exit(main())
