"""Cells, cases and checks shared by chip_smoke.py and the port's tests.

- ``CELLS``: the 12 cells of the stencil benchmark (bench.py:51-163),
  the 11 corpus kernels plus jacobi3d at 256^3, with the benchmark's
  shapes and stencil overrides (its TPU seed configs do not apply).
- ``SHARDED``: the sharded path's cells, each a benchmark cell on a
  mesh that repeats one device (``repeated_mesh``).
- The front half's test data and oracle, re-exported from the port's
  own copies: seeded inputs and params, each output's valid region, the
  per-kernel float threshold and the NumPy oracle's ``run``.
- ``check_outputs``: the comparison rule of the reference's self-test,
  as tests/checks.py states it. Integers bit-exact; a float fails only
  where its error exceeds the threshold both absolutely and relative to
  the reference value; NaNs in the same cells.
- ``MODE_CELLS``: the fused kernel's modes at the benchmark shapes.
- ``SEED_CONFIGS``: the JAX package's 24 bench seed configurations at
  the benchmark shapes (``seed_small``: the CPU tests' shapes), and
  ``LAYOUT_EXTRA``, the layout forms its bench seeds do not reach;
  ``LAYOUT_SHORT_EXTRA``, layout cases of the short form's element;
  ``check_exact``, bit-for-bit equality on the valid regions.
- Test cases: tile geometries, the kernel modes and layout forms at
  small shapes (``MODE_CASES``, ``LAYOUT_CASES``), an output read by a stage, a program with params, a
  seeded generator of random DSL programs over every integer width and
  sign, half, float and double, and distinct inputs per replica of a
  replicated batch.
- Conversions: ``gen_cast_program`` (``CAST_SEEDS``) and
  ``make_cast_inputs``, programs and inputs where a conversion rounded
  twice would show; ``cast_values``, such values alone; faults C5's and
  C6's programs (``regression_cases``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from soda_tpu_torch.api import build_stencil
from soda_tpu_torch.backend import c_semantics as oracle
from soda_tpu_torch.backend.reference import (make_test_inputs,
                                              make_test_params,
                                              output_valid_slices)
from soda_tpu_torch.backend.reference import run as oracle_run
from soda_tpu_torch.corpus import CORPUS
from soda_tpu_torch.ir.types import Type
from soda_tpu_torch.parallel.mesh import Mesh
from soda_tpu_torch.utils import threshold_for

__all__ = ['CAST_SEEDS', 'C5_SEEDS', 'C6_CASES', 'cast_values', 'c6_program',
           'gen_cast_program', 'half_midpoints', 'make_cast_inputs',
           'regression_cases',
           'CELLS', 'CONV_PARAM', 'SHARDED', 'repeated_mesh', 'FUZZ_SEEDS', 'FUZZ_SHAPE',
           'GEOMETRY_CASES', 'LAYOUT_CASES', 'LAYOUT_SHORT_EXTRA', 'StepClock', 'build_cell_stepped', 'LAYOUT_EXTRA', 'MODE_CASES',
           'MODE_CELLS', 'MULTI_OUTPUT', 'NARROW_PAIRS', 'SEED_CONFIGS',
           'build_cell', 'check_exact', 'check_outputs', 'gen_program',
           'make_inputs', 'make_test_inputs', 'make_test_params',
           'mode_inputs', 'mode_stencil', 'oracle_run', 'output_valid_slices',
           'replica_inputs', 'seed_small', 'threshold_for']

# (name, shape, stencil overrides): the benchmark's 12 cells
CELLS = (
    ('blur', (8192, 2048), {'tile_size': (2048, 0)}),
    ('jacobi2d', (8192, 2048), {'tile_size': (2048, 0)}),
    ('jacobi3d', (2048, 32, 128), {'tile_size': (128, 32, 0)}),
    ('heat3d', (2048, 32, 128), {'tile_size': (128, 32, 0),
                                 'optimizations': {'distribute': True}}),
    ('seidel2d', (8192, 2048), {'tile_size': (2048, 0),
                                'optimizations': {'computation-reuse':
                                                  'greedy'}}),
    ('erosion', (8192, 2048), {'tile_size': (2048, 0),
                               'optimizations': {'computation-reuse':
                                                 'greedy'}}),
    ('sobel2d', (8192, 2048), {'tile_size': (2048, 0)}),
    ('xcorr', (8192, 2048), {'tile_size': (2048, 0),
                             'optimizations': {'computation-reuse': 'greedy',
                                               'cr-cost': 'tpu'}}),
    ('contrast', (32768, 512), {'tile_size': (512, 0),
                                'optimizations': {'computation-reuse': 'yes',
                                                  'cr-cost': 'tpu'}}),
    ('denoise2d', (8192, 2048), {'tile_size': (2048, 0)}),
    ('denoise3d', (2048, 32, 128), {'tile_size': (128, 32, 0)}),
    ('jacobi3d_256', (256, 256, 256), {'tile_size': (256, 256, 0)}),
)


# The JAX package's tuned configurations: the two seed executor configs
# of each benchmark cell (bench.py:51-163, primary first), copied as
# data. 17 of the 24 carry a layout key.
_SEEDS = {
    'blur': ({'block_rows': 640, 'stage_mode': 'value', 'shift_mode': 'roll'},
             {'block_rows': 512}),
    'jacobi2d': ({'stream_loop': 'peel'},
                 {'block_rows': 256, 'stage_mode': 'value',
                  'shift_mode': 'roll'}),
    'jacobi3d': ({'block_rows': 128}, {'block_rows': 64}),
    'heat3d': ({'block_rows': 128, 'stage_mode': 'value',
                'shift_mode': 'roll'}, {'block_rows': 128}),
    'seidel2d': ({'block_rows': 128, 'stage_mode': 'value',
                  'shift_mode': 'roll', 'stream_loop': 'peel'},
                 {'block_rows': 256, 'stage_mode': 'value',
                  'shift_mode': 'roll'}),
    'erosion': ({'stage_mode': 'value', 'shift_mode': 'roll',
                 'transpose_lanes': 'on', 'block_rows': 512,
                 'lane_shift': 'rotate', 'prefetch': 2},
                {'stage_mode': 'value', 'shift_mode': 'roll',
                 'transpose_lanes': 'on', 'block_rows': 256}),
    'sobel2d': ({'lane_shift': 'slice', 'block_rows': 256, 'prefetch': 2},
                {'lane_shift': 'slice', 'block_rows': 256}),
    'xcorr': ({'block_rows': 352, 'stage_mode': 'value', 'shift_mode': 'roll',
               'transpose_lanes': 'on', 'lane_shift': 'rotate'},
              {'block_rows': 256, 'stage_mode': 'value', 'shift_mode': 'roll',
               'transpose_lanes': 'on', 'lane_shift': 'rotate'}),
    'contrast': ({}, {'block_rows': 64}),
    'denoise2d': ({'block_rows': 64, 'stage_mode': 'value',
                   'shift_mode': 'roll', 'stream_loop': 'peel'},
                  {'block_rows': 128, 'stage_mode': 'value',
                   'shift_mode': 'roll'}),
    'denoise3d': ({'block_rows': 16, 'stage_mode': 'value',
                   'shift_mode': 'roll', 'stream_loop': 'peel'},
                  {'block_rows': 64, 'stage_mode': 'value',
                   'shift_mode': 'roll'}),
    'jacobi3d_256': ({'mid_tile': 64, 'block_rows': 16, 'stream_loop': 'peel',
                      'stage_mode': 'value', 'shift_mode': 'roll'},
                     {'mid_tile': 64, 'stream_loop': 'peel',
                      'stage_mode': 'value', 'shift_mode': 'roll',
                      'prefetch': 2}),
}
# (cell, shape, stencil overrides, kernel options): the 24 seeds at the
# benchmark shapes, with the cells' overrides (tile_size, computation
# reuse, cr-cost, distribute)
SEED_CONFIGS = tuple((name, shape, overrides, opts)
                     for name, shape, overrides in CELLS
                     for opts in _SEEDS[name])
def seed_small(name: str, shape, overrides):
  """A seed's small shape for the CPU tests and its overrides with a
  tile_size that matches it (jacobi3d_256's mid tile of 64 splits its
  small axis 1 in two)."""
  small = ((24, 72, 24) if name == 'jacobi3d_256' else
           {2: (64, 160), 3: (24, 12, 40)}[len(shape)])
  tile_size = tuple(reversed(small[1:])) + (0,)
  return small, dict(overrides, tile_size=tile_size)


# the layout forms' seeds beside the JAX package's gate row that is its
# only configured use of ``narrow`` (tools/tpu_validate.py:216-218), at
# the benchmark shape; and chunked stage loops, which only the JAX
# tuner offers (tools/autotune.py:81-96), on the 256^3 cell
LAYOUT_EXTRA = (
    ('xcorr', (8192, 2048), {'tile_size': (2048, 0),
                             'optimizations': {'computation-reuse':
                                               'greedy'}},
     {'stage_mode': 'value', 'shift_mode': 'roll', 'narrow': 'on'}),
    ('jacobi3d_256', (256, 256, 256), {'tile_size': (256, 256, 0)},
     {'mid_tile': 64, 'compute_chunk': 8}),
)


# (cell, mesh shape, inner, overlap): the sharded executor's cells. A
# 1-D exchange (bit-exact against the oracle), a 2-D decomposition with
# corner halos, a 9-row halo, a 3-D grid on two sharded axes, two
# inputs through one kernel per stage group (denoise2d under ``cluster:
# coarse``), and the whole-grid inner under overlap 'off' and 'on'
# (the JAX package's mode, here the same exchange).
SHARDED = (
    ('blur', (4,), 'fused', 'off'),
    ('blur', (2, 2), 'fused', 'off'),
    ('erosion', (4,), 'fused', 'off'),
    ('heat3d', (2, 2), 'fused', 'off'),
    ('denoise2d', (4,), 'grouped', 'off'),
    ('jacobi2d', (4,), 'xla', 'off'),
    ('jacobi2d', (4,), 'xla', 'on'),
)


# (cell, kernel options): the fused kernel's modes at the benchmark
# shapes. The streaming loop (plain and peeled) on 2-D and 3-D cells,
# the deep cp.async ring on the 3-D ones, split fills on 3-D grids, and
# staged stores on a 2-byte and a 19-tap cell.
MODE_CELLS = tuple(
    [(name, {'stream_loop': mode})
     for name in ('blur', 'erosion', 'jacobi3d', 'heat3d', 'denoise2d',
                  'jacobi3d_256') for mode in (True, 'peel')] +
    [(name, {'stream_loop': 'peel', 'prefetch': 3})
     for name in ('jacobi3d', 'jacobi3d_256')] +
    [(name, {'dma_split': 2}) for name in ('heat3d', 'jacobi3d')] +
    [(name, {'out_dma': True}) for name in ('blur', 'erosion')])


# (name, shape, kernel options, MIN_CTAS, replicas): every path of the
# mode kernels at small shapes. Rolling and not (the halo reaching the
# tile), 'peel' with and without steady steps, the prefetch ring, split
# fills, staged stores (16-byte and element), 2-byte pairs at phase 0
# and 1, odd rows (element fills), 1-, 4- and 8-byte inputs, several
# inputs, an output read by a stage, params, replicas, and runs cut by
# the grid's end (a small MIN_CTAS gives the small grids runs of
# several steps; ``mode_stencil`` builds the name).
MODE_CASES = (
    ('blur', (130, 64), {'stream_loop': True, 'block_rows': 16}, 1, 1),
    ('blur', (130, 64), {'stream_loop': 'peel', 'block_rows': 8}, 3, 1),
    ('blur', (130, 64), {'stream_loop': 'peel', 'block_rows': 8,
                         'prefetch': 4, 'out_dma': True}, 2, 1),
    ('blur', (64, 96), {'out_dma': True, 'block_rows': 16}, 1, 2),
    ('blur', (40, 64), {'stream_loop': 'peel', 'block_rows': 16}, 1, 1),
    ('erosion', (61, 45), {'stream_loop': 'peel', 'block_rows': 16}, 1, 1),
    ('erosion', (80, 64), {'stream_loop': True, 'block_rows': 32,
                           'out_dma': True}, 1, 1),
    ('sobel2d', (50, 64), {'stream_loop': True, 'block_rows': 8}, 2, 1),
    ('xcorr', (41, 70), {'stream_loop': 'peel', 'block_rows': 4,
                         'prefetch': 3}, 1, 1),
    ('jacobi2d', (48, 40), {'stream_loop': 'peel', 'block_rows': 4}, 1, 1),
    ('jacobi3d', (40, 17, 24), {'stream_loop': 'peel', 'block_rows': 4,
                                'prefetch': 3, 'dma_split': 3}, 1, 1),
    ('jacobi3d', (24, 16, 16), {'stream_loop': True, 'block_rows': 8,
                                'mid_tile': 8}, 1, 1),
    ('heat3d', (30, 12, 20), {'stream_loop': True, 'block_rows': 3,
                              'dma_split': 2}, 2, 1),
    ('heat3d', (16, 12, 32), {'dma_split': 2, 'out_dma': True}, 1, 1),
    ('denoise2d', (40, 48), {'stream_loop': 'peel', 'block_rows': 8,
                             'out_dma': True}, 1, 1),
    ('denoise3d', (20, 9, 16), {'stream_loop': 'peel', 'block_rows': 2,
                                'prefetch': 4}, 1, 2),
    ('seidel2d', (36, 40), {'stream_loop': True, 'block_rows': 8}, 1, 1),
    ('multi_output', (29, 35), {'stream_loop': True, 'block_rows': 4,
                                'out_dma': True}, 1, 1),
    ('conv_param', (24, 64), {'stream_loop': 'peel', 'block_rows': 4}, 1, 1),
    ('fuzz200', (8, 16), {'stream_loop': True, 'block_rows': 2}, 1, 1),
    ('fuzz203', (8, 16), {'stream_loop': 'peel', 'block_rows': 1,
                          'out_dma': True}, 1, 1),
    ('fuzz213', (8, 16), {'stream_loop': True, 'block_rows': 2,
                          'prefetch': 3}, 1, 1),
)


# (name, shape, kernel options, MIN_CTAS, replicas): the fused kernel's
# layout forms at small shapes, each form on the paths that differ. L1
# under roll and window, its minor taps rotated and sliced (a row wider
# than 256 takes 'slice' under 'auto'), on 2-D and 3-D grids, ragged
# tiles, with the streaming loop (rolling and peeled), the cp.async
# ring and staged stores, replicas, params, an output read by a stage,
# and random programs over every type; L2 (transposed regions) under
# roll and slice; L3 (packed 16-bit pairs) with odd minor offsets
# between packed stages, rotated and sliced; L4 (chunked stage loops)
# alone and streaming. ``+cr``: greedy computation reuse.
LAYOUT_CASES = (
    ('blur', (37, 70), {'stage_mode': 'value', 'shift_mode': 'roll',
                        'block_rows': 16}, 1, 1),
    ('blur', (40, 300), {'stage_mode': 'value', 'block_rows': 8}, 1, 1),
    ('sobel2d', (50, 64), {'lane_shift': 'rotate', 'block_rows': 8}, 1, 1),
    ('sobel2d', (23, 280), {'lane_shift': 'slice', 'block_rows': 4}, 1, 1),
    ('erosion+cr', (61, 45), {'stage_mode': 'value', 'shift_mode': 'roll',
                              'transpose_lanes': 'on', 'block_rows': 16},
     1, 1),
    ('xcorr+cr', (41, 70), {'lane_shift': 'slice', 'transpose_lanes': 'on',
                            'block_rows': 8}, 1, 1),
    ('xcorr+cr', (48, 70), {'stage_mode': 'value', 'shift_mode': 'roll',
                            'narrow': 'on'}, 1, 1),
    ('narrow_pairs', (40, 64), {'stage_mode': 'value', 'narrow': 'on',
                                'lane_shift': 'rotate'}, 1, 1),
    ('narrow_pairs', (40, 300), {'stage_mode': 'value', 'narrow': 'on',
                                 'block_rows': 8}, 1, 1),
    ('heat3d', (20, 12, 40), {'stage_mode': 'value', 'shift_mode': 'roll',
                              'block_rows': 4}, 1, 1),
    ('denoise3d', (20, 9, 16), {'stage_mode': 'value', 'block_rows': 2,
                                'stream_loop': 'peel'}, 1, 1),
    ('jacobi3d', (24, 16, 16), {'compute_chunk': 3, 'block_rows': 8}, 1, 1),
    ('jacobi3d', (40, 17, 24), {'compute_chunk': 2, 'stream_loop': 'peel',
                                'block_rows': 4, 'prefetch': 3}, 1, 1),
    ('denoise2d', (40, 48), {'stage_mode': 'value', 'shift_mode': 'roll',
                             'block_rows': 8, 'stream_loop': 'peel',
                             'out_dma': True}, 1, 1),
    ('seidel2d', (36, 40), {'stage_mode': 'value', 'shift_mode': 'roll',
                            'stream_loop': True, 'block_rows': 8}, 2, 1),
    ('blur', (64, 96), {'stage_mode': 'value', 'shift_mode': 'roll',
                        'block_rows': 16, 'out_dma': True}, 1, 2),
    ('multi_output', (29, 35), {'stage_mode': 'value', 'block_rows': 4},
     1, 1),
    ('conv_param', (24, 64), {'stage_mode': 'value', 'shift_mode': 'roll',
                              'block_rows': 4}, 1, 1),
    ('fuzz204', (8, 16), {'stage_mode': 'value', 'shift_mode': 'roll'},
     1, 1),
    ('fuzz207', (8, 16), {'stage_mode': 'value', 'block_rows': 2}, 1, 1),
    ('fuzz211', (8, 16), {'stage_mode': 'value', 'shift_mode': 'roll',
                          'block_rows': 4}, 1, 1),
)

# layout cases the short form's layout element takes beside LAYOUT_CASES:
# a transposed lane region (L2 under 'slice') on the walk, a 3-D value
# form whose stage is read at axis-1 offsets (a shared-memory stage
# beside the region), an odd minor extent under narrow (a lane holds
# one column: no pairs), and far taps (an exit stored into its buffer)
LAYOUT_SHORT_EXTRA = (
    ('xcorr+cr', (41, 70), {'lane_shift': 'slice', 'transpose_lanes': 'on',
                            'block_rows': 4, 'stream_loop': True}, 1, 1),
    ('denoise3d', (12, 10, 24), {'stage_mode': 'value', 'shift_mode': 'roll',
                                 'block_rows': 4}, 1, 1),
    ('narrow_pairs', (24, 37), {'stage_mode': 'value', 'narrow': 'on',
                                'lane_shift': 'rotate'}, 1, 1),
    ('far_taps', (20, 200), {'stage_mode': 'value', 'lane_shift': 'rotate',
                             'block_rows': 8}, 1, 1),
)

# a stage read at far minor-axis offsets: its reader's shifted views pass
# the region's register budget, so the reader is a shared-memory stage
# and the region stores the stage into its buffer (an exit)
FAR_TAPS = '''
kernel: far
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input float: a(64, *)
local float: t(0, 0) = a(0, 0) * 2.0f + a(0, 1)
output float: o(0, 0) = t(0, 0) + t(40, 0) + t(-40, 0)
'''

# packed 16-bit stages reading a packed stage at odd minor offsets (the
# JAX package's tests/test_narrow.py roll case)
NARROW_PAIRS = '''
kernel: nrw
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input int16: a(64, *)
local int16: t(0, 0) = a(0, 0) + a(0, 3) + a(3, 0)
output int16: y(0, 0) = int16(t(0, 0) + t(1, 1) + t(2, 2))
'''


def mode_stencil(name: str):
  """The stencil a ``MODE_CASES`` or ``LAYOUT_CASES`` name stands for: a
  corpus kernel (``+cr``: with greedy computation reuse),
  ``multi_output``, ``conv_param``, ``narrow_pairs``, ``far_taps`` or
  ``fuzz<seed>``."""
  texts = {'multi_output': MULTI_OUTPUT, 'conv_param': CONV_PARAM,
           'narrow_pairs': NARROW_PAIRS, 'far_taps': FAR_TAPS}
  if name in texts:
    return build_stencil(texts[name])
  if name.startswith('fuzz'):
    return build_stencil(gen_program(int(name[4:])))
  if name.endswith('+cr'):
    return build_stencil(CORPUS[name[:-3]],
                         optimizations={'computation-reuse': 'greedy'})
  return build_stencil(CORPUS[name])


def mode_inputs(stencil, name: str, shape, replicas: int):
  """One input dict per replica of a ``MODE_CASES`` case."""
  if name.startswith('fuzz'):
    return [make_inputs(stencil, shape, int(name[4:]))]
  return replica_inputs(stencil, shape, replicas)


def repeated_mesh(device, shape):
  """A mesh of ``shape`` whose every entry is ``device``, on axes 'x'
  (and 'y'): how one card (or the CPU) holds a multi-shard mesh."""
  n = int(np.prod(shape))
  devices = np.empty(n, dtype=object)
  devices[:] = [torch.device(device)] * n
  return Mesh(devices.reshape(tuple(shape)), ('x', 'y')[:len(shape)])


def build_cell(name: str, overrides: Mapping):
  """The Stencil of a cell: its corpus kernel (``name`` up to the first
  ``_``) with the cell's overrides."""
  return build_stencil(CORPUS[name.split('_')[0]], **overrides)


class StepClock:
  """A stand-in for the ``time`` module whose clock advances a fixed
  step per reading: the computation-reuse schedulers' time budgets then
  end after the same number of steps on every machine."""

  def __init__(self, step=0.5):
    self.now, self.step = 0.0, step

  def monotonic(self):
    self.now += self.step
    return self.now


def build_cell_stepped(name: str, overrides: Mapping):
  """``build_cell`` as every machine builds it: the in-process
  computation-reuse scheduler (no external binary) under StepClock.
  The external binary and a real clock's budgets give contrast other
  stage graphs (31-34 barriers a tile seen on an H100's host)."""
  from soda_tpu_torch.optimization import cr_schedules
  saved = cr_schedules.find_external_cr, cr_schedules.time
  cr_schedules.find_external_cr = lambda: None
  cr_schedules.time = StepClock()
  try:
    return build_cell(name, overrides)
  finally:
    cr_schedules.find_external_cr, cr_schedules.time = saved


def _numpy(value) -> np.ndarray:
  if hasattr(value, 'cpu'):  # a torch tensor, on any device
    return value.cpu().numpy()
  return np.asarray(value)


def check_outputs(stencil, shape, got, want, context: str,
                  full: bool = False) -> float:
  """Compare ``got`` with ``want`` (output name -> array or tensor) on
  each output's valid region (``full``: the whole grid) by the
  reference's rule, with ``threshold_for(context)``. Raises
  AssertionError on a mismatch; returns the largest absolute float
  error (0 when every output is an integer)."""
  worst = 0.0
  for out in stencil.output_names:
    region = (tuple(slice(None) for _ in shape) if full else
              output_valid_slices(stencil, shape, out))
    g, w = _numpy(got[out])[region], _numpy(want[out])[region]
    where = '%s:%s' % (context, out)
    assert g.shape == w.shape, (where, g.shape, w.shape)
    if not stencil.symbol_table[out].is_float:
      np.testing.assert_array_equal(g, w, err_msg=where)
      continue
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), where)
    g = g[~np.isnan(w)].astype(np.float64)
    w = w[~np.isnan(w)].astype(np.float64)
    t2 = threshold_for(context) ** 2
    with np.errstate(invalid='ignore'):  # inf - inf where both are inf
      err = np.where(g == w, 0.0, np.abs(g - w))
    d2 = err ** 2
    bad = (d2 > t2) & (d2 > t2 * w * w)
    if bad.any():
      first = int(np.argmax(bad))
      raise AssertionError(
          '%s: %d/%d elements fail the reference threshold %g; first: got '
          '%r want %r' % (where, int(bad.sum()), bad.size,
                          threshold_for(context), g[first], w[first]))
    if err.size:
      worst = max(worst, float(err.max()))
  return worst


def check_exact(stencil, shape, got, want, context: str,
                values: bool = False) -> None:
  """Bit-for-bit equality of ``got`` and ``want`` on each output's valid
  region (floats compared as their bits, so equal NaNs match). Raises
  AssertionError naming the first differing index. ``values``: floats
  compared as numbers instead, NaN matching NaN and +0 matching -0 (C
  leaves open which zero min and max pick); unlike ``check_outputs``'
  threshold, this sees a float or double one rounding off."""
  for out in stencil.output_names:
    region = output_valid_slices(stencil, shape, out)
    g, w = _numpy(got[out])[region], _numpy(want[out])[region]
    where = '%s:%s' % (context, out)
    assert g.dtype == w.dtype and g.shape == w.shape, (where, g.dtype,
                                                       w.dtype)
    if values and g.dtype.kind == 'f':
      diff = (g != w) & ~(np.isnan(g) & np.isnan(w))
    else:
      bits = 'u%d' % g.dtype.itemsize
      diff = g.view(bits) != w.view(bits)
    if diff.any():
      first = tuple(int(i) for i in np.argwhere(diff)[0])
      raise AssertionError('%s: %d/%d cells differ; first at %s (of the '
                           'valid region): got %r want %r' % (
                               where, int(diff.sum()), diff.size, first,
                               g[first], w[first]))


# (name, shape, tile): tile plans that exercise the kernel's geometry
GEOMETRY_CASES = (
    ('blur', (37, 53), (8, 16)),        # ragged on both axes
    ('blur', (40, 64), (64, 128)),      # one tile larger than the grid
    ('erosion', (45, 61), (16, 32)),    # store offsets tmp(0, 9), output(9, 0)
    ('jacobi3d', (13, 17, 19), (4, 8, 8)),
    ('denoise3d', (11, 13, 21), (2, 4, 8)),
    ('sobel2d', (23, 31), (1, 1)),      # one-cell tiles
    ('xcorr', (41, 70), (3, 5)),        # odd tile extents
)

MULTI_OUTPUT = '''
kernel: mo
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 int16: src(32, *)
local int32: t(0, 0) = src(0, 1) * 3 + src(1, 0) - src(-1, -1)
output dram 1 int16: o0(0, 0) = t(0, 0) + t(1, 1)
output dram 2 uint16: o1(1, 0) = t(0, -1) / 7 + o0(0, 0)
'''

CONV_PARAM = '''
kernel: wconv
burst width: 64
unroll factor: 2
iterate: 1
border: ignore
cluster: none
param float, dup 2, partition complete: w[3][3]
input dram 0 float: img(64, *)
output dram 1 float: out(0, 0) =
  img(-1, -1) * w(0, 0) + img(0, -1) * w(1, 0) + img(1, -1) * w(2, 0) +
  img(-1, 0) * w(0, 1) + img(0, 0) * w(1, 1) + img(1, 0) * w(2, 1) +
  img(-1, 1) * w(0, 2) + img(0, 1) * w(1, 2) + img(1, 1) * w(2, 2)
'''

# the random programs that run through the kernel (host loop and card)
FUZZ_SEEDS = range(200, 230)
FUZZ_SHAPE = (8, 16)

INT_TYPES = ('int8', 'uint8', 'int16', 'uint16', 'int32', 'uint32', 'int64',
             'uint64', 'int12', 'uint6', 'int40')
FLOAT_TYPES = ('float', 'double', 'half')


def gen_program(seed: int, narrow: bool = False) -> str:
  """A one-output DSL program over int inputs ``a``, ``b`` and a float
  input ``x``. ``narrow``: types of at most 32 bits and no integer
  division (the jax.numpy Evaluator's domain on the CPU)."""
  rng = np.random.default_rng(seed)
  ints = [t for t in INT_TYPES if not narrow or Type(t).width_in_bits <= 32]
  floats = ('float', 'half') if narrow else FLOAT_TYPES

  def pick(seq):
    return seq[int(rng.integers(0, len(seq)))]

  t_a, t_b, t_x = pick(ints), pick(ints), pick(floats)

  def int_leaf():
    k = int(rng.integers(0, 5))
    if k == 0:
      return str(pick((0, 1, 2, 3, 7, 255, 1000, 65535)))
    if k == 1:
      return '-%d' % pick((1, 5, 128))
    return pick(('a(0, 0)', 'a(1, 0)', 'b(0, 0)', 'b(0, 1)'))

  def float_leaf():
    k = int(rng.integers(0, 4))
    if k == 0:  # 1.25 is a double literal, outside narrow programs
      return pick(('0.5f', '3.0f', '-2.5f', '0.1f') +
                  (() if narrow else ('1.25',)))
    if k == 1 and 'uint64' not in (t_a,):
      return 'float(a(0, 0))'
    return pick(('x(0, 0)', 'x(0, 1)'))

  def gen_int(depth):
    if depth == 0 or rng.random() < 0.2:
      return int_leaf()
    k = int(rng.integers(0, 9))
    if k <= 2:
      ops = ['+', '-', '*', '&', '|', '^']
      if not narrow:
        ops += ['/', '%', '/', '%']
      return '(%s %s %s)' % (gen_int(depth - 1), pick(ops), gen_int(depth - 1))
    if k == 3:
      op = pick(('==', '!=', '<', '<=', '>', '>='))
      if rng.random() < 0.5:
        return '(%s %s %s)' % (gen_int(depth - 1), op, gen_int(depth - 1))
      return '(%s %s %s)' % (gen_float(depth - 1), op, gen_float(depth - 1))
    if k == 4:
      return '(%s %s %s)' % (gen_int(depth - 1), pick(('&&', '||')),
                             gen_int(depth - 1))
    if k == 5:
      return '%s(%s)' % (pick(('-', '~', '!')), gen_int(depth - 1))
    if k == 6:
      return '%s(%s, %s)' % (pick(('min', 'max')), gen_int(depth - 1),
                             gen_int(depth - 1))
    if k == 7:
      if rng.random() < 0.5:
        return 'abs(%s)' % gen_int(depth - 1)
      return 'select(%s, %s, %s)' % (gen_int(depth - 1), gen_int(depth - 1),
                                     gen_int(depth - 1))
    return '%s(%s)' % (pick(ints), gen_int(depth - 1))

  def gen_float(depth):
    if depth == 0 or rng.random() < 0.2:
      return float_leaf()
    k = int(rng.integers(0, 7))
    if k <= 2:
      return '(%s %s %s)' % (gen_float(depth - 1), pick(('+', '-', '*', '/')),
                             gen_float(depth - 1))
    if k == 3:
      return '-(%s)' % gen_float(depth - 1)
    if k == 4:
      fn = pick(('sqrt', 'floor', 'ceil', 'round', 'abs'))
      return '%s(%s)' % (fn, gen_float(depth - 1))
    if k == 5:
      if rng.random() < 0.5:
        return '%s(%s, %s)' % (pick(('min', 'max')), gen_float(depth - 1),
                               gen_float(depth - 1))
      return 'select(%s, %s, %s)' % (gen_int(depth - 1), gen_float(depth - 1),
                                     gen_float(depth - 1))
    src = gen_float(depth - 1) if rng.random() < 0.5 else \
        ('float(%s)' % gen_int(depth - 1) if 'uint64' not in (t_a, t_b)
         else gen_float(depth - 1))
    return '%s(%s)' % (pick(floats), src)

  if rng.random() < 0.6:
    expr, t_out = gen_int(4), pick(ints)
  else:
    expr, t_out = gen_float(4), pick(floats)
  return '\n'.join([
      'kernel: sem', 'burst width: 64', 'unroll factor: 1', 'iterate: 1',
      'border: ignore', 'cluster: none',
      'input dram 0 %s: a(16, *)' % t_a,
      'input dram 1 %s: b' % t_b,
      'input dram 2 %s: x' % t_x,
      'output dram 3 %s: o(0, 0) = %s' % (t_out, expr),
  ])


def replica_inputs(stencil, shape, replicas: int):
  """One input dict per replica: ``make_test_inputs`` with seed k for
  replica k. Integer inputs are coordinate ramps, the same for every
  seed, so replica k's ramp is shifted by 3k: no two replicas share a
  grid."""
  grids = []
  for k in range(replicas):
    grid = make_test_inputs(stencil, shape, seed=k)
    for name, value in grid.items():
      t = stencil.symbol_table[name]
      if not t.is_float:
        grid[name] = oracle.wrap(np, value.astype(np.int64) + 3 * k, t)
    grids.append(grid)
  return grids


def make_inputs(stencil, shape, seed: int):
  """Seeded inputs spanning each type's range, with zeros, +-1, the
  extremes and small values (so divisions are not all by huge
  numbers)."""
  rng = np.random.default_rng(seed + 1000)
  out = {}
  for name in stencil.input_names:
    t = stencil.symbol_table[name]
    n = int(np.prod(shape))
    if t.is_float:
      v = rng.normal(0, 8, n)
      v[rng.random(n) < 0.15] = 0.0
      v[rng.random(n) < 0.05] = -1.0
    else:
      info = np.iinfo(t.np_dtype)
      wide = rng.integers(info.min, info.max, n, dtype=np.int64,
                          endpoint=True) if info.max < 2**63 else \
          rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
      small = rng.integers(-9, 10, n)
      v = np.where(rng.random(n) < 0.5, small, wide)
      specials = np.array([0, 1, -1, info.min, int(min(info.max, 2**63 - 1)),
                           2], dtype=object)
      pos = rng.random(n) < 0.15
      v = v.astype(object)
      v[pos] = specials[rng.integers(0, len(specials), int(pos.sum()))]
      v = np.array([int(i) % (1 << 64) for i in v], dtype=np.uint64)
      v = v.view(np.int64) if t.is_signed else v
    out[name] = oracle.wrap(np, v.reshape(shape), t)
  return out


# the random programs whose conversions round where a second rounding
# would show: uint64/int64/uint32 -> float, double, half and double ->
# float, half, then half arithmetic and selects on the results
CAST_SEEDS = range(400, 416)
CAST_INT_TYPES = ('uint64', 'int64', 'uint32', 'int32', 'uint64', 'int64')
CAST_FLOAT_TYPES = ('double', 'double', 'float', 'half')


def gen_cast_program(seed: int) -> str:
  """A DSL program over int inputs ``a``, ``b`` (one of them uint64) and
  a float input ``x`` (mostly double) with two outputs: ``o``, one
  conversion that torch would round twice (a double to half, or a
  uint64 to double or float), and ``p``, a random float, double or half
  expression that converts integers and doubles to each float type and
  computes on the halves."""
  rng = np.random.default_rng(seed)

  def pick(seq):
    return seq[int(rng.integers(0, len(seq)))]

  t_a, t_b = pick(CAST_INT_TYPES), pick(CAST_INT_TYPES)
  if 'uint64' not in (t_a, t_b):
    t_b = 'uint64'
  t_x = pick(CAST_FLOAT_TYPES)
  wide = 'a' if t_a == 'uint64' else 'b'
  probes = [('double', 'double(%s(0, 0))' % wide),
            ('float', 'float(%s(1, 0))' % wide)]
  if t_x == 'double':
    probes += [('half', 'half(x(0, 1))')] * 2
  t_probe, probe = pick(probes)

  def int_src():
    return pick(('a(0, 0)', 'a(1, 0)', 'b(0, 0)', 'b(0, 1)',
                 '(a(0, 0) + b(0, 0))', '(a(1, 0) * 3)',
                 '(b(0, 1) - a(0, 0))', '(a(0, 0) ^ b(0, 1))'))

  def half_src():  # integers that round to half rather than overflow
    return pick(('(a(0, 0) & 65535)', '(b(0, 1) & 65535)',
                 '(a(1, 0) & 4095)', 'b(0, 0)', int_src()))

  def cond(depth):
    k = int(rng.integers(0, 3))
    op = pick(('<', '<=', '>', '>=', '==', '!='))
    if k == 0:
      return '(a(0, 0) %s b(0, 0))' % op
    gen = gen_half if k == 1 else gen_double
    return '(%s %s %s)' % (gen(depth - 1), op, gen(depth - 1))

  def gen_double(depth):
    if depth <= 0 or rng.random() < 0.3:
      return pick(('double(%s)' % int_src(), 'x(0, 0)', 'x(0, 1)',
                   'double(%s)' % int_src(), '(x(0, 1) * 1.25)'))
    k = int(rng.integers(0, 4))
    if k <= 1:
      return '(%s %s %s)' % (gen_double(depth - 1), pick(('+', '-', '*', '/')),
                             gen_double(depth - 1))
    if k == 2:
      return 'double(%s)' % gen_half(depth - 1)
    return 'select(%s, %s, %s)' % (cond(depth - 1), gen_double(depth - 1),
                                   gen_double(depth - 1))

  def gen_float(depth):
    if depth <= 0 or rng.random() < 0.3:
      return 'float(%s)' % int_src()
    if rng.random() < 0.5:
      return 'float(%s)' % gen_double(depth - 1)
    return '(%s %s %s)' % (gen_float(depth - 1), pick(('+', '-', '*')),
                           gen_float(depth - 1))

  def gen_half(depth):
    if depth <= 0 or rng.random() < 0.25:
      return 'half(%s)' % pick((half_src(), 'x(0, 0)', 'x(0, 1)',
                                half_src()))
    k = int(rng.integers(0, 6))
    if k == 0:
      return 'half(%s)' % gen_double(depth - 1)
    if k == 1:
      return 'half(%s)' % gen_float(depth - 1)
    if k == 2:
      return 'half(%s %s %s)' % (gen_half(depth - 1), pick(('+', '-', '*')),
                                 gen_half(depth - 1))
    if k == 3:
      return 'select(%s, %s, %s)' % (cond(depth - 1), gen_half(depth - 1),
                                     gen_half(depth - 1))
    if k == 4:
      return '%s(%s, %s)' % (pick(('min', 'max')), gen_half(depth - 1),
                             gen_half(depth - 1))
    return '-(%s)' % gen_half(depth - 1)

  t_out = pick(('float', 'double', 'half'))
  expr = pick((gen_half, gen_double, gen_float, gen_half))(3)
  return '\n'.join([
      'kernel: cast', 'burst width: 64', 'unroll factor: 1', 'iterate: 1',
      'border: ignore', 'cluster: none',
      'input dram 0 %s: a(16, *)' % t_a,
      'input dram 1 %s: b' % t_b,
      'input dram 2 %s: x' % t_x,
      'output dram 3 %s: o(0, 0) = %s' % (t_probe, probe),
      'output dram 4 %s: p(0, 0) = %s' % (t_out, expr),
  ])


def _near_midpoints(rng, n: int, bits: int, lo: int, hi: int) -> np.ndarray:
  """``n`` integers in [2**lo, 2**hi) (as uint64), half of them in the
  top binade, each within one of a midpoint between two neighbouring
  floats of ``bits`` significant bits."""
  one = np.uint64(1)
  exp = np.where(rng.random(n) < 0.5, hi - 1,
                 rng.integers(lo, hi, n)).astype(np.uint64)
  step = exp - np.uint64(bits - 1)  # floats in [2**e, 2**(e + 1)) are 2**step apart
  top = rng.integers(0, 1 << 62, n, dtype=np.int64).astype(np.uint64)
  v = (one << exp) | ((top << step) & ((one << exp) - one))
  v = (v & ~((one << step) - one)) + (one << (step - one))
  delta = rng.integers(0, 3, n).astype(np.uint64)
  return v + delta - one


def half_midpoints() -> np.ndarray:
  """Every midpoint between neighbouring finite halves, both signs (as
  doubles: each exact)."""
  halves = np.arange(0, 0x7c00, dtype=np.uint16).view(np.float16)
  wide = halves.astype(np.float64)
  mids = (wide[:-1] + wide[1:]) / 2
  return np.concatenate([mids, -mids])


def cast_values(seed: int = 16):
  """(doubles, uint64s) where a conversion rounded twice shows: every
  midpoint between neighbouring finite halves of both signs, one
  double-ulp below, on and above it, infinities, NaNs, half's overflow
  and subnormal edges; and uint64 values within one of float and double
  midpoints in [2**53, 2**64) with a few listed edges."""
  rng = np.random.default_rng(seed)
  mids = half_midpoints()
  tiny = 2.0 ** -24  # the least half subnormal
  edges = [np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 65504.0, 65520.0,
           np.nextafter(65520.0, 0), np.nextafter(65520.0, np.inf),
           1e300, -1e300, 1e-300, -1e-300, 3.5e38, 1e-40, tiny / 2,
           np.nextafter(tiny / 2, 0), np.nextafter(tiny / 2, 1)]
  doubles = np.concatenate([mids, np.nextafter(mids, np.inf),
                            np.nextafter(mids, -np.inf), edges,
                            rng.normal(0, 8, 20000)])
  listed = np.array([2**63 + 1025, 2**63 + 2**39 + 1, 2**64 - 1, 2**63,
                     2**63 - 1, 2**53 + 1, 0, 1, 65520], np.uint64)
  wides = np.concatenate([listed, _near_midpoints(rng, 50000, 24, 53, 64),
                          _near_midpoints(rng, 50000, 53, 53, 64)])
  return doubles, wides


def make_cast_inputs(stencil, shape, seed: int):
  """``make_inputs``' grids with about half of each input's cells moved
  next to a rounding boundary: a double one double-ulp to either side of
  a midpoint between two halves or two float32s; a 64-bit integer within
  one of a midpoint between two floats or two doubles in [2**53, 2**64)
  (below 2**63, of either sign, if signed); a 32-bit one near a float32
  midpoint in [2**24, 2**31)."""
  rng = np.random.default_rng(seed + 2000)
  out = make_inputs(stencil, shape, seed)
  n = int(np.prod(shape))
  for name in stencil.input_names:
    t = stencil.symbol_table[name]
    moved = rng.random(n) < 0.5
    if t.is_float:
      halves = rng.integers(0, 0x7bff, n).astype(np.uint16).view(np.float16)
      mids = (halves.astype(np.float64) +
              np.nextafter(halves, np.float16(np.inf)).astype(np.float64)) / 2
      singles = (rng.normal(0, 64, n).astype(np.float32) *
                 np.float32(2.0) ** rng.integers(-20, 20, n).astype(np.float32))
      mids32 = (singles.astype(np.float64) + np.nextafter(
          singles, np.float32(np.inf)).astype(np.float64)) / 2
      v = np.where(rng.random(n) < 0.5, mids, mids32)
      side = rng.integers(0, 3, n)
      v = np.where(side == 0, np.nextafter(v, -np.inf),
                   np.where(side == 1, np.nextafter(v, np.inf), v))
      v = np.where(rng.random(n) < 0.5, -v, v)
      with np.errstate(over='ignore'):
        v = v.astype(t.np_dtype)
    elif t.storage_width == 64:
      hi = 64 if not t.is_signed else 63
      bits = np.where(rng.random(n) < 0.5, 24, 53)
      v = np.where(bits == 24, _near_midpoints(rng, n, 24, 53, hi),
                   _near_midpoints(rng, n, 53, 53, hi))
      if t.is_signed:
        v = v.view(np.int64) * np.where(rng.random(n) < 0.5, -1, 1)
    elif t.storage_width == 32:
      v = _near_midpoints(rng, n, 24, 24, 31).astype(np.int64)
      if t.is_signed:
        v = v * np.where(rng.random(n) < 0.5, -1, 1)
    else:
      continue
    v = oracle.wrap(np, v.reshape(shape), t)
    out[name] = np.where(moved.reshape(shape), v, out[name]).astype(
        out[name].dtype)
  return out


def c6_program(out_type: str) -> str:
  """Fault C6's program: a uint64 input converted to ``out_type``."""
  return '\n'.join([
      'kernel: c6', 'burst width: 64', 'unroll factor: 1', 'iterate: 1',
      'border: ignore', 'cluster: none',
      'input dram 0 uint64: a(16, *)',
      'output dram 1 %s: o(0, 0) = %s(a(0, 0))' % (out_type, out_type)])


# fault C5: gen_program seeds whose double -> half conversions were
# rounded twice (221 at C5_SHAPES[221], the others at C5_SHAPE)
C5_SEEDS = (221, 288, 515, 794, 852, 879, 1153, 1261, 1750, 1971)
C5_SHAPE = (40, 96)
C5_SHAPES = {221: (20, 48)}
# fault C6: (output type, the uint64 in every cell) whose conversion was
# rounded twice (numpy: 2**63 + 2048 and 9.223373e+18)
C6_CASES = (('double', 2**63 + 1025), ('float', 2**63 + 2**39 + 1))


def regression_cases(shape=None):
  """(label, DSL text, shape, inputs) of faults C5 and C6, at their own
  shapes or at ``shape``."""
  cases = []
  for seed in C5_SEEDS:
    text = gen_program(seed)
    at = shape or C5_SHAPES.get(seed, C5_SHAPE)
    cases.append(('c5 fuzz%d' % seed, text, at,
                  make_inputs(build_stencil(text), at, seed)))
  for out_type, value in C6_CASES:
    at = shape or FUZZ_SHAPE
    cases.append(('c6 %s' % out_type, c6_program(out_type), at,
                  {'a': np.full(at, value, np.uint64)}))
  return cases
