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
- Test cases: tile geometries, an output read by a stage, a program
  with params, a seeded generator of random DSL programs over every
  integer width and sign, half, float and double, and distinct inputs
  per replica of a replicated batch.
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

__all__ = ['CELLS', 'CONV_PARAM', 'SHARDED', 'repeated_mesh', 'FUZZ_SEEDS', 'FUZZ_SHAPE',
           'GEOMETRY_CASES', 'MULTI_OUTPUT', 'build_cell', 'check_outputs',
           'gen_program', 'make_inputs', 'make_test_inputs',
           'make_test_params', 'oracle_run', 'output_valid_slices',
           'replica_inputs', 'threshold_for']

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
