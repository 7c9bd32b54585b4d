"""The fused kernel's modes on the CPU, held against the JAX package.

The port's ``streamed_stencil_plain`` walks a mode plan as the kernel
does (runs of axis-0 tiles per CTA, input windows kept from step to
step, only the new rows loaded by the rolling fill); ``FusedExecutor``
takes it on the CPU whenever ``stream_loop`` is set. The keys build the
short form (tile_plan.ShortForm, the walk carrying ``stream_loop``);
the old mode kernel, which ``_short=()`` keeps, is held against the
JAX executor on the rolling fill's edges. Each case runs
the JAX ``PallasExecutor`` / ``MidTiledPallasExecutor`` in interpret
mode with the same mode, on the cases of tests/test_pallas.py (out_dma,
stream_loop, prefetch, dma_split), with ``block_rows`` the port's
``tile[0]`` and ``mid_tile`` its ``tile[1]``; the JAX cases' layout
keys (stage_mode, shift_mode, transpose_lanes) go to the port as they
are and select its layout forms (tests/test_torch_layout.py). Integers
bit-exact, floats within tests/checks.py's threshold (1e-4, contrast
1e-3).

``tile_plan.MIN_CTAS`` is set to 1 for these grids, so one CTA walks a
whole tile column, as the JAX kernel's ``stream_loop`` walks the whole
grid in one invocation; the edge cases set other values.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from soda_tpu import api as jax_api
from soda_tpu.backend.pallas_kernel import (MidTiledPallasExecutor,
                                            PallasExecutor)
from soda_tpu_torch import corpus, utils
from soda_tpu_torch.api import build_stencil
from soda_tpu_torch.backend import reference, tile_plan
from soda_tpu_torch.backend.fused import (FusedExecutor, fused_stencil_plain,
                                          streamed_stencil_plain)
from soda_tpu_torch.testing import check_outputs

REPO = pathlib.Path(__file__).resolve().parent.parent

TILES = {'jacobi3d': (64, 32, 0), 'blur': (64, 0), 'heat3d': (64, 32, 0),
         'erosion': (64, 0), 'denoise2d': (64, 0)}


def _jax(name, shape, kw):
  """The JAX executor's outputs (numpy) for the same program and mode."""
  stencil = jax_api.build_stencil(corpus.CORPUS[name], tile_size=TILES[name])
  cls = MidTiledPallasExecutor if 'mid_tile' in kw else PallasExecutor
  inputs = reference.make_test_inputs(build_stencil(
      corpus.CORPUS[name], tile_size=TILES[name]), shape)
  got = cls(stencil, shape, **kw)(inputs)
  return {k: np.asarray(v) for k, v in got.items()}, inputs


def _port(name, shape, kw, inputs, min_ctas=1):
  """The port's executor on the CPU with the same mode and keys, and its
  plan."""
  opts = dict(kw)
  stencil = build_stencil(corpus.CORPUS[name], tile_size=TILES[name])
  saved = tile_plan.MIN_CTAS
  tile_plan.MIN_CTAS = min_ctas
  try:
    ex = FusedExecutor(stencil, shape, device='cpu', **opts)
  finally:
    tile_plan.MIN_CTAS = saved
  got = {k: v.numpy() for k, v in ex(inputs).items()}
  return stencil, ex, got


def _compare(name, shape, jax_kw, port_kw, context):
  want, inputs = _jax(name, shape, jax_kw)
  stencil, ex, got = _port(name, shape, port_kw, inputs)
  if port_kw.get('block_rows'):
    assert ex.plan.tile[0] == port_kw['block_rows']
  if port_kw.get('mid_tile'):
    assert ex.plan.tile[1] == port_kw['mid_tile']
  check_outputs(stencil, shape, got, want, '%s %s' % (name, context))
  return ex


# tests/test_pallas.py:264-269 (test_out_dma_matches_oracle)
@pytest.mark.parametrize('name,shape,kw', [
    ('jacobi3d', (64, 64, 64), {'mid_tile': 32, 'block_rows': 16}),
    ('blur', (128, 64), {'block_rows': 32}),
    ('heat3d', (64, 32, 64), {'block_rows': 16}),
    ('erosion', (256, 64), {'block_rows': 64}),
])
def test_out_dma_matches_jax(name, shape, kw):
  ex = _compare(name, shape, dict(kw, out_dma=True), dict(kw, out_dma=True),
                'out_dma')
  assert ex.plan.staging


# tests/test_pallas.py:291-306 (test_stream_loop_matches_oracle)
@pytest.mark.parametrize('stream_loop', [True, 'peel'])
@pytest.mark.parametrize('name,shape,kw', [
    ('jacobi3d', (64, 64, 64), {'mid_tile': 32, 'block_rows': 16}),
    ('jacobi3d', (64, 64, 64), {'mid_tile': 16, 'block_rows': 16}),
    ('jacobi3d', (64, 96, 64), {'mid_tile': 16, 'block_rows': 16}),
    ('blur', (128, 64), {'block_rows': 32}),
    ('heat3d', (64, 32, 64),
     {'block_rows': 16, 'stage_mode': 'value', 'shift_mode': 'roll'}),
    ('erosion', (256, 64),
     {'block_rows': 64, 'stage_mode': 'value', 'shift_mode': 'roll',
      'transpose_lanes': 'on'}),
    ('denoise2d', (64, 64), {'block_rows': 8, 'stage_mode': 'vmem'}),
])
def test_stream_loop_matches_jax(name, shape, kw, stream_loop):
  kw = dict(kw, stream_loop=stream_loop)
  ex = _compare(name, shape, kw, kw, 'stream_loop=%s' % stream_loop)
  assert ex.plan.steps == ex.plan.grid[0]  # one CTA per tile column
  assert ex.plan.peel == (stream_loop == 'peel' and ex.plan.steps >= 4)


# tests/test_pallas.py:336-344 (test_prefetch_depth_matches_oracle); a
# depth above 2 runs with stream_loop on the port's side (a CTA without
# it computes one tile: there is no next step to fetch ahead)
@pytest.mark.parametrize('prefetch', [2, 3, 4])
@pytest.mark.parametrize('name,shape,kw', [
    ('blur', (128, 64), {'block_rows': 16}),
    ('jacobi3d', (64, 64, 64), {'mid_tile': 32, 'block_rows': 8}),
    ('jacobi3d', (96, 32, 64), {'block_rows': 16, 'stream_loop': 'peel'}),
    ('heat3d', (64, 32, 64),
     {'block_rows': 8, 'stage_mode': 'value', 'shift_mode': 'roll',
      'stream_loop': True}),
])
def test_prefetch_depth_matches_jax(name, shape, kw, prefetch):
  port_kw = dict(kw, prefetch=prefetch)
  if prefetch > 2 and 'stream_loop' not in kw:
    port_kw['stream_loop'] = True
  ex = _compare(name, shape, dict(kw, prefetch=prefetch), port_kw,
                'prefetch=%d' % prefetch)
  assert ex.plan.slots == (prefetch if ex.config.stream_loop else 1)
  # a ring deeper than 2 trades the rolling fill for whole windows, as
  # the JAX kernel does (pallas_kernel.py:867-873)
  assert not (ex.plan.rolling and prefetch > 2)


# tests/test_pallas.py:436-449 (test_dma_split_matches_oracle)
@pytest.mark.parametrize('dma_split', [2, 3])
@pytest.mark.parametrize('name,shape,kw', [
    ('jacobi3d', (64, 64, 64), {'mid_tile': 32, 'block_rows': 8}),
    ('jacobi3d', (96, 32, 64),
     {'block_rows': 8, 'stage_mode': 'value', 'shift_mode': 'roll',
      'stream_loop': 'peel'}),
    ('heat3d', (64, 32, 64), {'block_rows': 3, 'prefetch': 3}),
])
def test_dma_split_matches_jax(name, shape, kw, dma_split):
  port_kw = dict(kw, dma_split=dma_split)
  if kw.get('prefetch', 2) > 2:
    port_kw['stream_loop'] = True
  ex = _compare(name, shape, dict(kw, dma_split=dma_split), port_kw,
                'dma_split=%d' % dma_split)
  assert ex.config.dma_split == dma_split


# the rolling window's edges: a ragged last tile (odd extents), a halo
# that reaches or exceeds the tile (erosion's 18 rows against 16; no
# rolling), runs of fewer than 4 steps (no peeling), and runs cut by the
# grid's end (a MIN_CTAS that splits a tile column into several runs)
EDGES = [
    ('blur', (130, 64), {'stream_loop': True, 'block_rows': 16}, 1, True,
     False),
    ('blur', (131, 67), {'stream_loop': 'peel', 'block_rows': 8}, 1, True,
     True),
    ('blur', (130, 64), {'stream_loop': 'peel', 'block_rows': 8}, 3, True,
     True),
    ('erosion', (130, 64), {'stream_loop': 'peel', 'block_rows': 16}, 1,
     False, True),
    ('erosion', (130, 64), {'stream_loop': True, 'block_rows': 32}, 1, True,
     False),
    ('blur', (40, 64), {'stream_loop': 'peel', 'block_rows': 16}, 1, True,
     False),
    ('jacobi3d', (13, 17, 19), {'stream_loop': 'peel', 'block_rows': 5}, 1,
     True, False),
    ('jacobi3d', (30, 17, 19), {'stream_loop': 'peel', 'block_rows': 5}, 1,
     True, True),
    ('jacobi3d', (30, 17, 19), {'stream_loop': True, 'block_rows': 4}, 3,
     False, False),
]


@pytest.mark.parametrize('name,shape,kw,min_ctas,rolling,peel', EDGES)
def test_rolling_window_edges_match_jax(name, shape, kw, min_ctas, rolling,
                                        peel):
  """The old mode kernel's rolling fill (``_short=()``)."""
  jax_kw = {'stream_loop': kw['stream_loop'], 'block_rows': kw['block_rows']}
  want, inputs = _jax(name, shape, jax_kw)
  stencil, ex, got = _port(name, shape, dict(kw, _short=()), inputs,
                           min_ctas)
  plan = ex.plan
  assert (plan.rolling, plan.peel) == (rolling, peel), (plan.rolling,
                                                        plan.peel, plan.steps)
  check_outputs(stencil, shape, got, want, '%s %s' % (name, kw))
  # the plain versions agree: the streamed walk with the whole-grid one
  args = ex.prepare(inputs)
  whole = fused_stencil_plain(stencil, args)
  check_outputs(stencil, shape, got, dict(zip(stencil.output_names, whole)),
                '%s %s vs whole grid' % (name, kw))


@pytest.mark.parametrize('name,shape,kw,min_ctas,rolling,peel', EDGES)
def test_walk_edges_match_jax(name, shape, kw, min_ctas, rolling, peel):
  """The same edges on the short form the keys build: its walk keeps
  the rows consecutive tiles share in rings at any halo, so the plan
  has no rolling fill of windows; runs and peeling as the old plan's."""
  jax_kw = {'stream_loop': kw['stream_loop'], 'block_rows': kw['block_rows']}
  want, inputs = _jax(name, shape, jax_kw)
  stencil, ex, got = _port(name, shape, kw, inputs, min_ctas)
  plan = ex.plan
  assert plan.short is not None and plan.short.has('walk')
  assert plan.tile[0] == kw['block_rows'] and not plan.rolling
  assert plan.peel == peel, (plan.peel, plan.steps)
  check_outputs(stencil, shape, got, want, '%s %s' % (name, kw))
  whole = fused_stencil_plain(stencil, ex.prepare(inputs))
  check_outputs(stencil, shape, got, dict(zip(stencil.output_names, whole)),
                '%s %s vs whole grid' % (name, kw))


def test_fill_classes_of_a_run():
  """A run's first step loads its whole window; the later ones keep the
  overlap and load the new rows ('mid'), zero-filling past the array's
  end ('tail')."""
  stencil = build_stencil(corpus.CORPUS['blur'])
  saved = tile_plan.MIN_CTAS
  tile_plan.MIN_CTAS = 1
  try:
    plan = tile_plan.kernel_plan(stencil, (130, 64), block_rows=16,
                                 stream_loop=True, _short=())
  finally:
    tile_plan.MIN_CTAS = saved
  assert plan.grid[0] == 9 and plan.steps == 9 and plan.rolling
  classes = [plan.fill_class('input', k, 0) for k in range(9)]
  assert classes == ['full'] + ['mid'] * 7 + ['tail']
  assert plan.halo0('input') == 2


def test_streamed_plain_checks_the_steady_steps():
  """Under 'peel' the steps the kernel runs without axis-0 checks are
  checked to need none: erosion's 9-row offsets against 4-row tiles
  leave steps near the array's ends that need them, and a plan whose
  steady range is widened by one step fails."""
  import dataclasses

  import torch
  stencil = build_stencil(corpus.CORPUS['erosion'])
  saved = tile_plan.MIN_CTAS
  tile_plan.MIN_CTAS = 1
  try:
    plan = tile_plan.kernel_plan(stencil, (130, 64), block_rows=4,
                                 stream_loop='peel')
  finally:
    tile_plan.MIN_CTAS = saved
  assert plan.peel and plan.steady == (3, 29)
  inputs = reference.make_test_inputs(stencil, (130, 64))
  args = tuple(torch.from_numpy(inputs[n]) for n in stencil.input_names)
  streamed_stencil_plain(stencil, args, tile=plan)

  class Wide(type(plan)):
    @property
    def steady(self):
      return (2, 29)

  wide = Wide(**{f.name: getattr(plan, f.name)
                 for f in dataclasses.fields(plan)})
  with pytest.raises(utils.InternalError, match='steady step'):
    streamed_stencil_plain(stencil, args, tile=wide)


def test_prefetch_needs_stream_loop():
  stencil = build_stencil(corpus.CORPUS['blur'])
  with pytest.raises(utils.InputError, match='needs stream_loop'):
    FusedExecutor(stencil, (128, 64), device='cpu', prefetch=3)


@pytest.mark.parametrize('kw,exc,match', [
    ({'stream_loop': 'yes'}, ValueError, 'stream_loop must be'),
    ({'prefetch': 1}, ValueError, r'prefetch must be in \[2, 4\]'),
    ({'prefetch': 5}, ValueError, r'prefetch must be in \[2, 4\]'),
    ({'dma_split': 0}, ValueError, r'dma_split must be in \[1, 8\]'),
    ({'dma_split': 9}, ValueError, r'dma_split must be in \[1, 8\]'),
    ({'dma_split': 2}, ValueError, 'dma_split requires a 3-D'),
])
def test_validation_errors_match_jax(kw, exc, match):
  """The same key values fail with the same exception type and message
  in both packages."""
  st_port = build_stencil(corpus.CORPUS['blur'])
  st_jax = jax_api.build_stencil(corpus.CORPUS['blur'])
  with pytest.raises(exc, match=match):
    PallasExecutor(st_jax, (128, 64), **kw)
  with pytest.raises(exc, match=match):
    FusedExecutor(st_port, (128, 64), device='cpu', **kw)


@pytest.mark.parametrize('key,value', [
    ('lane_shift', 'rotate'), ('shift_mode', 'roll'),
    ('transpose_lanes', 'on'), ('narrow', 'on'), ('stage_mode', 'vmem'),
    ('compute_chunk', 8), ('interpret', True),
])
def test_layout_keys_name_roadmap_b9(key, value):
  """The JAX kernel's layout keys (once listed as ROADMAP B item 9) run
  here as they run there, each on its own, and match the JAX executor;
  ``interpret`` has no counterpart and raises naming the CPU device."""
  st_jax = jax_api.build_stencil(corpus.CORPUS['jacobi3d'],
                                 tile_size=(64, 32, 0))
  stencil = build_stencil(corpus.CORPUS['jacobi3d'], tile_size=(64, 32, 0))
  shape = (64, 32, 64)
  inputs = reference.make_test_inputs(stencil, shape)
  want = PallasExecutor(st_jax, shape, **{key: value})(inputs)
  if key == 'interpret':
    with pytest.raises(utils.InputError, match="device='cpu'"):
      FusedExecutor(stencil, shape, device='cpu', **{key: value})
    return
  got = FusedExecutor(stencil, shape, device='cpu', **{key: value})(inputs)
  check_outputs(stencil, shape, {k: v.numpy() for k, v in got.items()},
                {k: np.asarray(v) for k, v in want.items()},
                'jacobi3d %s=%s' % (key, value))


def test_unknown_key_is_a_type_error():
  stencil = build_stencil(corpus.CORPUS['blur'])
  with pytest.raises(TypeError, match='bogus'):
    FusedExecutor(stencil, (128, 64), device='cpu', bogus=1)


def test_block_rows_and_mid_tile_set_the_tile():
  stencil = build_stencil(corpus.CORPUS['jacobi3d'], tile_size=(64, 32, 0))
  ex = FusedExecutor(stencil, (64, 64, 64), device='cpu', block_rows=16,
                     mid_tile=32)
  assert ex.plan.tile[:2] == (16, 32)
  with pytest.raises(utils.InputError, match='not both'):
    FusedExecutor(stencil, (64, 64, 64), device='cpu', tile=(8, 8, 64),
                  block_rows=16)
  blur = build_stencil(corpus.CORPUS['blur'])
  with pytest.raises(utils.InputError, match='3-D grids only'):
    FusedExecutor(blur, (128, 64), device='cpu', mid_tile=8)


def test_mode_plans_count_their_shared_memory():
  """The ring's extra windows and the staging buffers are counted: in
  the old mode kernel (``_short=()``) a deeper ring takes a smaller tile,
  in the short form's walk deeper rings take more bytes at a tile (or
  raise for a tile given), never a launch past the limit."""
  stencil = build_stencil(corpus.CORPUS['jacobi3d'])
  shape = (2048, 32, 128)
  old = {depth: tile_plan.kernel_plan(stencil, shape, stream_loop=True,
                                      prefetch=depth, _short=())
         for depth in (2, 4)}
  plans = {depth: tile_plan.kernel_plan(stencil, shape, stream_loop=True,
                                        prefetch=depth) for depth in (2, 4)}
  for plan in list(old.values()) + list(plans.values()):
    assert plan.smem_bytes <= tile_plan.SMEM_LIMIT
  assert np.prod(old[4].tile) < np.prod(old[2].tile)
  deeper = tile_plan.kernel_plan(stencil, shape, tile=plans[2].tile,
                                 stream_loop=True, prefetch=4)
  assert deeper.smem_bytes > plans[2].smem_bytes
  assert deeper.short.depth == 4 and plans[2].short.depth == 2
  for kw in ({}, {'_short': ()}):
    with pytest.raises(utils.InputError, match='shared memory'):
      tile_plan.kernel_plan(stencil, shape, tile=(16, 32, 128),
                            stream_loop=True, prefetch=4, **kw)
  default = tile_plan.make_tile_plan(stencil, shape)
  staged = tile_plan.kernel_plan(stencil, shape, out_dma=True,
                                 tile=default.tile)
  # against the default form at the same tile (the default kernel is the
  # short form, whose walk keeps rings of rows)
  assert staged.smem_bytes > tile_plan.make_tile_plan(
      stencil, shape, default.tile).smem_bytes
  assert tile_plan.kernel_plan(stencil, shape) == default


def test_steps_per_cta_keeps_two_ctas_per_sm():
  for grid in ((128, 16), (1024, 1, 1), (32, 8, 2), (7, 3), (600, 1)):
    steps = tile_plan.steps_per_cta(grid)
    cols = int(np.prod(grid[1:]))
    ctas = cols * -(-grid[0] // steps)
    if grid[0] * cols >= tile_plan.MIN_CTAS:
      assert ctas >= tile_plan.MIN_CTAS
      assert cols * -(-grid[0] // (steps + 1)) < tile_plan.MIN_CTAS
    else:
      assert steps == 1


_GENERATE = '''
import sys
sys.path.insert(0, %r)
import hashlib
from soda_tpu_torch import testing
from soda_tpu_torch.backend import cuda_source, tile_plan
shape_of = {n: s for n, s, _ in testing.CELLS}
ov_of = {n: o for n, _, o in testing.CELLS}
for name, opts in testing.MODE_CELLS:
  st = testing.build_cell(name, ov_of[name])
  text = cuda_source.generate(tile_plan.kernel_plan(st, shape_of[name],
                                                    **opts)).text
  print(name, sorted(opts.items()), hashlib.sha256(text.encode()).hexdigest())
tile_plan.MIN_CTAS = 1
for name, shape, opts, _, _ in testing.MODE_CASES:
  text = cuda_source.generate(tile_plan.kernel_plan(
      testing.mode_stencil(name), shape, **opts)).text
  print(name, shape, sorted(opts.items()),
        hashlib.sha256(text.encode()).hexdigest())
'''


def test_mode_sources_are_independent_of_the_hash_seed():
  """Each mode kernel's source keys its build: it must not depend on
  PYTHONHASHSEED (the fusion plan's stage order does,
  plan.py:256, :279-283)."""
  outs = []
  for seed in ('1', '2'):
    env = dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS='cpu')
    proc = subprocess.run([sys.executable, '-c', _GENERATE % str(REPO)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    outs.append(proc.stdout)
  assert outs[0] == outs[1]
  assert len(outs[0].splitlines()) == 18 + 22
