"""The fused kernel's layout forms on the CPU, held against the JAX package.

The JAX kernel's layout keys (``stage_mode``, ``shift_mode``,
``lane_shift``, ``transpose_lanes``, ``narrow``, ``compute_chunk``) go to
the port's ``FusedExecutor`` as they are and build the short form's
layout element; on the CPU it runs the form's plain version (the short
form's, ``fused_stencil_plain`` at the plan's tile, walked under
``stream_loop``). Each case runs the JAX
``PallasExecutor`` / ``MidTiledPallasExecutor`` in interpret mode with the
same keys on the cases of the JAX package's tests (tests/test_pallas.py,
tests/test_narrow.py) and on the 24 seed configurations of its bench at
small shapes. Integers bit-exact, floats within tests/checks.py's
threshold (1e-4, contrast 1e-3), on each output's valid region. The key
rules raise the JAX package's exception types.
"""

import functools

import numpy as np
import pytest

from soda_tpu import api as jax_api
from soda_tpu import utils as jax_utils
from soda_tpu.backend.pallas_kernel import (MidTiledPallasExecutor,
                                            PallasExecutor)
from soda_tpu_torch import corpus, utils
from soda_tpu_torch.api import build_stencil
from soda_tpu_torch.backend import layout, reference, tile_plan
from soda_tpu_torch.backend.fused import FusedExecutor
from soda_tpu_torch.backend.plan import make_plan
from soda_tpu_torch.testing import (NARROW_PAIRS, SEED_CONFIGS, check_outputs,
                                    seed_small)

GREEDY = {'optimizations': {'computation-reuse': 'greedy'}}


def _key(overrides):
  return repr(sorted(overrides.items()))


@functools.lru_cache(maxsize=None)
def _stencils(text, key):
  overrides = dict(eval(key))  # noqa: S307 - our own repr of a dict
  return (jax_api.build_stencil(text, **overrides),
          build_stencil(text, **overrides))


def _compare(text, overrides, shape, kw, context, port_kw=None):
  """The JAX executor and the port's, same program, keys and inputs."""
  st_jax, st_port = _stencils(text, _key(overrides))
  inputs = reference.make_test_inputs(st_port, shape)
  params = reference.make_test_params(st_port)
  cls = MidTiledPallasExecutor if 'mid_tile' in kw else PallasExecutor
  want = {k: np.asarray(v) for k, v in cls(st_jax, shape, **kw)(
      inputs, params).items()}
  ex = FusedExecutor(st_port, shape, device='cpu', **(port_kw or kw))
  got = {k: v.numpy() for k, v in ex(inputs, params).items()}
  check_outputs(st_port, shape, got, want, context)
  return ex


def _corpus(name, overrides, shape, kw, context):
  return _compare(corpus.CORPUS[name], overrides, shape, kw,
                  '%s %s' % (name, context))


# tests/test_pallas.py:370-395 (test_roll_shift_mode_matches_oracle)
@pytest.mark.parametrize('name,ov', [
    ('erosion', GREEDY), ('xcorr', GREEDY), ('jacobi2d', {}),
    ('sobel2d', {}), ('blur', {}), ('heat3d', {}), ('denoise2d', {}),
])
def test_roll_matches_jax(name, ov):
  shape = (64, 32, 64) if name == 'heat3d' else (256, 128)
  tile = (64, 32, 0) if name == 'heat3d' else (128, 0)
  ex = _corpus(name, dict(ov, tile_size=tile), shape,
               {'stage_mode': 'value', 'shift_mode': 'roll',
                'block_rows': 32}, 'roll')
  assert ex.plan.layout.roll and ex.plan.warp is None
  assert ex.plan.short.region is not None  # the short form's value region
  assert ex.plan.tile[0] == 32


# tests/test_pallas.py:203-219 (test_transposed_lane_regions_match_oracle)
@pytest.mark.parametrize('name', ['erosion', 'xcorr', 'sobel2d'])
def test_transposed_regions_match_jax(name):
  ex = _corpus(name, dict(GREEDY, tile_size=(256, 0)), (96, 256),
               {'lane_shift': 'slice', 'block_rows': 32}, 'transposed')
  assert ex.plan.layout.lane_shift == 'slice'


# tests/test_pallas.py:222-237 (test_transpose_lanes_off_disables_regions)
@pytest.mark.parametrize('mode', ['off', 'auto', 'on'])
def test_transpose_lanes_modes_match_jax(mode):
  ex = _corpus('erosion', dict(GREEDY, tile_size=(256, 0)), (64, 256),
               {'lane_shift': 'slice', 'transpose_lanes': mode},
               'transpose_lanes=%s' % mode)
  assert bool(ex.plan.layout.transposed) == (mode != 'off')


# tests/test_pallas.py:104-117 (test_compute_chunked_3d)
@pytest.mark.parametrize('chunk', [4, 8])
def test_compute_chunk_matches_jax(chunk):
  ex = _corpus('jacobi3d', {}, (48, 16, 128),
               {'block_rows': 8, 'compute_chunk': chunk}, 'chunk')
  assert ex.plan.layout.form == 'L4' and ex.plan.warp is None


# tests/test_pallas.py:120-132 (test_compute_chunked_with_mid_blocking)
def test_compute_chunk_with_mid_tile_matches_jax():
  ex = _corpus('heat3d', {}, (48, 64, 128),
               {'mid_tile': 16, 'block_rows': 8, 'compute_chunk': 4},
               'chunk mid')
  assert ex.plan.tile[:2] == (8, 16)


# tests/test_pallas.py:135-151 (test_compute_chunked_stream_loop)
@pytest.mark.parametrize('stream_loop', [True, 'peel'])
def test_compute_chunk_streaming_matches_jax(stream_loop):
  saved = tile_plan.MIN_CTAS
  tile_plan.MIN_CTAS = 1
  try:
    ex = _corpus('jacobi3d', {}, (48, 64, 128),
                 {'mid_tile': 16, 'block_rows': 8, 'compute_chunk': 4,
                  'stream_loop': stream_loop}, 'chunk stream')
  finally:
    tile_plan.MIN_CTAS = saved
  assert ex.plan.steps == ex.plan.grid[0]


# tests/test_narrow.py:147-157 (test_xcorr_full_pipeline)
@pytest.mark.parametrize('ov', [{}, GREEDY], ids=['plain', 'greedy'])
def test_narrow_xcorr_matches_jax(ov):
  ex = _corpus('xcorr', dict(ov, tile_size=(128, 0)), (96, 128),
               {'stage_mode': 'value', 'narrow': 'on'}, 'narrow')
  assert ex.plan.layout.narrow16


# tests/test_narrow.py:187-203 (test_narrow_composes_with_roll_mode)
def test_narrow_with_roll_matches_jax():
  ex = _compare(NARROW_PAIRS, {}, (64, 64),
                {'stage_mode': 'value', 'narrow': 'on',
                 'shift_mode': 'roll'}, 'narrow roll')
  assert ex.plan.layout.narrow16 == {'t', 'y'}


# the 24 seed configurations of bench.py:51-163 at small shapes
@pytest.mark.parametrize('index', range(len(SEED_CONFIGS)),
                         ids=['%s-%d' % (c[0], i % 2)
                              for i, c in enumerate(SEED_CONFIGS)])
def test_seed_config_matches_jax(index):
  name, shape, overrides, opts = SEED_CONFIGS[index]
  small, overrides = seed_small(name, shape, overrides)
  saved = tile_plan.MIN_CTAS
  tile_plan.MIN_CTAS = 1
  try:
    ex = _corpus(name.split('_')[0], overrides, small, opts,
                 'seed %d' % (index % 2))
  finally:
    tile_plan.MIN_CTAS = saved
  keys = set(opts) & set(layout.LAYOUT_KEYS)
  if keys and opts.get('stage_mode', 'value') == 'value':
    assert ex.plan.short.region is not None and ex.plan.warp is None


@pytest.mark.parametrize('kw,exc,match', [
    ({'transpose_lanes': 'yes'}, ValueError, 'transpose_lanes must be'),
    ({'narrow': 'yes'}, ValueError, 'narrow must be'),
    ({'shift_mode': 'shift'}, ValueError, 'shift_mode must be'),
    ({'stage_mode': 'regs'}, ValueError, 'stage_mode must be'),
    ({'stage_mode': 'vmem', 'shift_mode': 'roll'}, utils.InputError,
     'shift_mode=roll requires stage_mode=value'),
    ({'compute_chunk': 8}, utils.InputError, '3-D grids only'),
])
def test_key_rules_match_jax_2d(kw, exc, match):
  """The same key values fail with the same exception type and message
  in both packages."""
  st_port = build_stencil(corpus.CORPUS['blur'])
  st_jax = jax_api.build_stencil(corpus.CORPUS['blur'])
  jax_exc = jax_utils.InputError if exc is utils.InputError else exc
  with pytest.raises(jax_exc, match=match):
    PallasExecutor(st_jax, (128, 64), **kw)
  with pytest.raises(exc, match=match):
    FusedExecutor(st_port, (128, 64), device='cpu', **kw)


@pytest.mark.parametrize('kw,match', [
    ({'compute_chunk': 0}, 'positive int'),
    ({'compute_chunk': -8}, 'positive int'),
    ({'compute_chunk': 'x'}, 'positive int'),
    ({'mid_tile': 16, 'stage_mode': 'vmem'}, 'requires stage_mode=value'),
])
def test_key_rules_match_jax_3d(kw, match):
  st_port = build_stencil(corpus.CORPUS['jacobi3d'])
  st_jax = jax_api.build_stencil(corpus.CORPUS['jacobi3d'])
  with pytest.raises(jax_utils.InputError, match=match):
    PallasExecutor(st_jax, (48, 16, 128), block_rows=8, **kw)
  with pytest.raises(utils.InputError, match=match):
    FusedExecutor(st_port, (48, 16, 128), device='cpu', block_rows=8, **kw)


def test_interpret_names_the_cpu_device():
  """Pallas's interpret mode has no counterpart: the kernel's plain
  version on the CPU is."""
  stencil = build_stencil(corpus.CORPUS['blur'])
  with pytest.raises(utils.InputError, match="device='cpu'"):
    FusedExecutor(stencil, (128, 64), device='cpu', interpret=True)


def _resolve(stencil, shape, **keys):
  return layout.layout_config(make_plan(stencil, 'full'), shape, **keys)


def test_auto_resolutions_follow_jax():
  """lane_shift 'auto' rotates rows up to 256 wide; stage_mode 'auto'
  keeps value mode unless the folds are wide; 'vmem' without chunks is
  the default kernel; transposed regions under 'auto' take at most two
  crossings; narrow 'auto' is off."""
  blur = build_stencil(corpus.CORPUS['blur'])
  assert _resolve(blur, (64, 256)).lane_shift == 'rotate'
  assert _resolve(blur, (64, 257)).lane_shift == 'slice'
  assert _resolve(blur, (64, 64), stage_mode='vmem') is None
  assert tile_plan.kernel_plan(blur, (64, 64), stage_mode='vmem') == \
      tile_plan.kernel_plan(blur, (64, 64))
  assert not _resolve(blur, (64, 64), narrow='auto').narrow16
  erosion = build_stencil(corpus.CORPUS['erosion'], **GREEDY)
  auto = _resolve(erosion, (64, 512), lane_shift='slice')
  on = _resolve(erosion, (64, 512), lane_shift='slice',
                transpose_lanes='on')
  assert auto.transposed <= on.transposed and on.transposed
  contrast = build_stencil(corpus.CORPUS['contrast'])
  assert _resolve(contrast, (64, 64)) is None  # wide folds


def test_kernel_plan_builds_one_fusion_plan(monkeypatch):
  """A layout plan resolves its keys and places its tiles from one
  fusion plan, and equals the plan made from a fusion plan built
  apart."""
  stencil = build_stencil(corpus.CORPUS['erosion'], **GREEDY)
  keys = dict(stage_mode='value', shift_mode='roll', transpose_lanes='on')
  want = tile_plan.make_tile_plan(
      stencil, (64, 512),
      config=tile_plan.KernelConfig(layout=_resolve(stencil, (64, 512),
                                                    **keys)))
  built = []

  def counted(*args, **kwargs):
    built.append(args)
    return make_plan(*args, **kwargs)

  monkeypatch.setattr(tile_plan, 'make_plan', counted)
  monkeypatch.setattr(layout, 'make_plan', counted, raising=False)
  assert tile_plan.kernel_plan(stencil, (64, 512), **keys) == want
  assert len(built) == 1


def test_sobel_seed_runs_in_value_mode():
  """A seed with only ``lane_shift`` takes the JAX defaults for the other
  keys (stage_mode 'auto' -> value), as it ran on the TPU."""
  stencil = build_stencil(corpus.CORPUS['sobel2d'])
  plan = tile_plan.kernel_plan(stencil, (256, 512), lane_shift='slice',
                               block_rows=64)
  assert plan.layout.value and plan.layout.shift_mode == 'window'
  assert plan.short.region is not None  # the short form's value region
  # the stages read at minor-axis offsets read the shared frame
  assert any('slice' in why for why in plan.short.region.off.values())
  old = tile_plan.kernel_plan(stencil, (256, 512), lane_shift='slice',
                              block_rows=64, _short=())
  assert old.warp.scratch > 0  # the old form's slice rows


def test_value_plan_counts_its_scratch():
  """An old value plan's (``_short=()``) shared memory holds the input
  windows and every warp's scratch; the stages live in registers."""
  stencil = build_stencil(corpus.CORPUS['erosion'], **GREEDY)
  plan = tile_plan.kernel_plan(stencil, (512, 512), stage_mode='value',
                               shift_mode='roll', transpose_lanes='on',
                               block_rows=64, _short=())
  warp = plan.warp
  assert set(plan.offsets) == {'input'}
  assert warp.scratch >= 32 * warp.lane_rows * (warp.width + 1) * warp.word
  assert plan.smem_bytes == warp.scratch_offset + 16 * warp.scratch
  assert 0 < warp.regs <= tile_plan.REG_LIMIT


# the executors that forward the keys: grouped (each group resolves them
# for its own sub-stencil, as GroupedPallasExecutor's **kwargs do),
# replicated, and sharded (inner_opts), against the JAX executors
@pytest.mark.parametrize('name,shape,kw', [
    ('blur', (64, 96), {'stage_mode': 'value', 'shift_mode': 'roll',
                        'block_rows': 16}),
    ('sobel2d', (48, 300), {'lane_shift': 'slice', 'block_rows': 8}),
    ('denoise2d', (40, 48), {'stage_mode': 'value', 'block_rows': 8}),
    ('heat3d', (24, 12, 40), {'compute_chunk': 3, 'block_rows': 8}),
])
def test_grouped_forwards_layout_keys_per_group(name, shape, kw):
  from soda_tpu.backend.grouped import GroupedPallasExecutor
  from soda_tpu_torch.backend.grouped import GroupedExecutor
  st_jax, st_port = _stencils(corpus.CORPUS[name], _key({'cluster':
                                                         'coarse'}))
  inputs = reference.make_test_inputs(st_port, shape)
  want = GroupedPallasExecutor(st_jax, shape, **kw)(inputs)
  ex = GroupedExecutor(st_port, shape, device='cpu', **kw)
  assert any(sub_ex.plan.layout is not None for _, sub_ex in ex.executors)
  got = {k: v.numpy() for k, v in ex(inputs).items()}
  check_outputs(st_port, shape, got,
                {k: np.asarray(v) for k, v in want.items()},
                '%s grouped %s' % (name, kw))


def test_replicated_forwards_layout_keys():
  from soda_tpu.parallel.replicate import (
      ReplicatedExecutor as JaxReplicatedExecutor)
  from soda_tpu_torch.parallel.replicate import ReplicatedExecutor
  from soda_tpu_torch.testing import replica_inputs
  kw = {'stage_mode': 'value', 'shift_mode': 'roll', 'narrow': 'on'}
  st_jax, st_port = _stencils(NARROW_PAIRS, _key({'replication_factor': 3}))
  shape = (40, 64)
  grids = replica_inputs(st_port, shape, 3)
  batch = {n: np.stack([g[n] for g in grids]) for n in st_port.input_names}
  ex = ReplicatedExecutor(st_port, shape, device='cpu', **kw)
  assert ex.inner.plan.layout.narrow16
  got = ex(batch)
  want = JaxReplicatedExecutor(st_jax, shape, **kw)(batch)
  for r in range(3):
    check_outputs(st_port, shape, {o: v[r].numpy() for o, v in got.items()},
                  {o: np.asarray(v)[r] for o, v in want.items()},
                  'narrow replica %d' % r)


@pytest.mark.parametrize('name,shape,opts', [
    ('erosion', (160, 64), {'stage_mode': 'value', 'shift_mode': 'roll',
                            'transpose_lanes': 'on', 'block_rows': 16}),
    ('heat3d', (64, 32, 32), {'stage_mode': 'value', 'shift_mode': 'roll',
                              'block_rows': 4}),
])
def test_sharded_inner_opts_take_layout_keys(name, shape, opts):
  import jax
  import torch
  from jax.sharding import Mesh as JaxMesh
  from soda_tpu.parallel.spmd import ShardedExecutor as JaxShardedExecutor
  from soda_tpu_torch.parallel.spmd import ShardedExecutor
  from soda_tpu_torch.testing import repeated_mesh
  ov = GREEDY if name == 'erosion' else {}
  st_jax, st_port = _stencils(corpus.CORPUS[name], _key(ov))
  inputs = reference.make_test_inputs(st_port, shape)
  ex = ShardedExecutor(st_port, shape, mesh=repeated_mesh('cpu', (4,)),
                       inner='fused', device='cpu', inner_opts=opts)
  assert ex._inner[torch.device('cpu')].plan.layout is not None
  got = {k: v.numpy() for k, v in ex(inputs).items()}
  jex = JaxShardedExecutor(st_jax, shape, mesh=JaxMesh(
      np.array(jax.devices()[:4]), ('x',)), inner='pallas', inner_opts=opts)
  check_outputs(st_port, shape, got,
                {k: np.asarray(v) for k, v in jex(inputs).items()},
                '%s sharded %s' % (name, opts))
