"""The port's sharded executor against the JAX package's.

Every case of tests/test_spmd.py, mirrored: the port runs on a ``Mesh``
that repeats the one CPU device (its form of the JAX tests' virtual
host devices, and how one card holds a 2x2 mesh), the JAX package on
the conftest's 8 virtual CPU devices with the same mesh shape and axis
names. Each side builds its stencil from the same DSL text; inputs are
seeded numpy. Integers bit-exact, floats within the reference threshold
(tests/checks.py), against ``soda_tpu.parallel.spmd.ShardedExecutor``
(its 'pallas' inner in interpret mode) and against the NumPy oracle.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import soda_tpu
from soda_tpu import corpus as jax_corpus
from soda_tpu.parallel.spmd import ShardedExecutor as JaxShardedExecutor
from soda_tpu_torch import api, corpus, get_executor, utils
from soda_tpu_torch.backend import reference
from soda_tpu_torch.parallel import mesh as mesh_mod
from soda_tpu_torch.parallel import spmd
from soda_tpu_torch.parallel.mesh import Mesh, Replicated, Shards
from soda_tpu_torch.parallel.spmd import ShardedExecutor
from soda_tpu_torch.testing import check_outputs

torch.set_num_threads(1)

CPU = torch.device('cpu')


def _mesh(shape=(8,), names=('x',)):
  n = int(np.prod(shape))
  return Mesh(np.array([CPU] * n, dtype=object).reshape(shape), names)


def _jax_mesh(shape=(8,), names=('x',)):
  n = int(np.prod(shape))
  return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names)


def check_sharded(name, shape, inner='xla', mesh_shape=(8,), names=('x',),
                  inner_opts=None, jax_inner_opts=None, overlap='off',
                  dim_axes=None, **overrides):
  """The port's sharded run against the oracle and the JAX package's."""
  stencil = corpus.build(name, **overrides)
  jax_stencil = jax_corpus.build(name, **overrides)
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  ex = ShardedExecutor(stencil, shape, mesh=_mesh(mesh_shape, names),
                       inner=inner, device='cpu', dim_axes=dim_axes,
                       inner_opts=inner_opts, overlap=overlap)
  got = ex(inputs, params)
  assert all(tuple(v.shape) == shape for v in got.values())
  jex = JaxShardedExecutor(
      jax_stencil, shape, mesh=_jax_mesh(mesh_shape, names),
      inner='pallas' if inner == 'fused' else inner, dim_axes=dim_axes,
      inner_opts=jax_inner_opts, overlap=overlap)
  want_jax = {k: np.asarray(v) for k, v in jex(inputs, params).items()}
  full = stencil.preserve_border  # preserve defines every cell
  check_outputs(stencil, shape, got, reference.run(stencil, inputs, params),
                name, full=full)
  check_outputs(stencil, shape, got, want_jax, name + ' vs jax', full=full)
  return ex


def test_eight_devices_available():
  mesh = _mesh((2, 4), ('x', 'y'))
  assert mesh.size == 8 == len(jax.devices())
  assert list(mesh.shape.items()) == [('x', 2), ('y', 4)]
  assert dict(mesh.shape) == dict(_jax_mesh((2, 4), ('x', 'y')).shape)
  assert mesh_mod.visible_devices('cpu') == [CPU]


@pytest.mark.parametrize('name,shape', [
    ('blur', (80, 64)),
    ('jacobi2d', (64, 32)),
    ('sobel2d', (64, 32)),
    ('erosion', (160, 64)),     # 19-tap halo: 9 rows each way
    ('heat3d', (64, 32, 32)),   # 3-D, iterate=2
])
def test_sharded_matches_oracle(name, shape):
  check_sharded(name, shape)


def test_sharded_fused_inner():
  # each shard runs the fused kernel (its plain version on the CPU)
  ex = check_sharded('jacobi2d', (64, 32), inner='fused')
  assert ex.inner == 'fused' and ex.ext_shape == (8 + 2 + 2, 32)
  assert ex.launches == 0  # only a kernel launch counts


def test_sharded_fused_inner_opts():
  # the single-chip tile applies per shard through inner_opts; the JAX
  # side takes its own tuned config, as tests/test_spmd.py does
  ex = check_sharded('jacobi2d', (128, 32), inner='fused',
                     inner_opts={'tile': (8, 16)},
                     jax_inner_opts={'block_rows': 8, 'stage_mode': 'value',
                                     'shift_mode': 'roll'})
  assert ex._inner[CPU].plan.tile == (8, 16)
  check_sharded('blur', (160, 64), inner='fused', inner_opts={'tile': (4, 32)},
                jax_inner_opts={'block_rows': 8, 'stream_loop': 'peel'})


@pytest.mark.parametrize('name,shape', [('jacobi2d', (81, 64)),
                                        ('blur', (73, 64))])
def test_indivisible_extent_pads_and_crops(name, shape):
  # 81 rows over 8 devices: padded to 88, cropped back
  ex = check_sharded(name, shape)
  assert ex.padded_shape[0] % 8 == 0 and ex.padded_shape[0] > shape[0]


@pytest.mark.parametrize('inner', ['xla', 'fused'])
def test_indivisible_2d_mesh(inner):
  ex = check_sharded('jacobi2d', (67, 61), inner=inner, mesh_shape=(4, 2),
                     names=('x', 'y'))
  assert ex.padded_shape == (68, 62)


@pytest.mark.parametrize('inner', ['xla', 'fused'])
def test_sharded_preserve_border(inner):
  """border: preserve under sharding uses the GLOBAL boundary: shard
  seam cells are interior and carry computed values."""
  check_sharded('jacobi2d', (64, 32), inner=inner, border='preserve')


@pytest.mark.parametrize('inner', ['xla', 'fused'])
def test_sharded_preserve_border_2d_mesh_int(inner):
  check_sharded('blur', (72, 64), inner=inner, mesh_shape=(2, 4),
                names=('x', 'y'), border='preserve')


@pytest.mark.parametrize('name,shape', [
    ('jacobi2d', (64, 64)),       # iterate=2: halo 2 each way
    ('seidel2d', (64, 64)),       # diagonal taps need corner halos
    ('sobel2d', (64, 64)),
])
def test_2d_mesh_matches_oracle(name, shape):
  check_sharded(name, shape, mesh_shape=(4, 2), names=('x', 'y'))


@pytest.mark.parametrize('inner', ['xla', 'fused'])
def test_2d_mesh_3d_grid(inner):
  check_sharded('heat3d', (32, 64, 32), inner=inner, mesh_shape=(2, 4),
                names=('x', 'y'))


def test_sharded_inner_auto():
  ex = check_sharded('jacobi2d', (64, 32), inner='auto')
  assert ex.inner == 'fused'  # the tile plan of the shard fits


def test_sharded_inner_auto_raises_where_the_plan_does_not_fit():
  """'auto' (and the default) is the fused kernel per shard: where the
  tile plan for the extended shard does not fit shared memory it raises
  before any build; the whole-grid inner runs only when named."""
  # one tap 150 cells away: even a one-cell tile's input needs 301 x
  # 301 x 4 bytes of shared memory, more than a block may use
  stencil = api.build_stencil(_FAR_TAP)
  shape = (320, 320)
  for inner in ('auto', 'fused'):
    with pytest.raises(utils.InputError, match='shared memory'):
      ShardedExecutor(stencil, shape, mesh=_mesh((2,)), inner=inner,
                      device='cpu')
  ex = ShardedExecutor(stencil, shape, mesh=_mesh((2,)), inner='xla',
                       device='cpu')
  assert ex.inner == 'xla' and ex.launches == 0
  inputs = reference.make_test_inputs(stencil, shape)
  check_outputs(stencil, shape, ex(inputs), reference.run(stencil, inputs),
                'far tap xla inner')


_FAR_TAP = '\n'.join([
    'kernel: far', 'burst width: 64', 'unroll factor: 1', 'iterate: 1',
    'border: ignore', 'cluster: none', 'input dram 0 float: x(320, *)',
    'output dram 1 float: y(0, 0) = x(-150, -150) + x(150, 150)'])


def test_sharded_grouped_inner():
  # one fused kernel per stage group inside each shard
  ex = check_sharded('denoise2d', (48, 32), inner='grouped',
                     mesh_shape=(4,), cluster='coarse')
  assert len(ex._inner[CPU].executors) == 8


def test_chained_multi_step():
  """chained: N applications, outputs (Shards) feeding inputs, on both
  single-device and sharded executors, against the JAX package's."""
  stencil = corpus.build('jacobi2d')  # iterate=2 per application
  jax_stencil = jax_corpus.build('jacobi2d')
  shape = (64, 32)
  inputs = reference.make_test_inputs(stencil, shape)
  want = dict(inputs)
  for _ in range(3):
    want = {'t1': reference.run(stencil, want)['t0']}
  jex = JaxShardedExecutor(jax_stencil, shape, mesh=_jax_mesh())
  (want_jax,) = soda_tpu.chained(jex, 3)(*jex.prepare(inputs))
  # after 3 chained runs the garbage border has eaten 3 * halo cells
  lo = 3 * 2
  region = (slice(lo, shape[0] - lo), slice(lo, shape[1] - lo))
  for ex in (get_executor(stencil, shape, device='cpu'),
             ShardedExecutor(stencil, shape, mesh=_mesh(), device='cpu'),
             ShardedExecutor(stencil, shape, mesh=_mesh(), device='cpu',
                             inner='xla')):
    (got,) = api.chained(ex, 3)(*ex.prepare(inputs))
    if isinstance(got, Shards):
      got = got.gather()
    for ref, what in ((want['t1'], 'oracle'), (np.asarray(want_jax), 'jax')):
      check_outputs(stencil, shape, {'t0': got.numpy()[region]},
                    {'t0': ref[region]}, 'chained vs %s' % what, full=True)


def test_chained_rejects_unchainable():
  stencil = corpus.build('sobel2d')  # int16 in, uint16 out
  ex = ShardedExecutor(stencil, (64, 32), mesh=_mesh(), device='cpu')
  with pytest.raises(utils.InputError):
    api.chained(ex, 2)


_BANKED = '\n'.join([
    'kernel: banked', 'burst width: 64', 'unroll factor: 1', 'iterate: 1',
    'border: ignore', 'cluster: none', 'input dram 0.1.2.3 uint16: x(64, *)',
    'output dram 0.1.2.3 uint16: y(0, 0) = '
    '(x(-1, 0) + x(0, 0) + x(1, 0)) / 3'])


def test_dram_banks_pick_default_mesh_width(monkeypatch):
  """DSL `dram` banks choose the default shard count, capped at the
  visible devices (here eight, patched in)."""
  monkeypatch.setattr(spmd, 'visible_devices', lambda kind: [CPU] * 8)
  stencil = api.build_stencil(_BANKED)
  shape = (64, 64)
  ex = ShardedExecutor(stencil, shape, device='cpu')
  assert ex.mesh.devices.size == 4  # 4 declared banks -> 4 shards
  jex = JaxShardedExecutor(soda_tpu.build_stencil(_BANKED), shape)
  assert jex.mesh.devices.size == 4
  inputs = reference.make_test_inputs(stencil, shape)
  check_outputs(stencil, shape, ex(inputs), reference.run(stencil, inputs),
                'banked')
  check_outputs(stencil, shape, ex(inputs),
                {k: np.asarray(v) for k, v in jex(inputs).items()},
                'banked vs jax')
  # single-bank (default) stencils keep using every device
  assert ShardedExecutor(corpus.build('blur'), (80, 64),
                         device='cpu').mesh.devices.size == 8
  monkeypatch.setattr(spmd, 'visible_devices', lambda kind: [CPU] * 2)
  assert ShardedExecutor(stencil, shape, device='cpu').mesh.devices.size == 2


def test_default_mesh_is_the_visible_devices():
  ex = get_executor(corpus.build('blur'), (40, 64), 'sharded', device='cpu')
  assert isinstance(ex, ShardedExecutor) and ex.mesh.size == 1
  # the port's default inner is the kernel (the JAX package's: 'xla')
  assert ex.inner == 'fused' and ex.device == CPU


@pytest.mark.parametrize('name,shape,mesh_shape,names,dim_axes', [
    # one array axis over the flattened ('slice', 'x') ring
    ('jacobi2d', (64, 32), (2, 4), ('slice', 'x'), [('slice', 'x')]),
    # streaming axis over ('slice', 'x') and the lane axis over 'y'
    ('blur', (64, 64), (2, 2, 2), ('slice', 'x', 'y'), [('slice', 'x'), 'y']),
], ids=['flattened-ring', '2d-decomposition'])
def test_multislice_dim_axes(name, shape, mesh_shape, names, dim_axes):
  ex = check_sharded(name, shape, mesh_shape=mesh_shape, names=names,
                     dim_axes=dim_axes)
  assert ex.devices.shape == ((8,) if len(dim_axes) == 1 else (4, 2))


def test_dim_axes_validation():
  stencil = corpus.build('jacobi2d')
  mesh = _mesh((2, 4), ('slice', 'x'))
  with pytest.raises(utils.InputError, match='unknown mesh axis'):
    ShardedExecutor(stencil, (64, 32), mesh=mesh, dim_axes=['nope'])
  with pytest.raises(utils.InputError, match='used twice'):
    ShardedExecutor(stencil, (64, 32), mesh=mesh,
                    dim_axes=[('slice', 'slice')])
  with pytest.raises(utils.InputError, match='1 or 2 array axes'):
    ShardedExecutor(corpus.build('heat3d'), (32, 32, 32),
                    mesh=_mesh((2, 2, 2), ('a', 'b', 'c')))
  with pytest.raises(utils.InputError, match='exceeds local extent'):
    ShardedExecutor(corpus.build('erosion'), (64, 64), mesh=_mesh())
  with pytest.raises(ValueError, match='unknown inner'):
    ShardedExecutor(stencil, (64, 32), mesh=mesh, inner='nope')


def test_inner_opts_may_name_layer_owned_keys():
  """apply_preserve_border in inner_opts belongs to the sharded layer
  and must not collide with its own keyword (a TypeError otherwise)."""
  check_sharded('blur', (64, 64), inner='fused',
                inner_opts={'tile': (16, 32), 'apply_preserve_border': True},
                jax_inner_opts={'interpret': True, 'block_rows': 16,
                                'apply_preserve_border': True})
  with pytest.raises(utils.InputError, match='no inner_opts'):
    ShardedExecutor(corpus.build('blur'), (64, 64), mesh=_mesh(),
                    inner='xla', inner_opts={'tile': (8, 8)})


@pytest.mark.parametrize('name,shape', [
    ('jacobi2d', (64, 32)),    # iterate=2: two sweeps on one exchange
    ('blur', (80, 64)),        # int multi-stage
    ('sobel2d', (64, 32)),     # mixed int widths
    ('erosion', (320, 64)),    # 19-tap halo: 9 rows each way
])
def test_sharded_overlap_matches_oracle(name, shape):
  check_sharded(name, shape, overlap='on')


def test_overlap_preserve_border():
  check_sharded('jacobi2d', (64, 32), overlap='on', border='preserve')


def test_overlap_validation():
  stencil = corpus.build('jacobi2d')
  with pytest.raises(utils.InputError, match='xla inner'):
    ShardedExecutor(stencil, (64, 32), mesh=_mesh(), inner='fused',
                    overlap='on')
  with pytest.raises(utils.InputError, match='xla inner'):
    ShardedExecutor(stencil, (64, 32), mesh=_mesh((4, 2), ('x', 'y')),
                    overlap='on')
  # erosion halo is 9+9=18 rows; 80/8 = 10-row shards can't band it
  with pytest.raises(utils.InputError, match='total halo'):
    ShardedExecutor(corpus.build('erosion'), (80, 64), mesh=_mesh(),
                    inner='xla', overlap='on')
  with pytest.raises(utils.InputError, match="'off' or 'on'"):
    ShardedExecutor(stencil, (64, 32), mesh=_mesh(), overlap='maybe')


@pytest.mark.parametrize('name,shape,border', [
    ('jacobi2d', (64, 32), 'ignore'),
    ('erosion', (320, 64), 'ignore'),
    ('blur', (80, 64), 'preserve'),
])
def test_overlap_on_equals_overlap_off(name, shape, border):
  """overlap='on' is the JAX package's name for an exchange that is
  here the same as 'off': the outputs are bit for bit the same."""
  stencil = corpus.build(name, border=border)
  inputs = reference.make_test_inputs(stencil, shape)
  on, off = (ShardedExecutor(stencil, shape, mesh=_mesh(), device='cpu',
                             inner='xla', overlap=overlap)(inputs)
             for overlap in ('on', 'off'))
  assert all(torch.equal(on[k], off[k]) for k in off)


def _count_permutes(monkeypatch):
  count = [0]
  real = spmd._permute

  def counting(*args, **kwargs):
    count[0] += 1
    return real(*args, **kwargs)

  monkeypatch.setattr(spmd, '_permute', counting)
  return count


@pytest.mark.parametrize('name,mesh_shape,overlap,want', [
    # jacobi2d: 1 input, iterate=2 (two sweeps), 1-D mesh -> one lo and
    # one hi exchange; the second sweep adds none
    ('jacobi2d', (8,), 'off', 2),
    ('jacobi2d', (8,), 'on', 2),
    # seidel2d on a 2-D mesh: the two-phase exchange carries the
    # corners: one pair per axis, no extra corner exchange
    ('seidel2d', (4, 2), 'off', 4),
    # sobel2d: a multi-stage pipeline, still one input -> one pair
    ('sobel2d', (8,), 'off', 2),
    # denoise2d: two inputs -> a pair each
    ('denoise2d', (4,), 'off', 4),
])
def test_one_exchange_per_input_axis(monkeypatch, name, mesh_shape, overlap,
                                     want):
  stencil = corpus.build(name)
  shape = (64, 32)
  ex = ShardedExecutor(stencil, shape, device='cpu', overlap=overlap,
                       inner='xla' if overlap == 'on' else 'fused',
                       mesh=_mesh(mesh_shape, ('x', 'y')[:len(mesh_shape)]))
  args = ex.prepare(reference.make_test_inputs(stencil, shape),
                    reference.make_test_params(stencil))
  count = _count_permutes(monkeypatch)
  ex.fn(*args)
  assert count[0] == want


def test_fn_takes_and_returns_shards():
  stencil = corpus.build('blur')
  shape = (73, 64)
  ex = ShardedExecutor(stencil, shape, mesh=_mesh((4, 2), ('x', 'y')),
                       device='cpu', inner='fused')
  args = ex.prepare(reference.make_test_inputs(stencil, shape))
  assert isinstance(args[0], Shards) and args[0].grid == (4, 2)
  assert args[0].shape == ex.padded_shape == (76, 64)
  (out,) = ex.fn(*args)
  assert isinstance(out, Shards) and out.shape == ex.padded_shape
  assert all(t.is_contiguous() and tuple(t.shape) == ex.local_shape
             for t in out.tensors.flat)
  assert out.gather().dtype == torch.uint16
  with pytest.raises(utils.InputError, match='Shards'):
    ex.fn(out.gather())
  with pytest.raises(utils.InputError, match='expected 1 inputs'):
    ex.fn(*args, *args)


def test_params_are_replicated_per_device():
  stencil = api.build_stencil(_CONV)
  shape = (64, 64)
  ex = ShardedExecutor(stencil, shape, mesh=_mesh((4,)), device='cpu',
                       inner='fused')
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  args = ex.prepare(inputs, params)
  assert isinstance(args[1], Replicated) and list(args[1].copies) == [CPU]
  check_outputs(stencil, shape, ex(inputs, params),
                reference.run(stencil, inputs, params), 'param sharded')


_CONV = '\n'.join([
    'kernel: wconv', 'burst width: 64', 'unroll factor: 1', 'iterate: 1',
    'border: ignore', 'cluster: none',
    'param float, partition complete: w[3][3]',
    'input dram 0 float: img(64, *)',
    'output dram 1 float: out(0, 0) = img(-1, -1) * w(0, 0) + '
    'img(0, 0) * w(1, 1) + img(1, 1) * w(2, 2)'])


def test_cuda_without_a_gpu_raises():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device exists here')
  with pytest.raises(utils.InputError, match='no CUDA device'):
    ShardedExecutor(corpus.build('blur'), (40, 64))
