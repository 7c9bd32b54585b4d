"""The sharded executor's rank form against the JAX package's.

Four gloo ranks on the CPU (``launch.spawn``; one world for every case,
through a module-scoped fixture) run the rank form,
``soda_tpu_torch.parallel.distributed.DistributedShardedExecutor``; the
ranks import only the port. This process holds their gathered outputs
against ``soda_tpu.parallel.spmd.ShardedExecutor`` on 4 of the
conftest's 8 virtual CPU devices (same mesh shape, axis names,
``dim_axes``, inner, ``inner_opts`` and overlap; Pallas in interpret
mode), against the port's single-controller ``ShardedExecutor`` on a
mesh that repeats the CPU (bit for bit) and against the NumPy oracle.
Floats within 1e-4, integers bit-exact (the JAX dryrun's rule).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import soda_tpu
from soda_tpu import corpus as jax_corpus
from soda_tpu.parallel.spmd import ShardedExecutor as JaxShardedExecutor
from soda_tpu_torch import corpus, get_executor, utils
from soda_tpu_torch.backend import reference
from soda_tpu_torch.parallel import dryrun, launch
from soda_tpu_torch.parallel.dryrun import Case
from soda_tpu_torch.parallel.mesh import Mesh
from soda_tpu_torch.parallel.spmd import ShardedExecutor

torch.set_num_threads(1)

N = 4
CPU = torch.device('cpu')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NINE = dryrun.configs(N)

# (cell, shape, border): overlap 'on' against 'off'
OVERLAP = (('jacobi2d', (64, 32), 'ignore'), ('erosion', (320, 64), 'ignore'),
           ('blur', (80, 64), 'preserve'))
# (cell, mesh shape, overlap, batches a call per rank): one P2P batch per
# input per sharded axis
BATCHES = (
    ('jacobi2d', (4,), 'off', 1),   # iterate=2: the second sweep adds none
    ('jacobi2d', (4,), 'on', 1),
    ('seidel2d', (2, 2), 'off', 2),  # two phases carry the corners
    ('sobel2d', (4,), 'off', 1),    # a multi-stage pipeline, one input
    ('denoise2d', (4,), 'off', 2),  # two inputs
)
CHAINED = ('fused', 'xla')
# (label, case arguments, message): constructors that must raise
ERRORS = (
    ('mesh of 2 in a world of 4', dict(mesh_shape=(2,)), 'needs 2 ranks'),
    ('mesh of 8 in a world of 4', dict(mesh_shape=(8,)), 'needs 8 ranks'),
    ('overlap with the fused inner', dict(overlap='on'), 'xla inner'),
    ('overlap on a 2-D mesh', dict(mesh_shape=(2, 2), inner='xla',
                                   overlap='on'), 'xla inner'),
    ('overlap on bands wider than a shard',
     dict(name='erosion', shape=(64, 64), inner='xla', overlap='on'),
     'total halo'),
    ('overlap maybe', dict(overlap='maybe'), "'off' or 'on'"),
    ('a mesh axis that shards nothing',
     dict(mesh_shape=(4, 1), axis_names=('x', 'y'), dim_axes=['x']),
     'shard no array axis'),
)


def _case(label, name='jacobi2d', shape=(64, 32), mesh_shape=(4,),
          border='ignore', **kwargs):
  return Case(label, corpus.build(name, border=border), shape, mesh_shape,
              **kwargs)


def _cases():
  cases = list(NINE)
  for name, shape, border in OVERLAP:
    for overlap in ('off', 'on'):
      cases.append(_case('overlap %s %s' % (overlap, name), name, shape,
                         border=border, inner='xla', overlap=overlap))
  cases.append(_case('order', inner='xla', overlap='on', trace=True))
  for name, mesh_shape, overlap, _ in BATCHES:
    cases.append(_case('batches %s %s %s' % (name, mesh_shape, overlap),
                       name, mesh_shape=mesh_shape, overlap=overlap,
                       inner='xla' if overlap == 'on' else 'fused'))
  cases += [_case('chained %s' % inner, inner=inner, steps=3)
            for inner in CHAINED]
  cases += [_case(label, raises=True, **kwargs)
            for label, kwargs, _ in ERRORS]
  return cases


@pytest.fixture(scope='module')
def world():
  """label -> (case, one result per rank), from one world of 4 ranks."""
  cases = _cases()
  ranks = dryrun.collect_world(cases, N, 'gloo', 'cpu')
  return {case.label: (case, [r[i] for r in ranks])
          for i, case in enumerate(cases)}


def _mesh(case):
  names = case.axis_names or ('x', 'y')[:len(case.mesh_shape)]
  n = int(np.prod(case.mesh_shape))
  devices = np.empty(n, dtype=object)
  devices[:] = [CPU] * n
  return Mesh(devices.reshape(case.mesh_shape), names)


def _jax_mesh(case):
  names = case.axis_names or ('x', 'y')[:len(case.mesh_shape)]
  n = int(np.prod(case.mesh_shape))
  return JaxMesh(np.array(jax.devices()[:n]).reshape(case.mesh_shape), names)


def _jax_stencil(stencil):
  return jax_corpus.build(stencil.app_name, border=stencil.border)


def _single(case):
  """The single-controller form of ``case`` on a mesh repeating the CPU."""
  ex = ShardedExecutor(case.stencil, case.shape, mesh=_mesh(case),
                       inner=case.inner, device='cpu', dim_axes=case.dim_axes,
                       inner_opts=case.inner_opts, overlap=case.overlap)
  inputs, params = dryrun.inputs_of(case)
  return {k: v.numpy() for k, v in ex(inputs, params).items()}


def _outputs(world, label):
  case, results = world[label]
  got = results[0]['outputs']
  assert all(got[name].shape == case.shape
             for name in case.stencil.output_names)
  return case, got


@pytest.mark.parametrize('label', [c.label for c in NINE])
def test_nine_configs_match_jax(world, label):
  case, got = _outputs(world, label)
  inputs, params = dryrun.inputs_of(case)
  jex = JaxShardedExecutor(
      _jax_stencil(case.stencil), case.shape, mesh=_jax_mesh(case),
      inner='pallas' if case.inner == 'fused' else case.inner,
      dim_axes=case.dim_axes, inner_opts=case.inner_opts,
      overlap=case.overlap)
  want = {k: np.asarray(v) for k, v in jex(inputs, params).items()}
  dryrun.check(case, got, want)
  dryrun.check(case, got, reference.run(case.stencil, inputs, params))


@pytest.mark.parametrize('label', [c.label for c in NINE])
def test_nine_configs_equal_the_single_controller_form(world, label):
  case, got = _outputs(world, label)
  want = _single(case)
  for name in case.stencil.output_names:
    np.testing.assert_array_equal(got[name], want[name], err_msg=label)


@pytest.mark.parametrize('name,shape,border', OVERLAP)
def test_overlap_on_equals_off(world, name, shape, border):
  _, on = _outputs(world, 'overlap on %s' % name)
  case, off = _outputs(world, 'overlap off %s' % name)
  for out in case.stencil.output_names:
    np.testing.assert_array_equal(on[out], off[out])
  want = _single(case)
  for out in case.stencil.output_names:
    np.testing.assert_array_equal(off[out], want[out])


def test_overlapped_step_posts_before_the_interior_and_waits_after(world):
  """The counterpart of tests/test_spmd.py:317: the P2P batch is posted
  before the interior's call (the local shard, 16 rows) and waited on
  after it; the two edge bands (lo + lo + hi = 6 rows) come last."""
  _, results = world['order']
  for rank, result in enumerate(results):
    log = result['order']
    interior = log.index('inner 16')
    assert log[:interior] == ['post'], (rank, log)
    waits = log[interior + 1:-2]
    assert waits and set(waits) == {'wait'}, (rank, log)
    assert log[-2:] == ['inner 6', 'inner 6'], (rank, log)


@pytest.mark.parametrize('name,mesh_shape,overlap,want', BATCHES)
def test_one_batch_per_input_per_axis(world, name, mesh_shape, overlap,
                                      want):
  case, results = world['batches %s %s %s' % (name, mesh_shape, overlap)]
  inputs, params = dryrun.inputs_of(case)
  dryrun.check(case, results[0]['outputs'],
               reference.run(case.stencil, inputs, params))
  assert [r['exchanges'] for r in results] == [want] * N


@pytest.mark.parametrize('inner', CHAINED)
def test_chained_matches_jax(world, inner):
  """chained(ex, 3): one exchange a step, outputs fed back on each rank,
  against the JAX package's chained sharded run and the oracle."""
  case, got = _outputs(world, 'chained %s' % inner)
  shape = case.shape
  inputs, _ = dryrun.inputs_of(case)
  want = dict(inputs)
  for _ in range(3):
    want = {'t1': reference.run(case.stencil, want)['t0']}
  jex = JaxShardedExecutor(_jax_stencil(case.stencil), shape,
                           mesh=_jax_mesh(case))
  (want_jax,) = soda_tpu.chained(jex, 3)(*jex.prepare(inputs))
  lo = 3 * 2  # three runs of a halo of 2 eat the border
  region = (slice(lo, shape[0] - lo), slice(lo, shape[1] - lo))
  for ref in (want['t1'], np.asarray(want_jax)):
    np.testing.assert_allclose(got['t0'][region], ref[region],
                               rtol=dryrun.TOLERANCE, atol=dryrun.TOLERANCE)
  assert [r['exchanges'] for r in world['chained %s' % inner][1]] == [3] * N


@pytest.mark.parametrize('label,kwargs,message', ERRORS,
                         ids=[e[0] for e in ERRORS])
def test_input_errors(world, label, kwargs, message):
  _, results = world[label]
  for result in results:
    assert result['error'] is not None and message in result['error'], (
        label, result)


def test_ranks_run_the_port_alone(world):
  """Every rank checked that neither jax nor the JAX package is loaded;
  here, where both are, the check raises."""
  _, results = world['sobel2d fused']
  assert all('gloo' in r['repr'] and 'as they lie' in r['repr']
             for r in results)
  assert [r['launches'] for r in results] == [0] * N  # plain on the CPU
  with pytest.raises(RuntimeError, match='loaded jax'):
    launch.no_jax_loaded()


def test_a_failing_rank_fails_spawn():
  bad = _case('bad mesh', mesh_shape=(2,))
  with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                     match='needs 2 ranks'):
    dryrun.collect_world([bad], N, 'gloo', 'cpu')


def test_get_executor_takes_the_rank_form_given_a_group(world):
  """``mesh_shape`` (a shape of ranks) asks for the rank form, which
  needs a process group; without it, or with None, the single-controller
  form. The ranks built every case through ``get_executor``."""
  stencil = corpus.build('blur')
  with pytest.raises(utils.InputError, match='process group'):
    get_executor(stencil, (64, 64), 'sharded', mesh_shape=(4,), device='cpu')
  for kwargs in ({}, {'mesh_shape': None}):
    assert isinstance(get_executor(stencil, (64, 64), 'sharded', device='cpu',
                                   **kwargs), ShardedExecutor)
  _, results = world['sobel2d fused']
  assert all(r['repr'].startswith('DistributedShardedExecutor(rank %d of 4'
                                  % rank) for rank, r in enumerate(results))


def _run(args):
  proc = subprocess.run([sys.executable, *args], cwd=REPO, timeout=600,
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True)
  assert proc.returncode == 0, proc.stdout[-4000:]
  return proc.stdout


def test_dryrun_command_line():
  out = _run(['-m', 'soda_tpu_torch.parallel.dryrun', '--nproc', '4',
              '--backend', 'gloo', '--device', 'cpu'])
  assert 'dryrun_multichip OK on 4 ranks' in out


def test_dryrun_under_torchrun():
  out = _run(['-m', 'torch.distributed.run', '--standalone',
              '--nproc-per-node', '2', '-m', 'soda_tpu_torch.parallel.dryrun',
              '--backend', 'gloo', '--device', 'cpu'])
  assert 'dryrun_multichip OK on 2 ranks' in out


def test_kernel_sources_are_the_kernel_inners():
  """The sources a card run builds ahead of the ranks: one a fused
  config, one a group for 'grouped', none for 'xla' or a case that
  raises; the same as the ranks' executors would generate."""
  from soda_tpu_torch.backend import cuda_source
  from soda_tpu_torch.backend.tile_plan import kernel_plan
  sources = dryrun.kernel_sources(NINE + [_case('raises', raises=True)])
  kernels = [c for c in NINE if c.inner != 'xla']
  assert [c.label for c in kernels] == [
      'sobel2d fused', 'blur fused, tuned options',
      'jacobi3d fused, mid tiles', 'sobel2d grouped']
  assert len(sources) == len(kernels)
  blur = kernels[1]
  ext = (16 + 2, 32)  # 64 rows over 4 ranks, blur's halo of 2 below
  assert sources[1].digest == cuda_source.generate(
      kernel_plan(blur.stencil, ext, **blur.inner_opts)).digest
