"""The port's replicated executor against the JAX package's.

R independent grids per call, stacked on a leading axis; on the card
they are the fused kernel's second grid axis, so all R run in one
launch. On the CPU each replica runs the kernel's plain version; every
replica must agree with ``ReplicatedExecutor`` of the JAX package
(Pallas in interpret mode) and with the NumPy oracle on its own inputs.
The same kernels as tests/test_replicate.py. With a mesh, the batch
splits over the mesh's first axis (the port's mesh repeats the one CPU
device, the JAX package's uses the conftest's virtual devices); with
``backend='xla'`` the whole-grid executor maps over the replicas.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from soda_tpu import corpus as jax_corpus
from soda_tpu.parallel.replicate import \
    ReplicatedExecutor as JaxReplicatedExecutor
from soda_tpu_torch import corpus, get_executor, utils
from soda_tpu_torch.backend import reference
from soda_tpu_torch.backend.fused import FusedExecutor
from soda_tpu_torch.backend.grouped import GroupedExecutor
from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
from soda_tpu_torch.parallel.mesh import Mesh, Shards
from soda_tpu_torch.parallel.replicate import ReplicatedExecutor
from soda_tpu_torch.testing import check_outputs, replica_inputs

torch.set_num_threads(1)


def _batch(stencil, grids):
  return {n: np.stack([g[n] for g in grids]) for n in stencil.input_names}


def _check_replicas(stencil, shape, got, grids, context, full=False):
  for k, grid in enumerate(grids):
    check_outputs(stencil, shape, {o: v[k] for o, v in got.items()},
                  reference.run(stencil, grid),
                  '%s replica %d' % (context, k), full=full)


@pytest.mark.parametrize('name', ['blur', 'jacobi2d', 'heat3d'])
def test_replicated_matches_jax_and_oracle(name):
  stencil = corpus.build(name, replication_factor=4)
  jax_stencil = jax_corpus.build(name, replication_factor=4)
  shape = corpus.TEST_DIMS[name]
  grids = replica_inputs(stencil, shape, 4)
  ex = ReplicatedExecutor(stencil, shape, device='cpu')
  assert ex.replication_factor == 4
  assert isinstance(ex.inner, FusedExecutor) and ex.inner.replicas == 4
  got = ex(_batch(stencil, grids))
  assert all(tuple(v.shape) == (4,) + shape for v in got.values())
  _check_replicas(stencil, shape, got, grids, name)
  jax_got = JaxReplicatedExecutor(jax_stencil, shape)(_batch(stencil, grids))
  for k in range(4):
    check_outputs(stencil, shape, {o: v[k] for o, v in got.items()},
                  {o: np.asarray(v)[k] for o, v in jax_got.items()},
                  '%s replica %d vs jax' % (name, k))


@pytest.mark.parametrize('factor', [0, -1])
def test_factor_below_one_raises(factor):
  stencil = corpus.build('blur')
  with pytest.raises(utils.InputError, match='>= 1'):
    ReplicatedExecutor(stencil, (40, 64), factor, device='cpu')


def test_too_many_replicas_for_one_launch_raise():
  stencil = corpus.build('blur')
  with pytest.raises(utils.InputError, match='65535'):
    ReplicatedExecutor(stencil, (40, 64), 65536, device='cpu')


def _mesh(shape, names=('x', 'y')):
  n = int(np.prod(shape))
  return Mesh(np.array([torch.device('cpu')] * n,
                       dtype=object).reshape(shape), names[:len(shape)])


def test_mesh_names_its_roadmap_item():
  """``mesh=`` (ROADMAP A9, which it named before it was ported) splits
  the batch over the mesh's first axis, and refuses a batch that axis
  does not divide with the JAX package's message."""
  stencil = corpus.build('blur')
  with pytest.raises(utils.InputError,
                     match="factor 6 not divisible by mesh axis 'x' size 4"):
    ReplicatedExecutor(stencil, (40, 64), 6, device='cpu', mesh=_mesh((4,)))
  ex = ReplicatedExecutor(stencil, (40, 64), 8, device='cpu',
                          mesh=_mesh((4, 2)))
  assert ex.per_device == 2 and ex.inner.replicas == 2


@pytest.mark.parametrize('name,mesh_shape,backend', [
    ('blur', (4,), 'auto'),
    ('jacobi2d', (2, 2), 'auto'),
    ('heat3d', (2,), 'xla'),
])
def test_mesh_matches_jax_and_oracle(name, mesh_shape, backend):
  stencil = corpus.build(name)
  shape = corpus.TEST_DIMS[name]
  grids = replica_inputs(stencil, shape, 4)
  ex = ReplicatedExecutor(stencil, shape, 4, device='cpu', backend=backend,
                          mesh=_mesh(mesh_shape))
  args = ex.prepare(_batch(stencil, grids))
  assert isinstance(args[0], Shards) and args[0].grid == (mesh_shape[0],)
  outs = ex.fn(*args)
  assert all(isinstance(o, Shards) for o in outs)
  got = ex(_batch(stencil, grids))
  assert all(tuple(v.shape) == (4,) + shape for v in got.values())
  _check_replicas(stencil, shape, got, grids, '%s mesh' % name)
  n = int(np.prod(mesh_shape))
  jax_mesh = JaxMesh(np.array(jax.devices()[:n]).reshape(mesh_shape),
                     ('x', 'y')[:len(mesh_shape)])
  jax_got = JaxReplicatedExecutor(jax_corpus.build(name), shape, 4,
                                  backend=backend, mesh=jax_mesh)(
                                      _batch(stencil, grids))
  for k in range(4):
    check_outputs(stencil, shape, {o: v[k] for o, v in got.items()},
                  {o: np.asarray(v)[k] for o, v in jax_got.items()},
                  '%s mesh replica %d vs jax' % (name, k))


def test_xla_backend_maps_the_whole_grid_executor():
  stencil = corpus.build('jacobi2d', border='preserve')
  shape = corpus.TEST_DIMS['jacobi2d']
  grids = replica_inputs(stencil, shape, 3)
  ex = ReplicatedExecutor(stencil, shape, 3, device='cpu', backend='xla')
  assert isinstance(ex.inner, WholeGridExecutor) and ex.launches == 0
  _check_replicas(stencil, shape, ex(_batch(stencil, grids)), grids,
                  'jacobi2d:preserve xla', full=True)
  with pytest.raises(ValueError, match='unknown backend'):
    ReplicatedExecutor(stencil, shape, 3, device='cpu', backend='sharded')


def test_inputs_must_carry_the_batch_axis():
  stencil = corpus.build('blur')
  shape = corpus.TEST_DIMS['blur']
  ex = ReplicatedExecutor(stencil, shape, 2, device='cpu')
  with pytest.raises(utils.InputError, match='batch of 2 grids'):
    ex(reference.make_test_inputs(stencil, shape))


def test_preserve_border_per_replica():
  stencil = corpus.build('jacobi2d', border='preserve')
  shape = corpus.TEST_DIMS['jacobi2d']
  grids = replica_inputs(stencil, shape, 3)
  got = ReplicatedExecutor(stencil, shape, 3, device='cpu')(
      _batch(stencil, grids))
  # each replica's border carries its own input
  _check_replicas(stencil, shape, got, grids, 'jacobi2d:preserve', full=True)


def test_coarse_and_replicated_compose():
  stencil = corpus.build('denoise2d', cluster='coarse')
  shape = corpus.TEST_DIMS['denoise2d']
  grids = replica_inputs(stencil, shape, 2)
  ex = get_executor(stencil, shape, 'replicated', device='cpu',
                    replication_factor=2)
  assert isinstance(ex.inner, GroupedExecutor)
  assert all(sub.replicas == 2 for _, sub in ex.inner.executors)
  _check_replicas(stencil, shape, ex(_batch(stencil, grids)), grids,
                  'denoise2d coarse')


def test_replicas_differ():
  stencil = corpus.build('blur')
  grids = replica_inputs(stencil, corpus.TEST_DIMS['blur'], 3)
  assert not np.array_equal(grids[0]['input'], grids[1]['input'])
  assert not np.array_equal(grids[1]['input'], grids[2]['input'])
