"""The generated CUDA kernel itself, on the card.

Every test here is marked ``gpu`` and skips where no CUDA device
exists. The file imports no jax and nothing of the JAX package, so it also
runs on a GPU machine without them:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest`` because tests/conftest.py configures jax). Each
kernel is built with nvcc, launched through ``FusedExecutor`` and held
against the NumPy oracle: the corpus kernels, tile plans with ragged,
odd and one-cell tiles, an output read by another stage, params,
``border: preserve``, and the semantics fuzz programs (every integer
width, half and double); then ``cluster: coarse`` (one kernel per stage
group), replicated batches (one launch for R grids, and one per entry
of a mesh's first axis), the whole-grid executor, and sharded execution
on meshes that repeat the card (the fused kernel once per halo-extended
shard; overlap 'on' equal to 'off'). Integers bit-exact,
floats within the reference threshold (tests/checks.py).
"""

import numpy as np
import pytest
import torch

from soda_tpu_torch import corpus
from soda_tpu_torch.api import build_stencil
from soda_tpu_torch.backend import reference
from soda_tpu_torch.backend.fused import FusedExecutor
from soda_tpu_torch.backend.grouped import GroupedExecutor
from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
from soda_tpu_torch.parallel.replicate import ReplicatedExecutor
from soda_tpu_torch.parallel.spmd import ShardedExecutor
from soda_tpu_torch.testing import (CONV_PARAM, FUZZ_SEEDS, FUZZ_SHAPE,
                                    GEOMETRY_CASES, MULTI_OUTPUT,
                                    check_outputs, gen_program, make_inputs,
                                    repeated_mesh, replica_inputs)


def _need_gpu():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (the kernel has no CPU build)')


def _run_on_gpu(stencil, shape, inputs, params=None, tile=None):
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (the kernel has no CPU build)')
  ex = FusedExecutor(stencil, shape, device='cuda', tile=tile)
  got = ex(inputs, params)
  torch.cuda.synchronize()
  assert ex.launches == 1
  return {k: v.cpu().numpy() for k, v in got.items()}


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_corpus_kernel_matches_oracle(name):
  stencil = corpus.build(name)
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  got = _run_on_gpu(stencil, shape, inputs, params)
  check_outputs(stencil, shape, got, reference.run(stencil, inputs, params),
                name + ' on gpu')


@pytest.mark.gpu
@pytest.mark.parametrize('name,shape,tile', GEOMETRY_CASES)
def test_kernel_tile_geometry(name, shape, tile):
  stencil = corpus.build(name)
  inputs = reference.make_test_inputs(stencil, shape, seed=7)
  got = _run_on_gpu(stencil, shape, inputs, tile=tile)
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                '%s tile %s on gpu' % (name, tile))


@pytest.mark.gpu
@pytest.mark.parametrize('tile', [None, (4, 8)])
def test_kernel_output_read_by_a_stage(tile):
  stencil = build_stencil(MULTI_OUTPUT)
  shape = (29, 35)
  inputs = reference.make_test_inputs(stencil, shape, seed=3)
  got = _run_on_gpu(stencil, shape, inputs, tile=tile)
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                'multi-output tile %s on gpu' % (tile,))


@pytest.mark.gpu
def test_kernel_params():
  stencil = build_stencil(CONV_PARAM)
  shape = (24, 64)
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  got = _run_on_gpu(stencil, shape, inputs, params, tile=(8, 16))
  check_outputs(stencil, shape, got, reference.run(stencil, inputs, params),
                'param on gpu')


@pytest.mark.gpu
def test_kernel_border_preserve():
  stencil = corpus.build('blur', border='preserve')
  shape = corpus.TEST_DIMS['blur']
  inputs = reference.make_test_inputs(stencil, shape)
  got = _run_on_gpu(stencil, shape, inputs)
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                'blur:preserve on gpu', full=True)


@pytest.mark.gpu
@pytest.mark.parametrize('seed', FUZZ_SEEDS)
def test_fuzz_program_matches_oracle(seed):
  stencil = build_stencil(gen_program(seed))
  inputs = make_inputs(stencil, FUZZ_SHAPE, seed)
  got = _run_on_gpu(stencil, FUZZ_SHAPE, inputs)
  with np.errstate(all='ignore'):
    want = reference.run(stencil, inputs)
  check_outputs(stencil, FUZZ_SHAPE, got, want, 'fuzz%d on gpu' % seed)


@pytest.mark.gpu
@pytest.mark.parametrize('name', ['blur', 'denoise2d', 'heat3d'])
def test_grouped_kernels_match_oracle(name):
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (the kernel has no CPU build)')
  stencil = corpus.build(name, cluster='coarse')
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  ex = GroupedExecutor(stencil, shape, device='cuda')
  got = ex(inputs)
  torch.cuda.synchronize()
  assert ex.launches == len(ex.plan.groups)
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                name + ' coarse on gpu')


@pytest.mark.gpu
@pytest.mark.parametrize('name,border', [('blur', 'ignore'),
                                         ('jacobi2d', 'preserve'),
                                         ('heat3d', 'ignore')])
def test_replicated_kernel_matches_oracle_per_replica(name, border):
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (the kernel has no CPU build)')
  stencil = corpus.build(name, border=border)
  shape = corpus.TEST_DIMS[name]
  grids = replica_inputs(stencil, shape, 3)
  ex = ReplicatedExecutor(stencil, shape, replication_factor=3,
                          device='cuda')
  got = ex({n: np.stack([g[n] for g in grids])
            for n in stencil.input_names})
  torch.cuda.synchronize()
  assert ex.launches == 1
  for k, grid in enumerate(grids):
    check_outputs(stencil, shape, {o: v[k] for o, v in got.items()},
                  reference.run(stencil, grid),
                  '%s replica %d on gpu' % (name, k),
                  full=border == 'preserve')


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_whole_grid_matches_oracle_on_the_card(name):
  _need_gpu()
  stencil = corpus.build(name)
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  ex = WholeGridExecutor(stencil, shape, device='cuda')
  got = ex(inputs, params)
  torch.cuda.synchronize()
  assert all(v.device.type == 'cuda' for v in got.values())
  check_outputs(stencil, shape, got, reference.run(stencil, inputs, params),
                name + ' whole-grid on gpu')


@pytest.mark.gpu
@pytest.mark.parametrize('name,mesh_shape,inner,border', [
    ('blur', (4,), 'fused', 'ignore'),
    ('blur', (2, 2), 'fused', 'preserve'),
    ('heat3d', (2, 2), 'fused', 'ignore'),
    ('denoise2d', (4,), 'grouped', 'ignore'),
    ('jacobi2d', (2, 2), 'xla', 'preserve'),
])
def test_sharded_on_one_card_matches_oracle(name, mesh_shape, inner, border):
  _need_gpu()
  stencil = corpus.build(name, border=border,
                         cluster='coarse' if inner == 'grouped' else 'none')
  shape = corpus.TEST_DIMS[name]
  ex = ShardedExecutor(stencil, shape, inner=inner,
                       mesh=repeated_mesh('cuda', mesh_shape))
  inputs = reference.make_test_inputs(stencil, shape)
  got = ex(inputs)
  torch.cuda.synchronize()
  groups = {'fused': 1, 'grouped': 8, 'xla': 0}[inner]
  assert ex.launches == 4 * groups
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                '%s %s sharded on gpu' % (name, mesh_shape),
                full=border == 'preserve')


@pytest.mark.gpu
def test_overlap_on_the_card_equals_overlap_off():
  _need_gpu()
  stencil = corpus.build('jacobi2d')
  shape = (64, 32)
  inputs = reference.make_test_inputs(stencil, shape)
  outs = [ShardedExecutor(stencil, shape, inner='xla', overlap=overlap,
                          mesh=repeated_mesh('cuda', (4,)))(inputs)['t0']
          for overlap in ('off', 'on')]
  torch.cuda.synchronize()
  assert torch.equal(outs[0], outs[1])
  check_outputs(stencil, shape, {'t0': outs[1]},
                reference.run(stencil, inputs), 'jacobi2d overlap on gpu')


@pytest.mark.gpu
def test_replicated_mesh_launches_once_per_entry():
  _need_gpu()
  stencil = corpus.build('blur')
  shape = corpus.TEST_DIMS['blur']
  grids = replica_inputs(stencil, shape, 8)
  ex = ReplicatedExecutor(stencil, shape, replication_factor=8,
                          mesh=repeated_mesh('cuda', (4,)))
  got = ex({n: np.stack([g[n] for g in grids]) for n in stencil.input_names})
  torch.cuda.synchronize()
  assert ex.launches == 4 and ex.per_device == 2
  for k, grid in enumerate(grids):
    check_outputs(stencil, shape, {o: v[k] for o, v in got.items()},
                  reference.run(stencil, grid),
                  'blur mesh replica %d on gpu' % k)


@pytest.mark.gpu
def test_sync_count_sees_blocking_copies():
  _need_gpu()
  from soda_tpu_torch.profiling import sync_count
  x = torch.zeros(3, device='cuda')
  # the first use also warns that the mode is a prototype: not counted
  assert sync_count(lambda: x + 1) == 0
  assert sync_count(lambda: x.cpu()) == 1
  assert sync_count(lambda: torch.as_tensor(np.float32(2), device='cuda')) == 1


@pytest.mark.gpu
def test_whole_grid_constants_cross_to_the_card_once():
  """A numeric constant becomes a tensor on the card once per process:
  a warm whole-grid call makes the host wait for the card nowhere."""
  _need_gpu()
  from soda_tpu_torch.profiling import sync_count
  stencil = corpus.build('blur')  # divides by 3 in both stages
  shape = corpus.TEST_DIMS['blur']
  ex = WholeGridExecutor(stencil, shape, device='cuda')
  args = ex.prepare(reference.make_test_inputs(stencil, shape))
  ex.fn(*args)
  assert sync_count(lambda: ex.fn(*args)) == 0
