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
shard; overlap 'on' equal to 'off'); the kernel's modes (streaming
loop, cp.async ring, split fills, staged stores) against their plain
version and the oracle, compiled statistics read from the card, and the
tuner end to end. Integers bit-exact, floats within the reference
threshold (tests/checks.py).
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
                                    GEOMETRY_CASES, MODE_CASES, MULTI_OUTPUT,
                                    check_outputs, gen_program, make_inputs,
                                    mode_inputs, mode_stencil, repeated_mesh,
                                    replica_inputs)


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


@pytest.mark.gpu
@pytest.mark.parametrize('case', MODE_CASES,
                         ids=['%s-%s-%s' % (c[0], 'x'.join(map(str, c[1])),
                                            '-'.join('%s=%s' % kv for kv in
                                                     sorted(c[2].items())))
                              for c in MODE_CASES])
def test_mode_kernel_matches_its_plain_version(case, monkeypatch):
  """Each mode kernel on the card: one launch, equal to its plain
  version (``streamed_stencil_plain``, run on the card) and to the
  NumPy oracle."""
  _need_gpu()
  from soda_tpu_torch.backend import tile_plan
  from soda_tpu_torch.backend.fused import streamed_stencil_plain
  name, shape, opts, min_ctas, reps = case
  monkeypatch.setattr(tile_plan, 'MIN_CTAS', min_ctas)
  stencil = mode_stencil(name)
  ex = FusedExecutor(stencil, shape, device='cuda',
                     replicas=None if reps == 1 else reps, **opts)
  grids = mode_inputs(stencil, name, shape, reps)
  params = reference.make_test_params(stencil)
  batch = (grids[0] if reps == 1 else
           {n: np.stack([g[n] for g in grids]) for n in stencil.input_names})
  args = ex.prepare(batch, params)
  outs = ex.fn(*args)
  torch.cuda.synchronize()
  assert ex.launches == 1
  n_in = len(stencil.input_names)
  for r, grid in enumerate(grids):
    pick = (lambda t: t) if reps == 1 else (lambda t, r=r: t[r])
    got = {o: pick(v) for o, v in zip(stencil.output_names, outs)}
    plain = streamed_stencil_plain(stencil, [pick(a) for a in args[:n_in]],
                                   args[n_in:], tile=ex.plan)
    check_outputs(stencil, shape, got, dict(zip(stencil.output_names, plain)),
                  '%s %s vs plain on gpu' % (name, opts))
    with np.errstate(all='ignore'):
      want = reference.run(stencil, grid, params)
    check_outputs(stencil, shape, got, want, '%s %s on gpu' % (name, opts))


@pytest.mark.gpu
@pytest.mark.parametrize('name,cluster,opts', [
    ('blur', None, {}),
    ('blur', None, {'stream_loop': 'peel'}),
    ('denoise2d', 'coarse', {'out_dma': True}),
])
def test_compiled_stats_reads_the_card(name, cluster, opts):
  _need_gpu()
  from soda_tpu_torch.backend import get_executor
  from soda_tpu_torch.model.compiled import CARD_FIELDS, compiled_stats
  overrides = {'cluster': cluster} if cluster else {}
  stencil = corpus.build(name, **overrides)
  ex = get_executor(stencil, (1024, 2048), device='cuda', **opts)
  stats = compiled_stats(ex)
  assert stats['card'] == torch.cuda.get_device_name(0)
  groups = len(ex.executors) if cluster else 1
  assert len(stats['kernels']) == groups
  for kernel in stats['kernels']:
    assert all(kernel[field] is not None for field in CARD_FIELDS), kernel
    assert kernel['registers'] == kernel['registers_ptxas'] > 0
    assert kernel['ctas_per_sm'] >= 1
    assert kernel['smem_dynamic'] == kernel['smem_plan_bytes']


@pytest.mark.gpu
def test_tune_on_the_card(tmp_path, monkeypatch):
  """tune probes every candidate on the card, caches the fastest, and a
  second call probes nothing; tuned_executor runs the winner."""
  _need_gpu()
  from soda_tpu_torch.backend import tile_plan
  from soda_tpu_torch.tools import autotune
  monkeypatch.setattr(tile_plan, 'MIN_CTAS', 4)  # streaming candidates
  stencil = corpus.build('blur')
  shape = (512, 256)
  cache = str(tmp_path / 'tune.json')
  cands = autotune.candidate_configs(stencil, shape)
  assert any(c.get('stream_loop') == 'peel' for c in cands)
  cfg = autotune.tune(stencil, shape, cache_path=cache)
  assert cfg in cands
  (entry,) = autotune._load(cache).values()
  assert len(entry['probes']) == len(cands)
  assert entry['ms'] == min(entry['probes'].values())

  def no_probe(*args, **kwargs):
    raise AssertionError('a cached tune probed again')

  monkeypatch.setattr(autotune, '_time_config', no_probe)
  assert autotune.tune(stencil, shape, cache_path=cache) == cfg
  ex = autotune.tuned_executor(stencil, shape, cache_path=cache)
  inputs = reference.make_test_inputs(stencil, shape)
  got = ex(inputs)
  torch.cuda.synchronize()
  assert ex.launches == 1
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                'blur tuned on gpu')
