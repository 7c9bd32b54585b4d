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
version and the oracle, the layout forms (value stages in registers,
transposed regions, packed 16-bit stages, chunked stage loops) and the
JAX package's 24 seed configurations against theirs and the oracle,
contrast's many-stage form and the other cells' short form element by
element against the default form (and a misaligned argument computed),
the recorded calls (``chained`` and a sharded call replayed from a CUDA
graph) bit for bit against their loops,
compiled statistics read from the card, and the tuner end to end. Integers bit-exact, floats within the reference
threshold (tests/checks.py). Last, the experiment probes' kernels
(streaming, chain, narrow, copy-shift and 2.5-D jacobi) against their
plain versions, every launch counted, and the narrow and copy-shift
kernels' SASS read (no spills; the overlap's register chain between its
copy's issue and its wait, the store control's reloads not forwarded).
"""

import json

import numpy as np
import pytest
import torch

from soda_tpu_torch import corpus
from soda_tpu_torch.api import build_stencil
from soda_tpu_torch.backend import reference
from soda_tpu_torch.backend.fused import FusedExecutor
from soda_tpu_torch.backend.grouped import GroupedExecutor
from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
from soda_tpu_torch.backend import build
from soda_tpu_torch.experiments import (cluster_chain, copyshift, layout25d,
                                        narrow, probes)
from soda_tpu_torch.parallel.replicate import ReplicatedExecutor
from soda_tpu_torch.parallel.spmd import ShardedExecutor
from soda_tpu_torch.backend import tile_plan
from soda_tpu_torch.backend.tile_plan import DEEP_ELEMENTS, SHORT_ELEMENTS
from soda_tpu_torch.testing import (CELLS, CONV_PARAM, FUZZ_SEEDS, FUZZ_SHAPE,
                                    GEOMETRY_CASES, LAYOUT_CASES, MODE_CASES,
                                    MULTI_OUTPUT, SEED_CONFIGS, build_cell,
                                    check_exact, check_outputs, gen_program,
                                    make_inputs,
                                    mode_inputs, mode_stencil, repeated_mesh,
                                    replica_inputs, seed_small)


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
def test_rank_form_two_gloo_ranks_on_one_card():
  """The sharded executor's rank form, two gloo ranks on cuda:0 (halos
  staged through host memory): bit for bit the single-controller form
  on a mesh repeating the card (on the valid regions: a kernel need not
  write the cells outside them), one fused launch a rank, and the real
  overlap equal to the repeated mesh's 'on'."""
  _need_gpu()
  from soda_tpu_torch.parallel import dryrun
  cases = [
      dryrun.Case('blur', corpus.build('blur'), (64, 64), (2,)),
      dryrun.Case('seidel2d', corpus.build('seidel2d'), (64, 64), (1, 2)),
      dryrun.Case('jacobi2d overlap', corpus.build('jacobi2d'), (64, 32),
                  (2,), inner='xla', overlap='on')]
  ranks = dryrun.collect_world(cases, 2, 'gloo', 'cuda:0')
  for i, case in enumerate(cases):
    single = ShardedExecutor(case.stencil, case.shape, inner=case.inner,
                             overlap=case.overlap,
                             mesh=repeated_mesh('cuda', case.mesh_shape))
    want = single(*dryrun.inputs_of(case))
    check_exact(case.stencil, case.shape, ranks[0][i]['outputs'], want,
                case.label + ': rank form vs repeated mesh')
    assert all('staged through host memory' in r[i]['repr'] for r in ranks)
    assert [r[i]['launches'] for r in ranks] == (
        [0, 0] if case.inner == 'xla' else [1, 1])


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


def _check_layout_on_card(stencil, shape, ex, grids, params, context):
  """One launch, equal to the plan's plain version (the short form's
  ``fused_stencil_plain`` or walk, an old form's ``layout_stencil_plain``)
  run on the card and to the NumPy oracle, per grid."""
  from soda_tpu_torch.backend.fused import plain_version
  reps = len(grids)
  batch = (grids[0] if ex.replicas is None else
           {n: np.stack([g[n] for g in grids]) for n in stencil.input_names})
  args = ex.prepare(batch, params)
  outs = ex.fn(*args)
  torch.cuda.synchronize()
  assert ex.launches == 1
  n_in = len(stencil.input_names)
  for r, grid in enumerate(grids):
    pick = (lambda t: t) if ex.replicas is None else (lambda t, r=r: t[r])
    got = {o: pick(v) for o, v in zip(stencil.output_names, outs)}
    plain = plain_version(ex.plan)(
        stencil, [pick(a) for a in args[:n_in]], args[n_in:], tile=ex.plan)
    check_outputs(stencil, shape, got, dict(zip(stencil.output_names, plain)),
                  '%s vs plain on gpu' % context)
    with np.errstate(all='ignore'):
      want = reference.run(stencil, grid, params)
    check_outputs(stencil, shape, got, want, '%s on gpu' % context)
  assert reps == len(grids)


@pytest.mark.gpu
@pytest.mark.parametrize('case', LAYOUT_CASES,
                         ids=['%s-%s-%s' % (c[0], 'x'.join(map(str, c[1])),
                                            '-'.join('%s=%s' % kv for kv in
                                                     sorted(c[2].items())))
                              for c in LAYOUT_CASES])
def test_layout_kernel_matches_its_plain_version(case, monkeypatch):
  """Each layout form's kernel on the card (L1-L4 on the paths of
  ``testing.LAYOUT_CASES``): one launch, equal to its plain version and
  to the NumPy oracle."""
  _need_gpu()
  from soda_tpu_torch.backend import tile_plan
  name, shape, opts, min_ctas, reps = case
  monkeypatch.setattr(tile_plan, 'MIN_CTAS', min_ctas)
  stencil = mode_stencil(name)
  ex = FusedExecutor(stencil, shape, device='cuda',
                     replicas=None if reps == 1 else reps, **opts)
  grids = mode_inputs(stencil, name, shape, reps)
  _check_layout_on_card(stencil, shape, ex, grids,
                        reference.make_test_params(stencil),
                        '%s %s' % (name, opts))


@pytest.mark.gpu
@pytest.mark.parametrize('case', LAYOUT_CASES,
                         ids=['%s-%s-%s' % (c[0], 'x'.join(map(str, c[1])),
                                            '-'.join('%s=%s' % kv for kv in
                                                     sorted(c[2].items())))
                              for c in LAYOUT_CASES])
def test_old_layout_kernel_matches_its_plain_version(case, monkeypatch):
  """Each old layout form (``_short=()``) on the card: one launch, equal
  to ``layout_stencil_plain`` and to the NumPy oracle."""
  _need_gpu()
  from soda_tpu_torch.backend import tile_plan
  name, shape, opts, min_ctas, reps = case
  monkeypatch.setattr(tile_plan, 'MIN_CTAS', min_ctas)
  stencil = mode_stencil(name)
  ex = FusedExecutor(stencil, shape, device='cuda',
                     replicas=None if reps == 1 else reps, _short=(), **opts)
  assert ex.plan.short is None
  grids = mode_inputs(stencil, name, shape, reps)
  _check_layout_on_card(stencil, shape, ex, grids,
                        reference.make_test_params(stencil),
                        '%s %s old form' % (name, opts))


@pytest.mark.gpu
@pytest.mark.parametrize('index', range(len(SEED_CONFIGS)),
                         ids=['%s-%d' % (c[0], i % 2)
                              for i, c in enumerate(SEED_CONFIGS)])
def test_seed_config_on_the_card(index):
  """The JAX package's bench seeds (bench.py:51-163) at small shapes: a
  layout seed against its plain version, every seed against the NumPy
  oracle."""
  _need_gpu()
  name, shape, overrides, opts = SEED_CONFIGS[index]
  small, overrides = seed_small(name, shape, overrides)
  stencil = build_cell(name, overrides)
  ex = FusedExecutor(stencil, small, device='cuda', **opts)
  inputs = reference.make_test_inputs(stencil, small)
  if ex.plan.layout is not None:
    _check_layout_on_card(stencil, small, ex, [inputs], {}, '%s %s' % (
        name, opts))
    return
  got = ex(inputs)
  torch.cuda.synchronize()
  assert ex.launches == 1
  check_outputs(stencil, small, got, reference.run(stencil, inputs),
                '%s %s on gpu' % (name, opts))


@pytest.mark.gpu
@pytest.mark.parametrize('elements', [DEEP_ELEMENTS[:i + 1] for i in range(
    len(DEEP_ELEMENTS))], ids=['+'.join(DEEP_ELEMENTS[:i + 1]) for i in range(
        len(DEEP_ELEMENTS))])
def test_deep_form_on_the_card(elements):
  """contrast's many-stage form (tile_plan.DeepForm), element step by
  element step, at a shape with interior and edge CTAs: bit for bit
  against the default form and within the threshold of the oracle."""
  _need_gpu()
  shape = (72, 192)
  overrides = dict(next(c for c in CELLS if c[0] == 'contrast')[2],
                   tile_size=(192, 0))
  stencil = build_cell('contrast', overrides)
  inputs = reference.make_test_inputs(stencil, shape)
  old = FusedExecutor(stencil, shape, device='cuda', _deep=())
  ex = FusedExecutor(stencil, shape, device='cuda', _deep=elements)
  assert ex.plan.deep is not None and old.plan.deep is None
  got, want = ex(inputs), old(inputs)
  torch.cuda.synchronize()
  assert ex.launches == 1
  check_exact(stencil, shape, got, want, 'contrast %s' % (elements,))
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                'contrast %s on gpu' % (elements,))


# the short form's card cases: (cell, shape, tile) with interior and
# edge tiles and, under 'walk', runs of several steps
SHORT_CARD = (('denoise2d', (40, 64), (8, 16)),
              ('denoise3d', (12, 24, 96), (2, 8, 32)),
              ('erosion', (48, 96), (8, 32)),
              ('blur', (40, 64), (8, 32)))


@pytest.mark.gpu
@pytest.mark.parametrize('name,shape,tile,elements', [
    (n, s, t, SHORT_ELEMENTS[:k + 1]) for n, s, t in SHORT_CARD
    for k in range(len(SHORT_ELEMENTS) - 1)], ids=[
        '%s-%s' % (n, '+'.join(SHORT_ELEMENTS[:k + 1])) for n, _, _ in
        SHORT_CARD for k in range(len(SHORT_ELEMENTS) - 1)])
def test_short_form_on_the_card(name, shape, tile, elements, monkeypatch):
  """The short form (tile_plan.ShortForm), element step by element step:
  bit for bit against the default form and within the threshold of the
  oracle."""
  _need_gpu()
  monkeypatch.setattr(tile_plan, 'SMS', 1)  # runs of several steps
  overrides = dict(next(c for c in CELLS if c[0] == name)[2],
                   tile_size=tuple(reversed(shape[1:])) + (0,))
  stencil = build_cell(name, overrides)
  inputs = reference.make_test_inputs(stencil, shape)
  old = FusedExecutor(stencil, shape, device='cuda', tile=tile, _short=())
  ex = FusedExecutor(stencil, shape, device='cuda', tile=tile,
                     _short=elements)
  assert ex.plan.short is not None and old.plan.short is None
  got, want = ex(inputs), old(inputs)
  torch.cuda.synchronize()
  assert ex.launches == 1
  check_exact(stencil, shape, got, want, '%s %s' % (name, elements))
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                '%s %s on gpu' % (name, elements))


@pytest.mark.gpu
def test_short_form_computes_misaligned_arguments():
  """The 16-byte copies need every input on a 16-byte boundary: a view
  one element into its storage is copied to fresh memory inside ``fn``
  and computed (the JAX executor takes any array of the compiled
  shape)."""
  _need_gpu()
  stencil = build_stencil(corpus.CORPUS['blur'], tile_size=(64, 0))
  shape = (40, 64)
  ex = FusedExecutor(stencil, shape, device='cuda')
  assert ex.plan.short.vec > 1
  inputs = reference.make_test_inputs(stencil, shape)
  (aligned,) = ex.prepare(inputs)
  storage = torch.zeros(40 * 64 + 1, dtype=torch.uint16, device='cuda')
  x = storage[1:].view(shape)
  x.copy_(aligned)
  assert x.data_ptr() % tile_plan.VECTOR_BYTES
  got = dict(zip(stencil.output_names, ex.fn(x)))
  torch.cuda.synchronize()
  assert ex.launches == 1
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                'blur misaligned on gpu')
  check_exact(stencil, shape, got, ex(inputs), 'blur misaligned == aligned')


# (cell, overrides, shape) of the recorded-call tests at small shapes
CHAINED_CARD = (('blur', {'tile_size': (64, 0)}, (40, 64)),
                ('jacobi2d', {}, (24, 32)),
                ('heat3d', {}, (12, 32, 32)))


@pytest.mark.gpu
@pytest.mark.parametrize('name,overrides,shape', CHAINED_CARD,
                         ids=[c[0] for c in CHAINED_CARD])
def test_chained_replays_equal_the_loop(name, overrides, shape):
  """After the first call, each call is one replay of a CUDA graph of the
  n calls, bit for bit equal to the Python loop; a replay counts the n
  launches it holds; outputs are copies no later call overwrites."""
  _need_gpu()
  from soda_tpu_torch.api import chained
  stencil = corpus.build(name, **overrides)
  ex = FusedExecutor(stencil, shape, device='cuda')
  run = chained(ex, 5)
  calls = [ex.prepare(reference.make_test_inputs(stencil, shape, seed=k))
           for k in range(3)]
  outs = []
  for k, args in enumerate(calls):
    ex.launches = 0
    outs.append(run(*args))
    torch.cuda.synchronize()
    assert ex.launches == 5 and run.replays == k
  kept = [o.clone() for o in outs[1]]
  for args, got in zip(calls, outs):
    want = run.loop(*args)
    check_exact(stencil, shape, dict(zip(stencil.output_names, got)),
                dict(zip(stencil.output_names, want)), name + ' replay')
  assert all(torch.equal(a, b) for a, b in zip(outs[1], kept))
  assert run.replays == 2


@pytest.mark.gpu
def test_chained_grad_path_is_not_recorded():
  """Autograd does not record through a replay: a call whose argument
  requires grad runs the loop on the card; the same call without grad
  is recorded and replayed, with the same result. The whole-grid
  executor (plain PyTorch, which may wait on the host) is never
  recorded, and gradients flow through its loop."""
  _need_gpu()
  from soda_tpu_torch.api import chained
  stencil = corpus.build('jacobi2d')
  shape = (24, 32)
  run = chained(FusedExecutor(stencil, shape, device='cuda'), 3)
  x = torch.rand(shape, device='cuda', requires_grad=True)
  looped = [run(x)[0] for _ in range(2)]
  assert run.replays == 0
  replayed = [run(x.detach())[0] for _ in range(2)]
  torch.cuda.synchronize()
  assert run.replays == 1
  assert all(torch.equal(y, looped[0]) for y in looped + replayed)
  whole = chained(WholeGridExecutor(stencil, shape, device='cuda'), 3)
  for _ in range(2):
    torch.sum(whole(x)[0]).backward()
    whole(x.detach())
  assert whole.replays == 0 and bool(torch.any(x.grad != 0))


@pytest.mark.gpu
@pytest.mark.parametrize('name,mesh_shape,inner,border', [
    ('blur', (4,), 'fused', 'ignore'),
    ('heat3d', (2, 2), 'fused', 'ignore'),
    ('denoise2d', (4,), 'grouped', 'ignore'),
    ('jacobi2d', (2, 2), 'fused', 'preserve'),
], ids=['blur-4', 'heat3d-2x2', 'denoise2d-grouped-4', 'jacobi2d-preserve'])
def test_sharded_replay_equals_the_eager_call(name, mesh_shape, inner,
                                              border):
  """On a mesh that repeats the card a sharded call after the first is
  one replay (its exchange and per-shard launches), bit for bit equal to
  ``fn_eager``, counting the launches it holds."""
  _need_gpu()
  stencil = corpus.build(name, border=border,
                         cluster='coarse' if inner == 'grouped' else 'none')
  shape = corpus.TEST_DIMS[name]
  ex = ShardedExecutor(stencil, shape, inner=inner,
                       mesh=repeated_mesh('cuda', mesh_shape))
  calls = [ex.prepare(reference.make_test_inputs(stencil, shape, seed=k))
           for k in range(3)]
  results = []
  for args in calls:
    ex.launches = 0
    results.append(ex.fn(*args))
    torch.cuda.synchronize()
    assert ex.launches == 4 * {'fused': 1, 'grouped': 8}[inner]
  assert ex.replays == 2
  crop = tuple(slice(0, r) for r in shape)
  for k, (args, got) in enumerate(zip(calls, results)):
    want = ex.fn_eager(*args)
    check_exact(stencil, shape,
                {n: g.gather()[crop] for n, g in
                 zip(stencil.output_names, got)},
                {n: w.gather()[crop] for n, w in
                 zip(stencil.output_names, want)},
                '%s %s replay %d' % (name, mesh_shape, k))


@pytest.mark.gpu
def test_chained_over_a_sharded_call_is_one_recording():
  """``chained`` over a sharded executor records every step's exchange,
  launches and crop in one graph (the relaxation example's path)."""
  _need_gpu()
  from soda_tpu_torch.api import chained
  stencil = corpus.build('jacobi2d', border='preserve')
  shape = (64, 32)
  ex = ShardedExecutor(stencil, shape, mesh=repeated_mesh('cuda', (4,)))
  run = chained(ex, 4)
  args = ex.prepare(reference.make_test_inputs(stencil, shape))
  first = run(*args)
  ex.launches = 0
  second = run(*args)
  torch.cuda.synchronize()
  assert run.replays == 1 and ex.launches == 16
  want = run.loop(*args)
  for got in (first, second):
    assert torch.equal(got[0].gather(), want[0].gather())


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
  assert any(c.get('stream_loop') is True for c in cands)
  cfg = autotune.tune(stencil, shape, cache_path=cache)
  assert cfg in cands
  (entry,) = autotune._load(cache).values()
  assert len(entry['probes']) == len(cands)
  # {} stays unless a candidate beats it by more than KEEP_MARGIN
  best = min(entry['probes'].values())
  default = entry['probes'][json.dumps({}, sort_keys=True)]
  assert entry['ms'] == (default if cfg == {} else best)
  assert cfg == {} or best < (1 - autotune.KEEP_MARGIN) * default

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


# -- the experiment probes (soda_tpu_torch/experiments/probes.py) ----------

_STREAM_CASES = probes.EXP27_CASES + probes.EXP30_CASES


@pytest.mark.gpu
@pytest.mark.parametrize('tiles', [None, 13])
@pytest.mark.parametrize('case', _STREAM_CASES,
                         ids=[c.name for c in _STREAM_CASES])
def test_stream_probe_on_the_card(case, tiles):
  """Each exp27/exp30 case on both kernels, the default (the bulk
  kernel) and the old one: one launch each, bit for bit equal to the
  plain version walking that kernel's schedule on the card and to x + 1,
  on the scripts' 64^3 input and on 13 tiles (ragged runs)."""
  _need_gpu()
  if tiles is None:
    x = probes.stream_input(64, 'cuda')
  else:
    x = torch.randn(tiles * case.blk * 1024, device='cuda')
  n_tiles = x.numel() // (case.blk * 1024)
  for key, old in ((case.key, False), (case.old_key, True)):
    before = dict(probes.LAUNCHES)
    got = probes.stream_probe(x, *case.args, _old=old)
    torch.cuda.synchronize()
    after = dict(probes.LAUNCHES)
    assert after.pop(key) == before.pop(key, 0) + 1 and after == before
    ctas = probes.stream_ctas(*case.args, n_tiles, x.device, old=old)
    assert torch.equal(got, probes.stream_probe_plain(x, *case.args,
                                                      ctas=ctas))
    assert torch.equal(got, x + 1)


@pytest.mark.gpu
def test_stream_probe_sass_keeps_bulk_copies():
  """Every bulk-kernel entry copies by UBLKCP and no LDGSTS, every old
  entry by LDGSTS; none spills (stream_replay.sass_check raises else)."""
  _need_gpu()
  from soda_tpu_torch.experiments import stream_replay
  rows = stream_replay.sass_check(log=lambda line: None)
  assert all(stream_replay.sass_ok(r) for r in rows)


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(probes.CHAIN_BODIES))
def test_chain_probe_on_the_card(name):
  """Each exp24/exp45 body at 1, 2 and 5 iterations (both ping-pong
  parities): one launch each, int32 bit for bit and float32 within
  CHAIN_RTOL of the plain version on the card."""
  _need_gpu()
  body = probes.CHAIN_BODIES[name]
  x = probes.chain_input(body.dtype, 'cuda')
  for n in probes.CHECK_ITERS:
    before = probes.LAUNCHES[('probe_chain', name)]
    got = probes.chain_probe(x, body, n)
    torch.cuda.synchronize()
    assert probes.LAUNCHES[('probe_chain', name)] == before + 1
    abs_err, rel_err = probes.max_error(got, probes.chain_probe_plain(
        x, body, n))
    if body.dtype == torch.int32:
      assert abs_err == 0, (name, n, abs_err)
    else:
      assert rel_err <= probes.CHAIN_RTOL, (name, n, rel_err)


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(narrow.BODIES))
def test_narrow_probe_on_the_card(name):
  """Each body of exp13, exp29, exp16, exp12, exp1 and exp2 on its
  script's inputs: one launch each, a chain at 1, 2 and 5 iterations (a
  register chain also through its main loop); integers bit for bit,
  float32 within CHAIN_RTOL of the plain version on the card; its
  kernel's SASS read, with no spilled bytes."""
  _need_gpu()
  body = narrow.BODIES[name]
  xs = narrow.body_inputs(body, 'cuda')
  key = (narrow.KERNEL, name)
  for n in narrow.check_iters(body):
    before = probes.LAUNCHES[key]
    got = narrow.narrow_probe(body, *xs, n=n)
    torch.cuda.synchronize()
    assert probes.LAUNCHES[key] == before + 1
    abs_err, rel_err = probes.max_error(got, body.plain(*xs, n=n))
    assert narrow.narrow_ok(body, abs_err, rel_err), (name, n, abs_err,
                                                      rel_err)
  report = narrow.sass_report()[narrow.sass_key(body)]
  assert report['spills'] == 0 and report['total'] > 0, report


@pytest.mark.gpu
@pytest.mark.parametrize('name', [b.name for b in cluster_chain.CASES])
def test_cluster_kernel_matches_plain_and_old_kernel(name):
  """Each body on its thread-block-cluster kernel (strip_cluster,
  chain_chunk_cluster; one cluster, no grid barrier) bit for bit against
  its plain version and its old kernel (``_old=True``: the strip
  kernel's grid barrier a phase, the first chain_chunk) at 1, 2 and 5
  iterations, the launch counted under each kernel's key."""
  _need_gpu()
  body = probes.CHAIN_BODIES[name]
  x = probes.chain_input(body.dtype, 'cuda')
  for n in probes.CHECK_ITERS:
    ctas = []
    got = cluster_chain.call(body, x, n, False, ctas)
    old = cluster_chain.call(body, x, n, True)
    torch.cuda.synchronize()
    want = probes.chain_probe_plain(x, body, n)
    assert torch.equal(got, want) and torch.equal(old, want), (name, n)
    assert 1 <= ctas[0] <= 16
  before = dict(probes.LAUNCHES)
  probes.chain_probe(x, body, 1)
  probes.chain_probe(x, body, 1, _old=True)
  for key in ('probe_chain', 'probe_chain[old]'):
    assert probes.LAUNCHES[(key, name)] == before.get((key, name), 0) + 1


@pytest.mark.gpu
def test_cluster_kernels_sass_pins_the_cluster_barrier():
  """Every cluster entry arrives at and waits on the cluster barrier
  (cluster_chain.CLUSTER_OPS), has none of the cooperative grid sync's
  opcodes, no divergent branch and no spilled bytes; every old entry has
  the grid sync."""
  _need_gpu()
  rows = cluster_chain.sass_check(log=lambda line: None)
  assert len(rows) == len(cluster_chain.CASES)
  for row in rows:
    assert cluster_chain.sass_ok(row), row['case']
    assert row['new']['spills'] == 0, row['case']


@pytest.mark.gpu
def test_refused_cluster_launch_raises():
  """strip_cluster refuses a plan it does not take (roll10's chained
  phases, on form 6) and nothing falls back; ``narrow.launch`` sends
  such a plan to the strip kernel by its plan, bit for bit."""
  _need_gpu()
  import ctypes
  body = narrow.EXP24_SHIFT['roll10']
  assert not body.cluster
  x = probes.chain_input(torch.int32, 'cuda')
  lib = narrow._lib()
  flat, rows, cols, in_rows, in_cols = narrow.launch_geometry(body)
  y = torch.empty_like(x)
  status = lib['launch'](
      narrow.CLUSTER_FORM, lib['ops']['strip'].index(body.op),
      (ctypes.c_int * len(flat))(*flat), len(flat), rows, cols, in_rows,
      in_cols, x.data_ptr(), None, y.data_ptr(), None, 1,
      torch.cuda.current_stream().cuda_stream, ctypes.byref(ctypes.c_int(0)))
  assert status != 0
  ctas = []
  got = narrow.launch(body, (x,), 1, ctas)
  assert ctas[0] > 16
  assert torch.equal(got, body.plain(x.cpu()).to('cuda'))


@pytest.mark.gpu
def test_narrow_swar_equals_wide_on_the_card():
  """exp16's check: both packed kernels equal the wide one at 1, 2, 5
  iterations."""
  _need_gpu()
  wide, swar, swar_bitwise = narrow.EXP16
  raw, = narrow.body_inputs(wide, 'cuda')
  words, = narrow.body_inputs(swar, 'cuda')
  for n in probes.CHECK_ITERS:
    want = narrow.narrow_probe(wide, raw, n=n)
    for body in (swar, swar_bitwise):
      got = narrow.narrow_probe(body, words, n=n).view(torch.int16)
      assert torch.equal(got, want), (body.name, n)


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(
    name for name, body in narrow.BODIES.items() if body.form == 'ew'))
def test_narrow_register_chain_folds_no_iteration(name):
  """A register chain's main loop, as ptxas compiled it, holds for each
  of its EW_UNROLL iterations at least the instructions of the body's
  least operations: no iteration folded into another (n doublings into
  one shift), so its time per iteration is the body's."""
  _need_gpu()
  body = narrow.BODIES[name]
  report = narrow.sass_report()[('ew', body.op)]
  assert narrow.ew_loop_holds_every_iteration(body), (name, report['loop'])


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(copyshift.CASES))
def test_copy_probe_on_the_card(name):
  """Each exp32 case (the script's main() and check() cases, on its block)
  at 1, 2 and 5 iterations: one launch each (a rotate control's in the
  strip kernel), bit for bit equal to its stale-tail plain version."""
  _need_gpu()
  case = copyshift.CASES[name]
  x = copyshift.copy_input(7 if name.startswith('check') else 0, 'cuda')
  key = ((narrow.KERNEL, copyshift.ROTATE[name].name)
         if case.kind == 'rotate' else (copyshift.KERNEL, name))
  for n in probes.CHECK_ITERS:
    before = probes.LAUNCHES[key]
    got = copyshift.copy_probe(case, x, n)
    torch.cuda.synchronize()
    assert probes.LAUNCHES[key] == before + 1
    assert torch.equal(got, copyshift.copy_plain(case, x, n)), (name, n)


@pytest.mark.gpu
def test_copy_probe_sass_pins_the_overlap_and_the_store_control():
  """No copy-shift kernel spills; the overlap's chain B (an xor, a min
  and a shift-add for each of a thread's CELL_SLOTS cell slots) sits
  between its copy's issue and its wait; the store control's main loop
  keeps a store, a reload and a min for each slot (no reload
  forwarded)."""
  _need_gpu()
  report = copyshift.sass_report()
  assert all(rep['spills'] == 0 for rep in report.values()), report
  order = copyshift.overlap_order(report['overlap']['loop'])
  assert order['between'] >= 3 * copyshift.CELL_SLOTS, order
  assert min(copyshift.store_loop_counts(
      report['store']['loop']).values()) >= copyshift.CELL_SLOTS


@pytest.mark.gpu
def test_copy_probe_refuses_what_it_cannot_copy():
  """A block no CTA tile of whole lines covers is refused at launch,
  not copied another way."""
  _need_gpu()
  x = torch.zeros((256, 1030), dtype=torch.int32, device='cuda')
  with pytest.raises(RuntimeError, match='failed to launch'):
    copyshift.copy_probe('dma5_lane_d8', x, 1)


@pytest.mark.gpu
@pytest.mark.parametrize('shape, block', [
    ((64, 16, 128), 32), ((96, 2, 128), 32), ((8192, 16, 128), 256),
    ((8192, 16, 128), 512), ((8192, 16, 128), 1024)])
def test_jacobi25d_on_the_card(shape, block):
  """exp9's 2.5-D kernels, the bulk one and the old one
  (``_old=True``), at the script's check and timed shapes and blocks:
  one launch each, bit for bit equal to the whole-grid function on rows
  [2, h-2); built without spills, with the walks' band and tiles."""
  _need_gpu()
  x = layout25d.grid_input(shape, 'cuda')
  want = layout25d.stored(layout25d.jacobi25d_plain(x))
  for kind in layout25d.KINDS:
    old = kind == 'old'
    key = layout25d.launch_key(block, old)
    before = probes.LAUNCHES[key]
    got = layout25d.jacobi25d(x, block, _old=old)
    torch.cuda.synchronize()
    assert probes.LAUNCHES[key] == before + 1
    assert torch.equal(layout25d.stored(got), want), kind
    assert layout25d.kernel_stats(kind)['spills'] == 0


@pytest.mark.gpu
def test_jacobi25d_copies_as_designed_on_the_card():
  """The bulk entry copies by bulk tensor copies (UTMALDG) alone, the
  old one by LDGSTS alone; the bulk kernel's grid at the timed shape is
  resident in one wave."""
  _need_gpu()
  from soda_tpu_torch.experiments import layout25d_replay
  layout25d_replay.sass_check(log=lambda line: None)
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  for block in layout25d.BLOCKS:
    grid = layout25d.launch_config(layout25d.SHAPE, block, 'cuda')
    assert grid['per_sm'] * sms >= grid['ctas'], (block, grid)
