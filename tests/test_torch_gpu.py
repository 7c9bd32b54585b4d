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
compiled statistics read from the card, and the tuner end to end. Integers bit-exact, floats within the reference
threshold (tests/checks.py). Last, the experiment probes' kernels
(streaming, chain, narrow, copy-shift and 2.5-D jacobi) against their
plain versions, every launch counted, and the narrow and copy-shift
kernels' SASS read (no spills; the overlap's register chain between its
copy's issue and its wait, the store control's reloads not forwarded).
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
from soda_tpu_torch.backend import build
from soda_tpu_torch.experiments import copyshift, layout25d, narrow, probes
from soda_tpu_torch.parallel.replicate import ReplicatedExecutor
from soda_tpu_torch.parallel.spmd import ShardedExecutor
from soda_tpu_torch.testing import (CONV_PARAM, FUZZ_SEEDS, FUZZ_SHAPE,
                                    GEOMETRY_CASES, LAYOUT_CASES, MODE_CASES,
                                    MULTI_OUTPUT, SEED_CONFIGS, build_cell,
                                    check_outputs, gen_program, make_inputs,
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
  """One launch, equal to ``layout_stencil_plain`` run on the card and
  to the NumPy oracle, per grid."""
  from soda_tpu_torch.backend.fused import layout_stencil_plain
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
    plain = layout_stencil_plain(stencil, [pick(a) for a in args[:n_in]],
                                 args[n_in:], tile=ex.plan)
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
@pytest.mark.parametrize('index', range(len(SEED_CONFIGS)),
                         ids=['%s-%d' % (c[0], i % 2)
                              for i, c in enumerate(SEED_CONFIGS)])
def test_seed_config_on_the_card(index):
  """The JAX package's bench seeds (bench.py:51-163) at small shapes: a
  layout seed against ``layout_stencil_plain``, every seed against the
  NumPy oracle."""
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


# -- the experiment probes (soda_tpu_torch/experiments/probes.py) ----------

_STREAM_CASES = probes.EXP27_CASES + probes.EXP30_CASES


@pytest.mark.gpu
@pytest.mark.parametrize('tiles', [None, 13])
@pytest.mark.parametrize('case', _STREAM_CASES,
                         ids=[c.name for c in _STREAM_CASES])
def test_stream_probe_on_the_card(case, tiles):
  """Each exp27/exp30 case: one launch, bit for bit equal to its plain
  version walking the card's schedule and to x + 1, on the scripts'
  64^3 input and on 13 tiles (ragged runs)."""
  _need_gpu()
  args = (case.kind, case.blk, case.split, case.depth)
  if tiles is None:
    x = probes.stream_input(64, 'cuda')
  else:
    x = torch.randn(tiles * case.blk * 1024, device='cuda')
  before = probes.LAUNCHES[case.key]
  got = probes.stream_probe(x, *args)
  torch.cuda.synchronize()
  assert probes.LAUNCHES[case.key] == before + 1
  ctas = probes.stream_ctas(*args[:2], case.split, case.depth,
                            x.numel() // (case.blk * 1024), x.device)
  assert torch.equal(got, probes.stream_probe_plain(x, *args, ctas=ctas))
  assert torch.equal(got, x + 1)


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
  report = narrow.sass_report()[(body.form, body.op)]
  assert report['spills'] == 0 and report['total'] > 0, report


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
  """exp9's 2.5-D kernel at the script's check and timed shapes and
  blocks: one launch, bit for bit equal to the whole-grid function on
  rows [2, h-2); built without spills, with the walk's band and tile."""
  _need_gpu()
  x = layout25d.grid_input(shape, 'cuda')
  key = (layout25d.KERNEL, 'block %d' % block)
  before = probes.LAUNCHES[key]
  got = layout25d.jacobi25d(x, block)
  torch.cuda.synchronize()
  assert probes.LAUNCHES[key] == before + 1
  assert torch.equal(layout25d.stored(got),
                     layout25d.stored(layout25d.jacobi25d_plain(x)))
  entry, = build.ptxas_report(build.csrc_source(layout25d.SOURCE)).values()
  assert entry['spill_stores'] == entry['spill_loads'] == 0
