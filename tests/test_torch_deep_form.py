"""The many-stage form of the fused kernel (tile_plan.DeepForm), on the CPU.

- Plans: contrast at its benchmark shape takes the form at the tile of
  fewest stage evaluations an output whose schedule shares barrier
  intervals, with far fewer barriers than stages; the 11 other
  benchmark cells take the short form.
- A static schedule checker, written apart from the scheduler: every
  read of a shared-memory buffer follows a barrier that follows the
  buffer's write, and no buffer's bytes are written over before a
  barrier that follows every access of their previous occupant. It
  holds on contrast's plans and on the multi-stage fuzz programs with
  the most stages forced into the form, and fails once any one of
  contrast's barriers is taken out, or once the buffers are placed by
  the default form's allocator (which frees a slot right after its last
  reader).
- The form's generated CUDA text through the g++ emulation
  (tests/torch_emulation.py: 512 host threads a CTA, ASan and UBSan),
  bit for bit against the plain version and against the default form's
  text, at contrast's test shape (at tile (8, 32)) and at (72, 192),
  both with interior and edge CTAs, element step by element step, and on an output another
  output reads (at a ragged shape), a program with params and two fuzz
  programs.
- Contrast through the port's main path on the CPU against the JAX
  package's executor (its Pallas kernel in interpret mode) within
  contrast's 1e-3 threshold.
"""

import collections
import concurrent.futures
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import soda_tpu
import soda_tpu_torch
from soda_tpu_torch import corpus, profiling, testing
from soda_tpu_torch.api import build_stencil
from soda_tpu_torch.backend import reference, tile_plan
from soda_tpu_torch.backend.fused import fused_stencil_plain, prepare_args
from soda_tpu_torch.backend.tile_plan import DEEP_ELEMENTS, make_tile_plan
from soda_tpu_torch.optimization import cr_schedules

from checks import assert_close_reference
from test_fuzz import gen_program as gen_multi_stage
from torch_emulation import compile_kernel, run_kernel

torch.set_num_threads(1)

CONTRAST = next(c for c in testing.CELLS if c[0] == 'contrast')
SMALL = corpus.TEST_DIMS['contrast']  # (40, 64)
WIDE = (72, 192)
# the form's tile at SMALL in the emulation: the tile the rule picks
# there spans the grid's width, so no CTA is interior
SMALL_TILE = (8, 32)
DEFAULT = tile_plan.DEEP_DEFAULT
# barriers a tile of contrast's plan at its benchmark shape
BENCH_BARRIERS = 31


class _StepClock:
  """A stand-in for the ``time`` module whose clock advances a fixed
  step per reading (as tests/test_torch_cuda_source.py's)."""

  def __init__(self, step=0.5):
    self.now, self.step = 0.0, step

  def monotonic(self):
    self.now += self.step
    return self.now


_BUILT = {}


def _build(text_or_name, overrides):
  """A stencil built as on every machine alike: the in-process
  computation-reuse scheduler (no external binary) under _StepClock, so
  its time budgets end at the same point; cached."""
  key = (text_or_name, repr(sorted(overrides.items())))
  if key not in _BUILT:
    saved = cr_schedules.find_external_cr, cr_schedules.time
    cr_schedules.find_external_cr = lambda: None
    cr_schedules.time = _StepClock()
    try:
      _BUILT[key] = build_stencil(corpus.CORPUS.get(text_or_name,
                                                    text_or_name),
                                  **overrides)
    finally:
      cr_schedules.find_external_cr, cr_schedules.time = saved
  return _BUILT[key]


def _contrast(shape=None):
  """The contrast cell's stencil (its computation reuse: 114 stages),
  with a DSL tile size that matches ``shape`` where one is given."""
  overrides = dict(CONTRAST[2])
  if shape is not None:
    overrides['tile_size'] = (shape[1], 0)
  return _build('contrast', overrides)


@pytest.fixture(scope='module')
def bench_plan():
  return make_tile_plan(_contrast(), CONTRAST[1])


def _fuzz_cases(seeds, count=4):
  """(seed, stencil, shape) of the multi-stage fuzz programs
  (tests/test_fuzz.py's generator) among ``seeds`` with the most stages:
  half 2-D, half 3-D."""
  cases = []
  for seed in seeds:
    dim = 2 if seed % 3 else 3
    try:
      stencil = build_stencil(gen_multi_stage(np.random.default_rng(seed),
                                              dim))
    except Exception:  # pylint: disable=broad-except
      continue  # the generator's invalid programs, as test_fuzz skips them
    shape = (24, 32) if dim == 2 else (16, 16, 32)
    try:
      plan = make_tile_plan(stencil, shape, _deep=DEEP_ELEMENTS)
    except soda_tpu_torch.utils.InputError:
      continue  # a window larger than the grid
    cases.append((len(plan.stages), seed, dim, stencil, shape))
  cases.sort(key=lambda c: (-c[0], c[1]))
  picked = [c for c in cases if c[2] == 2][:count // 2] + [
      c for c in cases if c[2] == 3][:count // 2]
  return [(seed, stencil, shape) for _, seed, _, stencil, shape in picked]


# the fuzz programs among seeds 0-119 with the most stages (4 in 2-D, 3
# in 3-D: the generator chains up to 4); test_fuzz_seeds_have_the_most_stages
FUZZ_SEEDS = (61, 73, 21, 30)
FUZZ = _fuzz_cases(FUZZ_SEEDS)


# -- plans --------------------------------------------------------------------
def test_contrast_takes_the_form_at_its_bench_shape(bench_plan):
  deep = bench_plan.deep
  assert deep is not None and deep.elements == tile_plan.DEEP_DEFAULT
  assert len(bench_plan.stages) == 114
  assert deep.ctas == 1
  assert tile_plan.resident_ctas(bench_plan.smem_bytes) == deep.ctas
  assert bench_plan.smem_bytes + tile_plan.CTA_SMEM_RESERVED \
      <= tile_plan.SM_SMEM
  assert len(deep.barriers) <= tile_plan.DEEP_MAX_BARRIER_SHARE * 114
  # the tile the rule picks, the evaluations it costs and its barriers
  assert bench_plan.tile == (16, 64)
  assert deep.evaluations == pytest.approx(147.3, abs=0.05)
  assert len(deep.barriers) == BENCH_BARRIERS
  # the tiles of fewer evaluations do not fit a block at all
  for tile in ((32, 64), (64, 32)):
    assert tile_plan.stage_evaluations(bench_plan.spans, tile, bench_plan.stages
                                       ) < deep.evaluations
    with pytest.raises(soda_tpu_torch.utils.InputError):
      make_tile_plan(bench_plan.stencil, CONTRAST[1], tile, _deep=DEFAULT)


def test_the_tile_rule_passes_over_a_schedule_without_room(monkeypatch):
  """With 212,000 B a block (16, 64) still costs the fewest evaluations,
  but its buffers at a barrier a stage (208,976 B) leave no room to
  share intervals, so its schedule keeps almost a barrier a stage and
  the rule takes the next tile."""
  monkeypatch.setattr(tile_plan, 'SMEM_LIMIT', 212_000)
  stencil, shape = _contrast(), CONTRAST[1]
  tight = make_tile_plan(stencil, shape, (16, 64), _deep=DEFAULT)
  chosen = make_tile_plan(stencil, shape)
  assert tight.deep.evaluations < chosen.deep.evaluations
  assert len(tight.deep.barriers) > tile_plan.DEEP_MAX_BARRIER_SHARE * 114
  assert chosen.tile == (32, 32)
  assert len(chosen.deep.barriers) <= tile_plan.DEEP_MAX_BARRIER_SHARE * 114


@pytest.mark.parametrize('name,shape,overrides',
                         [c for c in testing.CELLS if c[0] != 'contrast'],
                         ids=[c[0] for c in testing.CELLS
                              if c[0] != 'contrast'])
def test_other_cells_keep_the_default_form(name, shape, overrides):
  """The 11 other cells, below DEEP_MIN_STAGES, take the short form
  (tests/test_torch_short_form.py), not the many-stage one."""
  plan = make_tile_plan(testing.build_cell(name, overrides), shape)
  assert plan.deep is None
  assert plan.short is not None and \
      plan.short.elements == tile_plan.short_default(len(shape))
  assert len(plan.stages) < tile_plan.DEEP_MIN_STAGES


def test_contrast_is_bound_by_operations():
  """142 float operations a cell, each its own instruction under
  --fmad=false, at 132 SMs x 128 lanes x 1.98 GHz: 0.0712 ms, above the
  bytes' 0.0401 ms."""
  assert profiling.H100_F32_OPS_PER_S == pytest.approx(33.45e12, rel=1e-3)
  bound, by = profiling.bound_ms(_contrast(), CONTRAST[1])
  assert by == 'operations'
  assert bound == pytest.approx(0.0712, abs=1e-4)
  blur = next(c for c in testing.CELLS if c[0] == 'blur')
  assert profiling.bound_ms(testing.build_cell(blur[0], blur[2]),
                            blur[1])[1] == 'bytes'


def test_an_explicit_deep_off_keeps_the_default_form():
  """``_deep=()`` keeps the default form at a many-stage graph and at
  any graph given a key (the kernels chip_smoke.py's old-form readings,
  tile_sweep's baselines and the fused tests take with it); with no key
  a short graph still takes the short form."""
  shape = CONTRAST[1]
  stencil = _contrast()
  plan = make_tile_plan(stencil, shape, _deep=())
  assert plan.short is None and plan.deep is None
  assert make_tile_plan(stencil, shape, (4, 128), _deep=()).short is None
  assert make_tile_plan(stencil, shape, (4, 128)).short is not None
  blur = next(c for c in testing.CELLS if c[0] == 'blur')
  small = testing.build_cell(blur[0], blur[2])
  assert make_tile_plan(small, blur[1], _deep=()).short is not None
  assert tile_plan.kernel_plan(small, blur[1], block_rows=32,
                               _deep=()).short is None
  assert tile_plan.kernel_plan(small, blur[1], block_rows=32
                               ).short is not None


def test_an_explicit_tile_or_mode_keeps_the_default_form():
  shape = CONTRAST[1]
  stencil = _contrast()
  assert make_tile_plan(stencil, shape, (4, 128)).deep is None
  assert tile_plan.kernel_plan(stencil, shape, block_rows=64).deep is None
  assert tile_plan.kernel_plan(stencil, shape, out_dma=True).deep is None
  assert make_tile_plan(stencil, shape, _deep=()).deep is None
  with pytest.raises(ValueError):
    make_tile_plan(stencil, shape, _deep=('cells',))
  with pytest.raises(soda_tpu_torch.utils.InputError):
    tile_plan.kernel_plan(stencil, shape, block_rows=64, _deep=DEEP_ELEMENTS)


# -- the schedule checker -----------------------------------------------------
def check_schedule(plan, barriers=None, offsets=None):
  """Raise AssertionError where ``plan``'s shared-memory schedule races.

  Positions: -1 is the input fill, k the plan's stage k; a barrier at
  index k runs between positions k - 1 and k. Each buffer covers its
  extent's bytes from its offset."""
  stencil = plan.stencil
  barriers = sorted(plan.deep.barriers if barriers is None else barriers)
  offsets = plan.offsets if offsets is None else offsets

  def between(a, b):  # a barrier after position a, at or before b
    return any(a < k <= b for k in barriers)

  span = {}
  for name, start in offsets.items():
    size = int(np.prod(plan.extent(name))) * plan.dtype(name).np_dtype.itemsize
    span[name] = (start, start + size)
    assert 0 <= start and start + size <= plan.smem_bytes, name
  write = {n: -1 for n in stencil.input_names if n in offsets}
  reads = collections.defaultdict(list)
  for k, stage in enumerate(plan.stages):
    if stage.name in offsets:
      write[stage.name] = k
    for parent in stage.load_offsets:
      if parent in offsets:
        reads[parent].append(k)
  for name, at in reads.items():
    for k in at:
      assert write[name] < k and between(write[name], k), (
          'stage %d reads %s, written at %d, with no barrier between' %
          (k, name, write[name]))
  last = {n: max([write[n]] + reads[n]) for n in write}
  names = sorted(write, key=write.get)
  for i, x in enumerate(names):
    for y in names[i + 1:]:
      (a0, a1), (b0, b1) = span[x], span[y]
      if a0 < b1 and b0 < a1:  # y's write comes after x's
        assert last[x] < write[y] and between(last[x], write[y]), (
            '%s (written at %d, last read at %d) is written over by %s at '
            '%d with no barrier between' % (x, write[x], last[x], y,
                                             write[y]))


def _plans():
  out = [('contrast bench', None)]
  out += [('contrast %s' % (shape,), shape) for shape in (SMALL, WIDE)]
  out += [('fuzz%d' % seed, seed) for seed, _, _ in FUZZ]
  return out


@pytest.mark.parametrize('label,key', _plans(), ids=[p[0] for p in _plans()])
def test_schedule_is_free_of_races(label, key, bench_plan):
  if key is None:
    plan = bench_plan
  elif isinstance(key, tuple):
    plan = make_tile_plan(_contrast(key), key)
  else:
    _, stencil, shape = next(c for c in FUZZ if c[0] == key)
    plan = make_tile_plan(stencil, shape, _deep=DEEP_ELEMENTS)
  check_schedule(plan)
  # and the default form's schedule at the same tile
  old = make_tile_plan(plan.stencil, plan.shape, plan.tile,
                       _deep=('tile',))
  check_schedule(old)
  assert label


def test_fuzz_seeds_have_the_most_stages():
  assert [seed for seed, _, _ in _fuzz_cases(range(120))] == list(FUZZ_SEEDS)
  assert [len(make_tile_plan(st, shape, _deep=DEEP_ELEMENTS).stages)
          for _, st, shape in FUZZ] == [4, 4, 3, 3]


def test_removing_any_barrier_races(bench_plan):
  barriers = bench_plan.deep.barriers
  assert barriers[0] == 0  # the input fill's
  for b in barriers:
    with pytest.raises(AssertionError):
      check_schedule(bench_plan, [k for k in barriers if k != b])


def test_the_default_allocator_races_under_the_forms_barriers(bench_plan):
  """The default form frees a slot right after its last reader, which is
  sound only with a barrier after every stage."""
  offsets, _ = tile_plan._allocate(bench_plan.stencil, bench_plan.stages,
                                   bench_plan.spans, bench_plan.tile)
  with pytest.raises(AssertionError, match='written over'):
    check_schedule(bench_plan, offsets=offsets)


def test_hazard_barriers_are_the_fewest_for_the_order(bench_plan):
  """Each barrier separates a hazard that begins after the previous one
  (so none can go), and the schedule holds the stage intervals' count."""
  plan = bench_plan
  again = tile_plan.hazard_barriers(plan.stencil, plan.stages, plan.offsets,
                                    plan.spans, plan.tile)
  assert again == plan.deep.barriers
  every = dataclasses.replace(plan.deep, barriers=tuple(range(len(
      plan.stages))))
  check_schedule(dataclasses.replace(plan, deep=every))


# -- the generated text under the emulation -----------------------------------
EMU_CASES = (
    ('contrast', SMALL, DEFAULT),
    ('contrast', SMALL, ('tile',)),
    ('contrast', SMALL, ('tile', 'cells')),
    ('contrast', SMALL, ('tile', 'cells', 'interior')),
    ('contrast', SMALL, ('tile', 'cells', 'interior', 'barriers')),
    ('contrast', SMALL, ('tile', 'barriers', 'intervals')),
    ('contrast', WIDE, DEFAULT),
    ('contrast', WIDE, ()),
    # an output another output reads, at a ragged shape; params
    ('multi_output', (29, 35), DEFAULT),
    ('conv_param', (24, 64), DEFAULT),
) + tuple(('fuzz%d' % seed, shape, DEFAULT) for seed, _, shape in
          FUZZ[1:2] + FUZZ[-1:])
PROGRAMS = {'multi_output': testing.MULTI_OUTPUT,
            'conv_param': testing.CONV_PARAM}


def _emu_plan(case):
  name, shape, elements = case
  tile = None
  if name == 'contrast':
    stencil = _contrast(shape)
    tile = SMALL_TILE if shape == SMALL else None
  elif name in PROGRAMS:
    stencil = build_stencil(PROGRAMS[name])
  else:
    stencil = next(st for seed, st, _ in FUZZ if 'fuzz%d' % seed == name)
  return make_tile_plan(stencil, shape, tile, _deep=elements)


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
  """Each case's outputs from its emulated kernel (compilers at once)."""
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('no g++ on this machine')
  tmp = tmp_path_factory.mktemp('deep_emu')
  plans = [_emu_plan(case) for case in EMU_CASES]

  def emulate(index):
    plan = plans[index]
    exe = compile_kernel(gxx, tmp, index, plan, 1)
    grid = testing.make_inputs(plan.stencil, plan.shape, 7)
    params = reference.make_test_params(plan.stencil)
    outs = run_kernel(exe, tmp, plan.stencil, [grid], params, False)
    return plan, grid, params, {n: o.reshape(plan.shape) for n, o in
                                zip(plan.stencil.output_names, outs)}

  with concurrent.futures.ThreadPoolExecutor(4) as pool:
    return list(pool.map(emulate, range(len(EMU_CASES))))


def _case_id(case):
  return '%s-%s-%s' % (case[0], 'x'.join(map(str, case[1])),
                       '+'.join(case[2]) or 'default')


@pytest.mark.parametrize('index', range(len(EMU_CASES)),
                         ids=[_case_id(c) for c in EMU_CASES])
def test_emulated_kernel_matches_plain(emulated, index):
  plan, grid, params, got = emulated[index]
  stencil, shape = plan.stencil, plan.shape
  assert plan.deep is not None or EMU_CASES[index][2] == ()
  args = prepare_args(stencil, shape, torch.device('cpu'), grid, params)
  n_in = len(stencil.input_names)
  plain = fused_stencil_plain(stencil, args[:n_in], args[n_in:])
  testing.check_exact(stencil, shape, got,
                      dict(zip(stencil.output_names, plain)),
                      '%s vs plain' % _case_id(EMU_CASES[index]))
  with np.errstate(all='ignore'):
    want = reference.run(stencil, grid, params)
  testing.check_outputs(stencil, shape, got, want,
                        '%s vs the oracle' % _case_id(EMU_CASES[index]))


@pytest.mark.parametrize('shape', [SMALL, WIDE], ids=['40x64', '72x192'])
def test_emulated_form_equals_the_default_form(emulated, shape):
  """Every element step's text bit for bit against the default form's
  (at (40, 64) the default form at the form's tile, at (72, 192) at its
  own)."""
  rows = [(case, out) for case, out in zip(EMU_CASES, emulated)
          if case[0] == 'contrast' and case[1] == shape]
  base = next(out for case, out in rows if case[2] in ((), ('tile',)))
  assert len(rows) >= 2
  for case, (plan, _, _, got) in rows:
    testing.check_exact(plan.stencil, shape, got, base[3],
                        '%s vs the default form' % _case_id(case))


def test_emulated_cases_have_interior_and_edge_ctas():
  for shape in (SMALL, WIDE):
    plan = _emu_plan(('contrast', shape, DEFAULT))
    interior = [o for o in np.ndindex(*plan.grid) if all(
        lo <= i * t <= hi for i, t, (lo, hi) in zip(o, plan.tile,
                                                    plan.deep.interior))]
    assert 0 < len(interior) < plan.n_tiles, (shape, plan.deep.interior)


# -- the main path against the JAX package ------------------------------------
def test_contrast_matches_the_jax_executor():
  shape = SMALL
  overrides = dict(CONTRAST[2], tile_size=(shape[1], 0))
  stencil = _contrast(shape)
  jax_stencil = soda_tpu.build_stencil(corpus.CORPUS['contrast'], **overrides)
  ex = soda_tpu_torch.get_executor(stencil, shape, device='cpu')
  assert ex.plan.deep is not None and ex.plan.deep.elements == DEFAULT
  inputs = reference.make_test_inputs(stencil, shape)
  got = ex(inputs)
  want = soda_tpu.get_executor(jax_stencil, shape)(inputs, {})
  region = reference.output_valid_slices(stencil, shape, 'output')
  assert_close_reference(got['output'].numpy()[region],
                         np.asarray(want['output'])[region], True,
                         'contrast', threshold=1e-3)
