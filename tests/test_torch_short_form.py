"""The short form of the fused kernel (tile_plan.ShortForm), on the CPU.

- Plans: the 11 benchmark cells other than contrast take the form at
  their bench shapes, with the tile, resident CTAs, shared memory,
  register stages ('values') and cells a thread ('vector') pinned; the
  16-byte path or the element path follows from the grid's rows.
- A static schedule checker, written apart from the planner: every read
  of a buffer follows a barrier that follows the buffer's write, and no
  buffer's bytes are written over before a barrier that follows every
  access of their previous occupant. It holds on the bench plans and on
  the fuzz programs, and fails once any one barrier is taken out. Under
  'walk', a ring checker steps each buffer through a run: every row a
  step reads lies in its ring row, written and not yet written over,
  and neither a step's new rows nor the next step's prefetched input
  rows land on a row the step reads; it fails with any ring a row
  shorter.
- The form's generated CUDA text through the g++ emulation
  (tests/torch_emulation.py: 512 host threads a CTA, 16-byte cp.async
  with its alignment checked, ASan and UBSan), element step by element
  step, on small grids with interior and edge CTAs (a 2-D and a 3-D
  cell, 16-bit cells, a fuzz program, an output another output reads, a
  program with params), bit for bit against the default form's text
  (``_short=()``) and the plain version.
- The 11 cells through the port's main path on the CPU against the JAX
  package's executor under the reference's pass rule.
- The public keys: every tile, block_rows, mid_tile and mode key builds
  the short form with the grid's default elements (``_short=()`` keeps
  the old kernels), block_rows and mid_tile pick among the rule's tiles,
  'peel' builds the text of True, and an element that cannot serve an
  explicit tile goes off and says so.
"""

import concurrent.futures
import contextlib
import shutil

import numpy as np
import pytest
import torch

import soda_tpu
import soda_tpu_torch
from soda_tpu_torch import corpus, testing
from soda_tpu_torch.api import build_stencil
from soda_tpu_torch.backend import reference, tile_plan
from soda_tpu_torch.backend.fused import fused_stencil_plain, prepare_args
from soda_tpu_torch.backend.tile_plan import SHORT_ELEMENTS, make_tile_plan

from checks import assert_close_reference
from test_torch_deep_form import FUZZ
from torch_emulation import compile_kernel, run_kernel

torch.set_num_threads(1)

OTHERS = [c for c in testing.CELLS if c[0] != 'contrast']
ELEMENTS = SHORT_ELEMENTS[:-1]  # every element at an explicit tile

# (tile, resident CTAs, shared-memory bytes, register stages, cells a
# thread, axis-0 tiles a CTA walks) of each cell's default kernel at its
# bench shape
DENOISE2D = ('diff_u', 'diff_d', 'diff_l', 'diff_r', 'r0', 'r1')
DENOISE3D = ('diff_u', 'diff_d', 'diff_l', 'diff_r', 'diff_i', 'diff_o',
             'r0', 'r1')
BENCH_PLANS = {
    'blur': ((64, 256), 3, 68640, (), 8, 1),
    'jacobi2d': ((64, 128), 3, 72928, (), 4, 1),
    'jacobi3d': ((2, 16, 128), 1, 126240, (), 4, 16),
    'heat3d': ((2, 16, 128), 1, 126240, (), 4, 16),
    'seidel2d': ((64, 128), 3, 72928, (), 4, 1),
    'erosion': ((32, 128), 3, 74368, (), 4, 1),
    'sobel2d': ((32, 256), 2, 86080, ('mag_x', 'mag_y'), 4, 1),
    'xcorr': ((32, 128), 2, 80096, ('cr_var_2', 'tmp2'), 4, 1),
    'denoise2d': ((64, 128), 2, 105696, DENOISE2D, 4, 1),
    'denoise3d': ((2, 16, 128), 1, 159008, DENOISE3D, 4, 16),
    'jacobi3d_256': ((1, 32, 128), 1, 173024, (), 4, 32),
}


@contextlib.contextmanager
def _one_sm():
  """tile_plan.SMS set to 1, so that a small grid's runs walk more than
  one tile (the plan keeps the run length it was made with)."""
  saved = tile_plan.SMS
  tile_plan.SMS = 1
  try:
    yield
  finally:
    tile_plan.SMS = saved


def _small(name):
  """(stencil, shape) of a benchmark cell at a small shape, its DSL tile
  size matching the grid."""
  overrides = dict(next(c for c in testing.CELLS if c[0] == name)[2])
  if name == 'jacobi3d_256':
    shape = (12, 32, 32)
  else:
    shape = corpus.TEST_DIMS[name]
  overrides['tile_size'] = tuple(reversed(shape[1:])) + (0,)
  return testing.build_cell(name, overrides), shape


# -- plans --------------------------------------------------------------------
@pytest.mark.parametrize('name,shape,overrides', OTHERS,
                         ids=[c[0] for c in OTHERS])
def test_bench_plans(name, shape, overrides):
  plan = make_tile_plan(testing.build_cell(name, overrides), shape)
  short = plan.short
  assert plan.deep is None and short is not None
  assert short.elements == tile_plan.short_default(len(shape))
  assert short.has('walk') == (len(shape) == 3)
  assert (plan.tile, short.ctas, plan.smem_bytes, short.values, short.vec,
          plan.steps) == BENCH_PLANS[name]
  assert short.ctas == tile_plan.resident_ctas(plan.smem_bytes) >= 1
  # every buffer, its slack included, inside the block's shared memory
  for tensor, offset in plan.offsets.items():
    before, after = short.slack[tensor]
    size = _rows(plan, tensor) * short.pitch(tensor) + after
    itemsize = plan.dtype(tensor).np_dtype.itemsize
    assert offset % 16 == 0 and offset - before * itemsize >= 0
    assert offset + size * itemsize <= plan.smem_bytes
  # the default form's plan at the same shape is as it was
  old = make_tile_plan(plan.stencil, shape, _short=())
  assert old.short is None and old.deep is None


def _rows(plan, name):
  """Buffer rows of ``name`` (its ring's on axis 0, then its extent's)."""
  rows = plan.short.rings[name]
  for e in plan.extent(name)[1:-1]:
    rows *= e
  return rows


@pytest.mark.parametrize('name,shape,vec', [
    ('blur', (40, 64), 8),       # 128-byte rows of uint16: 8 cells a thread
    ('blur', (40, 60), 1),       # 120-byte rows: the element path
    ('jacobi2d', (24, 32), 4),   # float32: 4 cells a thread
    ('jacobi2d', (24, 30), 1),
    ('erosion', (40, 64), 4),    # int16 with int32 stages: 16 bytes of
    ('erosion', (40, 72), 4),    # the widest type
    ('erosion', (40, 68), 1),    # 136-byte rows
    ('jacobi3d', (12, 32, 36), 4),   # 144-byte rows
    ('jacobi3d', (12, 32, 34), 1),
])
def test_vector_path_follows_the_rows(name, shape, vec):
  stencil, _ = _small(name)
  plan = make_tile_plan(stencil, shape)
  assert plan.short.vec == vec
  assert make_tile_plan(stencil, shape, _short=('cells',)).short.vec == 1


def test_value_stages_need_offset_zero_over_the_readers_extent():
  """A stage read at an offset, or by readers of different extents, or
  an output, keeps its buffer."""
  stencil = build_stencil(testing.MULTI_OUTPUT)
  plan = make_tile_plan(stencil, (29, 35))
  assert plan.short.values == ()  # o0 is an output, t is read at offsets
  xcorr = make_tile_plan(*_small('xcorr'))
  assert xcorr.short.values == ('cr_var_2', 'tmp2')
  assert not set(xcorr.short.values) & set(xcorr.offsets)


def test_an_explicit_tile_or_mode_keeps_the_default_form():
  """With ``_short=()`` an explicit tile, block_rows, mode or layout key
  keeps the default form (the kernels those keys built before the short
  form took them); without it a layout key builds the short form, and a
  forced element set takes the layout element too."""
  stencil, shape = _small('blur')
  assert make_tile_plan(stencil, shape, (8, 64), _short=()).short is None
  assert tile_plan.kernel_plan(stencil, shape, block_rows=8,
                               _short=()).short is None
  assert tile_plan.kernel_plan(stencil, shape, out_dma=True,
                               _short=()).short is None
  assert tile_plan.kernel_plan(stencil, shape,
                               stage_mode='value').short is not None
  assert tile_plan.kernel_plan(stencil, shape, stage_mode='value',
                               _short=()).short is None
  assert make_tile_plan(stencil, shape, _short=()).short is None
  with pytest.raises(ValueError):
    make_tile_plan(stencil, shape, _short=('values',))
  with pytest.raises(ValueError):
    make_tile_plan(stencil, shape, _short=('cells',), _deep=('tile',))
  forced = tile_plan.kernel_plan(stencil, shape, stage_mode='value',
                                 _short=('cells',))
  assert forced.short.on == ('cells',) and forced.short.region is not None
  with pytest.raises(soda_tpu_torch.utils.InputError, match='many-stage'):
    tile_plan.kernel_plan(stencil, shape, block_rows=8, _deep=('tile',))


# -- the public keys on the short form ----------------------------------------
# (cell, shape, keys): every public tile and mode key at small shapes
PUBLIC_KEYS = (
    ('blur', (40, 64), {'tile': (8, 64)}),
    ('blur', (40, 64), {'block_rows': 8}),
    ('jacobi3d', (12, 32, 32), {'tile': (2, 8, 32)}),
    ('jacobi3d', (12, 32, 32), {'block_rows': 4}),
    ('jacobi3d', (12, 32, 32), {'mid_tile': 8}),
    ('jacobi3d', (12, 32, 32), {'block_rows': 2, 'mid_tile': 16}),
    ('blur', (40, 64), {'stream_loop': True}),
    ('blur', (40, 64), {'stream_loop': 'peel'}),
    ('jacobi3d', (12, 32, 32), {'stream_loop': 'peel', 'prefetch': 3}),
    ('jacobi3d', (12, 32, 32), {'stream_loop': True, 'prefetch': 4}),
    ('jacobi3d', (12, 32, 32), {'dma_split': 2}),
    ('blur', (40, 64), {'out_dma': True}),
    ('contrast', (40, 64), {'block_rows': 8}),
)


@pytest.mark.parametrize('name,shape,keys', PUBLIC_KEYS,
                         ids=['%s-%s' % (c[0], '-'.join(
                             '%s=%s' % kv for kv in sorted(c[2].items())))
                              for c in PUBLIC_KEYS])
def test_public_keys_build_the_short_form(name, shape, keys):
  """Each public tile and mode key builds the short form with the grid's
  default elements ('walk' on under ``stream_loop``, in 2-D too), at the
  tile given or with the fixed extents, carrying the modes."""
  stencil, _ = _small(name)
  plan = tile_plan.kernel_plan(stencil, shape, **keys)
  short = plan.short
  assert short is not None and plan.deep is None
  want = tile_plan.short_default(len(shape))
  if keys.get('stream_loop'):
    want = tile_plan.short_elements(want + ('walk',))
  assert short.elements == want
  assert plan.config == tile_plan.kernel_config(
      len(shape), **{k: v for k, v in keys.items()
                     if k not in ('tile', 'block_rows', 'mid_tile')})
  if 'tile' in keys:
    assert plan.tile == keys['tile']
  assert plan.tile[0] == keys.get('block_rows', plan.tile[0])
  assert plan.tile[1] == keys.get('mid_tile', plan.tile[1])
  assert short.depth == (keys.get('prefetch', 2) if short.has('walk') else 2)
  if keys.get('stream_loop'):
    assert plan.steps == tile_plan.steps_per_cta(plan.grid)
  assert bool(plan.staging) == bool(keys.get('out_dma'))
  assert plan.smem_bytes <= tile_plan.SMEM_LIMIT
  old = tile_plan.kernel_plan(stencil, shape, **keys, _short=())
  assert old.short is None and old.config == plan.config


def test_fixed_extents_pick_among_the_rules_tiles():
  """block_rows and mid_tile fix axes 0 and 1; the rule weighs the
  short_tiles that keep them (else the default form's tile with them)."""
  name, shape, overrides = next(c for c in OTHERS if c[0] == 'jacobi3d')
  stencil = testing.build_cell(name, overrides)
  for keys in ({'block_rows': 4}, {'mid_tile': 8},
               {'block_rows': 1, 'mid_tile': 32}):
    plan = tile_plan.kernel_plan(stencil, shape, **keys)
    keep = [t for t in tile_plan.short_tiles(shape, True)
            if t[0] == keys.get('block_rows', t[0]) and
            t[1] == keys.get('mid_tile', t[1])]
    assert plan.tile in keep, (keys, plan.tile)
  plan = tile_plan.kernel_plan(stencil, shape, block_rows=16)
  assert plan.tile[0] == 16 and plan.short is not None


def test_peel_builds_the_text_of_true():
  """'peel' on the short form: a step inside every stage's valid region
  already runs in the interior class, with no axis-0 checks, so both
  values build one kernel."""
  from soda_tpu_torch.backend import cuda_source
  stencil, shape = _small('jacobi3d')
  texts = {mode: cuda_source.generate(tile_plan.kernel_plan(
      stencil, shape, stream_loop=mode)).text for mode in (True, 'peel')}
  assert texts[True] == texts['peel']
  olds = {mode: cuda_source.generate(tile_plan.kernel_plan(
      stencil, shape, stream_loop=mode, _short=())).text
          for mode in (True, 'peel')}
  assert olds[True] != olds['peel']


def test_elements_that_cannot_serve_the_tile_go_off():
  """At an explicit tile: 'vector' off where the rows are not whole
  16-byte units (and where 1-byte cells meet 8-byte ones), the default's
  walk off where its rings do not fit, each named in the plan (the
  source says one cell a thread); a tile the form cannot hold raises
  with its bytes."""
  from soda_tpu_torch.backend import cuda_source
  stencil, _ = _small('blur')
  plan = tile_plan.kernel_plan(stencil, (40, 60), tile=(8, 64))
  assert plan.short.vec == 1 and 'vector' in plan.short.off
  assert not plan.short.has('vector') and 'vector' not in plan.short.on
  assert 'one cell a thread' in cuda_source.generate(plan).text
  mixed = testing.mode_stencil('fuzz213')  # uint8 beside 8-byte inputs
  assert tile_plan.kernel_plan(mixed, (8, 16), tile=(2, 16)).short.vec == 1
  name, shape, overrides = next(c for c in OTHERS if c[0] == 'denoise3d')
  stencil = testing.build_cell(name, overrides)
  plan = tile_plan.kernel_plan(stencil, shape, tile=(4, 16, 128))
  assert 'walk' in plan.short.off and plan.steps == 1
  assert plan.smem_bytes <= tile_plan.SMEM_LIMIT
  with pytest.raises(soda_tpu_torch.utils.InputError,
                     match=r'needs \d+ bytes .* at tile \(4, 16, 128\)'):
    tile_plan.kernel_plan(stencil, shape, tile=(4, 16, 128),
                          stream_loop=True)


# -- the schedule checkers ----------------------------------------------------
def check_schedule(plan, barriers=None):
  """Raise AssertionError where the short form's shared-memory schedule
  races. Positions: -1 is the input fill, k the plan's stage k; a
  barrier at index k runs between positions k - 1 and k; a stage reads
  its parents' buffers and those its register stages read. Each buffer
  covers its rows' bytes from its offset, its slack included. Under
  'walk' a barrier opens every step, before its first stage."""
  stencil, short = plan.stencil, plan.short
  barriers = sorted(short.barriers if barriers is None else barriers)
  stages = [s for s in plan.stages if s.name not in short.values]
  if short.has('walk'):
    barriers = sorted(set(barriers) | {plan.stages.index(stages[0])})
  by_name = {s.name: s for s in plan.stages}

  def reads(stage):
    names, todo = set(), [stage]
    while todo:
      for parent in todo.pop().load_offsets:
        if parent in short.values:
          todo.append(by_name[parent])
        else:
          names.add(parent)
    return names

  def between(a, b):
    return any(a < k <= b for k in barriers)

  span = {}
  for name, start in plan.offsets.items():
    itemsize = plan.dtype(name).np_dtype.itemsize
    before, after = short.slack[name]
    span[name] = (start - before * itemsize, start + (
        _rows(plan, name) * short.pitch(name) + after) * itemsize)
    assert 0 <= span[name][0] and span[name][1] <= plan.smem_bytes, name
  write = {n: -1 for n in stencil.input_names if n in plan.offsets}
  read = {n: [] for n in plan.offsets}
  index = {s.name: k for k, s in enumerate(plan.stages)}
  for stage in stages:
    k = index[stage.name]
    if stage.name in plan.offsets:
      write[stage.name] = k
    for parent in reads(stage):
      read[parent].append(k)
  for name, at in read.items():
    for k in at:
      assert write[name] < k and between(write[name], k), (
          'stage %d reads %s, written at %d, with no barrier between' %
          (k, name, write[name]))
  last = {n: max([write[n]] + read[n]) for n in write}
  names = sorted(write, key=write.get)
  for i, x in enumerate(names):
    for y in names[i + 1:]:
      (a0, a1), (b0, b1) = span[x], span[y]
      if a0 < b1 and b0 < a1:
        assert last[x] < write[y] and between(last[x], write[y]), (
            '%s is written over by %s with no barrier between' % (x, y))


def check_rings(plan, rings=None):
  """Raise AssertionError where a walk's rings lose a row: each buffer
  stepped through a run, its rows placed as the kernel places them
  (the phase advancing by tile[0] a step, a later step writing only the
  rows it does not share, an input's next rows written during the
  step)."""
  short, t0 = plan.short, plan.tile[0]
  rings = short.rings if rings is None else rings
  for name, size in rings.items():
    neg, pos = plan.spans[name][0][0], plan.spans[name][1][0]
    ext0 = t0 + neg + pos
    fresh = min(t0, ext0)
    is_input = name in plan.stencil.input_names
    held = {}  # ring row -> global row

    def put(step, rows, step_rows):
      phase = (step * t0) % size
      for e in rows:
        slot = (phase + e) % size
        old = held.get(slot)
        assert old is None or old not in step_rows or old == \
            step * t0 - neg + e, (name, step, e, 'overwrites a row in use')
        held[slot] = step * t0 - neg + e

    for step in range(max(plan.steps, 3)):
      rows = range(ext0) if step == 0 else range(ext0 - fresh, ext0)
      now = {step * t0 - neg + e for e in range(ext0)}
      if step == 0 or not is_input:
        put(step, rows, now)
      phase = (step * t0) % size
      for e in range(ext0):
        assert held.get((phase + e) % size) == step * t0 - neg + e, (
            name, step, e, 'not in its ring row')
      if is_input:  # the next step's rows land while this one computes
        put(step + 1, range(ext0 - fresh, ext0), now)


def _walk_plan(stencil, shape, tile):
  with _one_sm():
    return make_tile_plan(stencil, shape, tile, _short=ELEMENTS)


def _schedule_plans():
  out = [('%s bench' % c[0], c) for c in OTHERS]
  out += [('fuzz%d' % seed, seed) for seed, _, _ in FUZZ]
  return out


@pytest.mark.parametrize('label,key', _schedule_plans(),
                         ids=[p[0] for p in _schedule_plans()])
def test_schedule_is_free_of_races(label, key):
  if isinstance(key, tuple):
    name, shape, overrides = key
    plan = make_tile_plan(testing.build_cell(name, overrides), shape)
  else:
    _, stencil, shape = next(c for c in FUZZ if c[0] == key)
    plan = make_tile_plan(stencil, shape)
  check_schedule(plan)
  walk = _walk_plan(plan.stencil, plan.shape, plan.tile)
  check_schedule(walk)
  check_rings(walk)
  assert label


@pytest.mark.parametrize('name', ['erosion', 'denoise3d'])
def test_removing_any_barrier_races(name):
  plan = make_tile_plan(*_small(name))
  walk = _walk_plan(plan.stencil, plan.shape, plan.tile)
  for p in (plan, walk):
    barriers = p.short.barriers
    first = p.stages.index(next(s for s in p.stages
                                if s.name not in p.short.values))
    assert barriers
    for b in barriers:
      if p.short.has('walk') and b == first:
        continue  # the step's own barrier stands in for it
      with pytest.raises(AssertionError):
        check_schedule(p, [k for k in barriers if k != b])


@pytest.mark.parametrize('name', ['erosion', 'denoise3d', 'blur'])
def test_a_ring_a_row_short_loses_a_row(name):
  stencil, shape = _small(name)
  walk = _walk_plan(stencil, shape, (4,) + shape[1:])
  assert walk.steps > 1
  check_rings(walk)
  shorter = [n for n, rows in walk.short.rings.items()
             if rows > min(walk.tile[0], walk.extent(n)[0])]
  assert shorter
  for name_ in shorter:
    with pytest.raises(AssertionError):
      check_rings(walk, dict(walk.short.rings, **{
          name_: walk.short.rings[name_] - 1}))


# -- the generated text under the emulation -----------------------------------
STEPS = [('default', ())] + [
    ('+'.join(ELEMENTS[:k + 1]), ELEMENTS[:k + 1])
    for k in range(len(ELEMENTS))]
EMU_CASES = tuple(
    ('denoise2d', (40, 64), (8, 16), elements) for _, elements in STEPS) + \
    tuple(('denoise3d', (12, 24, 96), (2, 8, 32), elements)
          for _, elements in STEPS) + (
        ('erosion', (48, 96), (8, 32), ()),
        ('erosion', (48, 96), (8, 32), ELEMENTS[:4]),
        ('erosion', (48, 96), (8, 32), ELEMENTS),
        ('sobel2d', (40, 64), (8, 32), ()),
        ('sobel2d', (40, 64), (8, 32), ELEMENTS),
        ('blur', (37, 53), (8, 16), ELEMENTS),  # ragged: the element path
        ('multi_output', (29, 35), (8, 16), ELEMENTS),
        ('read_below', (40, 32), (4, 32), ELEMENTS),  # an output's rows
        ('conv_param', (24, 64), (8, 32), ELEMENTS),
        ('line1d', (500,), (64,), ELEMENTS),  # 16-byte rows of a 1-D grid
        ('line1d', (498,), (64,), ELEMENTS),  # and the element path
    ) + tuple(('fuzz%d' % seed, shape, None, ELEMENTS)
              for seed, _, shape in FUZZ[:1] + FUZZ[-1:])
LINE1D = '''
kernel: line1d
burst width: 64
unroll factor: 1
iterate: 1
input dram 0 float: x(*)
local float: t(0) = x(-1) + x(0) * 2.0f + x(1)
output dram 1 float: y(0) = t(-2) - t(2)
'''
# an output another output reads a row below and above: a walk's step
# stores the rows of its tile that the step before computed
READ_BELOW = '''
kernel: readbelow
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 float: src(32, *)
output dram 1 float: o0(0, 0) = src(0, 1) + src(0, -1) * 2.0f
output dram 2 float: o1(0, 0) = o0(0, 1) - o0(0, -1)
'''
PROGRAMS = {'multi_output': testing.MULTI_OUTPUT,
            'conv_param': testing.CONV_PARAM, 'line1d': LINE1D,
            'read_below': READ_BELOW}
# (case index, replicas, cp.async landing at once)
REPLICATED = (len(STEPS) - 1, 2, True)


def _emu_plan(case):
  name, shape, tile, elements = case
  if name in PROGRAMS:
    stencil = build_stencil(PROGRAMS[name])
  elif name.startswith('fuzz'):
    stencil = next(st for seed, st, _ in FUZZ if 'fuzz%d' % seed == name)
  else:
    stencil, _ = _small(name)
  with _one_sm():
    return make_tile_plan(stencil, shape, tile, _short=elements)


def _case_id(case):
  return '%s-%s-%s' % (case[0], 'x'.join(map(str, case[1])),
                       '+'.join(case[3]) or 'default')


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
  """Each case's outputs from its emulated kernel (compilers at once),
  and the replicated run's."""
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('no g++ on this machine')
  tmp = tmp_path_factory.mktemp('short_emu')
  plans = [_emu_plan(case) for case in EMU_CASES]

  def emulate(index, reps=1, eager=False):
    plan = plans[index]
    exe = compile_kernel(gxx, tmp, index + 100 * (reps - 1), plan, reps)
    grids = [testing.make_inputs(plan.stencil, plan.shape, 7 + r)
             for r in range(reps)]
    params = reference.make_test_params(plan.stencil)
    outs = run_kernel(exe, tmp, plan.stencil, grids, params, eager)
    return plan, grids, params, [
        {n: o.reshape((reps,) + plan.shape)[r] for n, o in
         zip(plan.stencil.output_names, outs)} for r in range(reps)]

  with concurrent.futures.ThreadPoolExecutor(4) as pool:
    runs = list(pool.map(emulate, range(len(EMU_CASES))))
    index, reps, eager = REPLICATED
    replicated = pool.submit(emulate, index, reps, eager).result()
  return runs, replicated


def _plain(stencil, shape, grid, params):
  args = prepare_args(stencil, shape, torch.device('cpu'), grid, params)
  n_in = len(stencil.input_names)
  return dict(zip(stencil.output_names,
                  fused_stencil_plain(stencil, args[:n_in], args[n_in:])))


@pytest.mark.parametrize('index', range(len(EMU_CASES)),
                         ids=[_case_id(c) for c in EMU_CASES])
def test_emulated_kernel_matches_plain(emulated, index):
  plan, grids, params, got = emulated[0][index]
  stencil, shape = plan.stencil, plan.shape
  elements = EMU_CASES[index][3]
  assert (plan.short is not None) == bool(elements)
  testing.check_exact(stencil, shape, got[0],
                      _plain(stencil, shape, grids[0], params),
                      '%s vs plain' % _case_id(EMU_CASES[index]))
  with np.errstate(all='ignore'):
    want = reference.run(stencil, grids[0], params)
  testing.check_outputs(stencil, shape, got[0], want,
                        '%s vs the oracle' % _case_id(EMU_CASES[index]))


@pytest.mark.parametrize('name', ['denoise2d', 'denoise3d', 'erosion',
                                  'sobel2d'])
def test_emulated_steps_equal_the_default_form(emulated, name):
  """Every element step's text bit for bit against the default form's
  at the same tile."""
  rows = [(case, out) for case, out in zip(EMU_CASES, emulated[0])
          if case[0] == name]
  base = next(out for case, out in rows if case[3] == ())
  assert len(rows) >= 2
  for case, (plan, _, _, got) in rows:
    testing.check_exact(plan.stencil, plan.shape, got[0], base[3][0],
                        '%s vs the default form' % _case_id(case))


def test_emulated_replicas_with_copies_landing_at_once(emulated):
  plan, grids, params, got = emulated[1]
  assert plan.short.has('walk') and plan.short.vec > 1
  for r, grid in enumerate(grids):
    testing.check_exact(plan.stencil, plan.shape, got[r],
                        _plain(plan.stencil, plan.shape, grid, params),
                        'replica %d' % r)


def test_emulated_cases_have_interior_and_edge_tiles_and_runs():
  for index in (len(STEPS) - 1, 2 * len(STEPS) - 1):
    plan = _emu_plan(EMU_CASES[index])
    short = plan.short
    assert plan.steps > 1 and short.vec > 1, EMU_CASES[index]
    interior = [o for o in np.ndindex(*plan.grid) if all(
        lo <= i * t <= hi for i, t, (lo, hi) in zip(o, plan.tile,
                                                    short.interior))]
    assert 0 < len(interior) < plan.n_tiles, (EMU_CASES[index],
                                              short.interior)


# -- the main path against the JAX package ------------------------------------
@pytest.mark.parametrize('name', [c[0] for c in OTHERS])
def test_cell_matches_the_jax_executor(name):
  stencil, shape = _small(name)
  overrides = dict(next(c for c in testing.CELLS if c[0] == name)[2],
                   tile_size=tuple(reversed(shape[1:])) + (0,))
  source = corpus.CORPUS['jacobi3d' if name == 'jacobi3d_256' else name]
  jax_stencil = soda_tpu.build_stencil(source, **overrides)
  ex = soda_tpu_torch.get_executor(stencil, shape, device='cpu')
  assert ex.plan.short is not None
  assert ex.plan.short.elements == tile_plan.short_default(len(shape))
  inputs = reference.make_test_inputs(stencil, shape)
  got = ex(inputs)
  want = soda_tpu.get_executor(jax_stencil, shape)(inputs, {})
  for out in stencil.output_names:
    region = reference.output_valid_slices(stencil, shape, out)
    assert_close_reference(got[out].numpy()[region],
                           np.asarray(want[out])[region],
                           stencil.symbol_table[out].is_float,
                           '%s:%s' % (name, out))
