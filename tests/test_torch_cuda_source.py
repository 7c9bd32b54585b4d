"""The generated CUDA source, checked without nvcc.

The generator emits, behind ``#ifndef __CUDACC__``, a whole-grid host
loop over the same printed stage functions and soda_stencil.cuh helpers
the kernel uses. Here a host C++ compiler builds it (floating-point
contraction off, as ``--fmad=false`` does on the card; undefined
behaviour trapped where the toolchain links the sanitizer) and it is
held against the NumPy oracle on the 11 corpus kernels and the
semantics fuzz programs: integers bit-exact, floats within the
reference threshold; with two replicas, each grid at its own offset.
On faults C5's and C6's programs and the conversion programs every
output equals the oracle's as a number (its casts round once).
The source (also of the grouped sub-stencils and of a sharded
executor's halo-extended shard) must not depend on the hash seed, the
12 benchmark cells' sources are pinned by their hashes, and the nvcc
command must keep IEEE float semantics.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from soda_tpu_torch import corpus
from soda_tpu_torch.api import build_stencil
from soda_tpu_torch.backend import build, cuda_source, reference
from soda_tpu_torch.backend.tile_plan import make_tile_plan
from soda_tpu_torch.optimization import cr_schedules
from soda_tpu_torch.testing import (CAST_SEEDS, CELLS, FUZZ_SEEDS, FUZZ_SHAPE,
                                    build_cell, check_exact, check_outputs,
                                    gen_cast_program, gen_program,
                                    make_cast_inputs, make_inputs,
                                    regression_cases, replica_inputs)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _cases():
  """(name, stencil, shape, inputs, params) of every program checked."""
  cases = []
  for name in sorted(corpus.CORPUS):
    st = corpus.build(name)
    shape = corpus.TEST_DIMS[name]
    cases.append((name, st, shape, reference.make_test_inputs(st, shape),
                  reference.make_test_params(st)))
  for seed in FUZZ_SEEDS:
    st = build_stencil(gen_program(seed))
    cases.append(('fuzz%d' % seed, st, FUZZ_SHAPE,
                  make_inputs(st, FUZZ_SHAPE, seed), {}))
  return cases


CASES = _cases()


def _cast_cases():
  """(name, stencil, shape, inputs, params) of faults C5 and C6 and the
  conversion programs (testing.CAST_SEEDS)."""
  cases = [(label.replace(' ', '-'), build_stencil(text), shape, inputs, {})
           for label, text, shape, inputs in regression_cases()]
  for seed in CAST_SEEDS:
    st = build_stencil(gen_cast_program(seed))
    cases.append(('cast%d' % seed, st, CAST_SHAPE,
                  make_cast_inputs(st, CAST_SHAPE, seed), {}))
  return cases


CAST_SHAPE = (24, 64)
CAST_CASES = _cast_cases()


def _flags(gxx, tmp):
  """Compiler flags, with the undefined-behaviour sanitizer when this
  toolchain can link it into a shared library."""
  base = ['-O2', '-ffp-contract=off', '-std=c++17', '-shared', '-fPIC',
          '-I', str(REPO / 'soda_tpu_torch' / 'csrc')]
  ubsan = ['-fsanitize=undefined', '-fno-sanitize-recover=all']
  probe = tmp / 'probe.cpp'
  probe.write_text('extern "C" int f(int a) { return a + 1; }\n')
  ok = subprocess.run([gxx, *base, *ubsan, '-o', str(tmp / 'probe.so'),
                       str(probe)], capture_output=True).returncode == 0
  return base + (ubsan if ok else [])


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
  """All cases' host loops in one shared library (one compiler run)."""
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('no g++ on this machine')
  tmp = tmp_path_factory.mktemp('host')
  sources, symbols = [], {}
  for name, st, shape, _, _ in CASES + CAST_CASES:
    kernel = cuda_source.generate(make_tile_plan(st, shape))
    path = tmp / ('%s.cpp' % name)
    path.write_text(kernel.text)
    sources.append(str(path))
    symbols[name] = kernel.host_symbol
  lib = tmp / 'host.so'
  proc = subprocess.run([gxx, *_flags(gxx, tmp), '-o', str(lib), *sources],
                        capture_output=True, text=True)
  assert proc.returncode == 0, proc.stderr[-4000:]
  return ctypes.CDLL(str(lib)), symbols


@pytest.mark.parametrize('case', range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_host_loop_matches_oracle(host_lib, case):
  lib, symbols = host_lib
  name, st, shape, inputs, params = CASES[case]
  with np.errstate(all='ignore'):
    want = reference.run(st, inputs, params)
  outs = {o: np.zeros(shape, st.symbol_table[o].np_dtype)
          for o in st.output_names}
  args = [np.ascontiguousarray(inputs[n]) for n in st.input_names]
  args += [np.ascontiguousarray(params[s.name]) for s in st.param_stmts]
  args += [outs[o] for o in st.output_names]
  assert _host_call(lib, symbols[name], args, 1) == 0
  check_outputs(st, shape, outs, want, name)


@pytest.mark.parametrize('case', range(len(CAST_CASES)),
                         ids=[c[0] for c in CAST_CASES])
def test_host_loop_rounds_casts_as_the_oracle(host_lib, case):
  """The kernel's conversions (``soda::d2h`` from double, ``cvt`` from
  uint64) round once: every output equal as a number to the oracle's."""
  lib, symbols = host_lib
  name, st, shape, inputs, params = CAST_CASES[case]
  with np.errstate(all='ignore'):
    want = reference.run(st, inputs, params)
  outs = {o: np.zeros(shape, st.symbol_table[o].np_dtype)
          for o in st.output_names}
  args = [np.ascontiguousarray(inputs[n]) for n in st.input_names]
  args += [outs[o] for o in st.output_names]
  assert _host_call(lib, symbols[name], args, 1) == 0
  check_exact(st, shape, outs, want, name, values=True)
  check_outputs(st, shape, outs, want, name)


def _host_call(lib, symbol, arrays, replicas):
  fn = getattr(lib, symbol)
  fn.argtypes = [ctypes.c_void_p] * len(arrays) + [ctypes.c_longlong]
  fn.restype = ctypes.c_int
  return fn(*[a.ctypes.data for a in arrays], replicas)


def test_host_loop_runs_each_replica_on_its_own_grid(tmp_path):
  """The replica axis: R grids laid out one after another, each read and
  written at its own offset (the kernel's ``blockIdx.y``)."""
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('no g++ on this machine')
  st = corpus.build('blur')
  shape = corpus.TEST_DIMS['blur']
  kernel = cuda_source.generate(make_tile_plan(st, shape))
  src = tmp_path / 'blur.cpp'
  src.write_text(kernel.text)
  lib = tmp_path / 'blur.so'
  proc = subprocess.run([gxx, *_flags(gxx, tmp_path), '-o', str(lib),
                         str(src)], capture_output=True, text=True)
  assert proc.returncode == 0, proc.stderr[-4000:]
  grids = replica_inputs(st, shape, 2)
  batch = np.ascontiguousarray(np.stack([g['input'] for g in grids]))
  out = np.zeros((2,) + shape, np.uint16)
  assert _host_call(ctypes.CDLL(str(lib)), kernel.host_symbol, [batch, out],
                    2) == 0
  for k, grid in enumerate(grids):
    check_outputs(st, shape, {'blur_y': out[k]}, reference.run(st, grid),
                  'blur replica %d' % k)
  assert not np.array_equal(out[0], out[1])


_GENERATE = '''
import hashlib, sys
sys.path.insert(0, %r)
import numpy as np
import torch
from soda_tpu_torch import corpus
from soda_tpu_torch.backend import cuda_source
from soda_tpu_torch.backend.grouped import group_stencils
from soda_tpu_torch.backend.tile_plan import make_tile_plan
from soda_tpu_torch.parallel import mesh, spmd
greedy = {'optimizations': {'computation-reuse': 'greedy'}}
_, subs = group_stencils(corpus.build('denoise2d', cluster='coarse'))
subs = [(sub.app_name, sub, corpus.TEST_DIMS['denoise2d']) for sub in subs]
cases = [(name, corpus.build(name, **ov), corpus.TEST_DIMS[name])
         for name, ov in (('denoise2d', {}), ('denoise3d', {}), ('sobel2d', {}),
                          ('seidel2d', greedy), ('erosion', greedy))]
# a 2x2 mesh's halo-extended shard of seidel2d (diagonal taps)
st = corpus.build('seidel2d', **greedy)
square = mesh.Mesh(np.array([torch.device('cpu')] * 4,
                            dtype=object).reshape(2, 2), ('x', 'y'))
ext = spmd.geometry(st, (48, 64), square)[-1]
for name, st, shape in cases + subs + [('seidel2d-shard', st, ext)]:
  text = cuda_source.generate(make_tile_plan(st, shape)).text
  print(name, shape, hashlib.sha256(text.encode()).hexdigest())
'''


def test_source_is_independent_of_the_hash_seed():
  """The fusion plan's stage order varies with PYTHONHASHSEED
  (plan.py:256, :279-283); the generated source, which keys the build
  cache, must not."""
  outs = []
  for seed in ('1', '2'):
    env = dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS='cpu')
    proc = subprocess.run([sys.executable, '-c', _GENERATE % str(REPO)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    outs.append(proc.stdout)
  assert outs[0] == outs[1]
  # denoise2d: 8 groups; seidel2d's shard on a 2x2 mesh
  assert len(outs[0].splitlines()) == 5 + 8 + 1
  assert 'seidel2d-shard (28, 36)' in outs[0]


class _StepClock:
  """A stand-in for the ``time`` module whose clock advances a fixed
  step per reading, so the schedulers' time budgets end alike on every
  machine."""

  def __init__(self, step=0.5):
    self.now, self.step = 0.0, step

  def monotonic(self):
    self.now += self.step
    return self.now


# sha256 (first 16 hex digits) of each benchmark cell's generated
# source: contrast's is its many-stage form's (tile_plan.DeepForm), the
# other 11 cells' their short form's (tile_plan.ShortForm), each of which
# replaced the cell's default-form kernel (DEFAULT_FORM_SOURCES below).
# The stencils are built with the in-process schedulers under
# _StepClock.
CELL_SOURCES = {
    'blur': '256ad56d493dcb08',
    'jacobi2d': 'c90e599431937f2e',
    'jacobi3d': '608eee87dafc391a',
    'heat3d': '01391e246699aa2b',
    'seidel2d': '43c07e3c7182aa6d',
    'erosion': '15708285f89cd646',
    'sobel2d': '013ca9fa5ad16846',
    'xcorr': '351ab4efbd40d706',
    'contrast': '42ac5aed20698af9',
    'denoise2d': '79b58e9494414081',
    'denoise3d': 'dfc62828c7732efa',
    'jacobi3d_256': '2665808ca8fe26a5',
}


@pytest.mark.parametrize('name,shape,overrides', CELLS,
                         ids=[c[0] for c in CELLS])
def test_cell_source_is_unchanged(name, shape, overrides, monkeypatch):
  monkeypatch.setattr(cr_schedules, 'find_external_cr', lambda: None)
  monkeypatch.setattr(cr_schedules, 'time', _StepClock())
  text = cuda_source.generate(make_tile_plan(build_cell(name, overrides),
                                             shape)).text
  assert hashlib.sha256(text.encode()).hexdigest()[:16] == CELL_SOURCES[name]


# the default form's sources (tile_plan's ``_deep=()`` with
# ``_short=()``): every cell's as before the many-stage and the short
# form existed
DEFAULT_FORM_SOURCES = {
    'blur': 'dff6ad3b15226ca0',
    'jacobi2d': '495a9a06ca9ed1f6',
    'jacobi3d': 'eda28e44e9f8a911',
    'heat3d': 'eec52704f6db6d9a',
    'seidel2d': '876dd6e650f40ce5',
    'erosion': '987cbe8f820242a5',
    'sobel2d': 'ca2e7182a811ea45',
    'xcorr': 'baee7cc74bb9da95',
    'contrast': '28d3b85553c28a71',
    'denoise2d': '4ec236113b4143d5',
    'denoise3d': '307a08e9fdcd1777',
    'jacobi3d_256': '98d66f7c05fd9a9a',
}


@pytest.mark.parametrize('name,shape,overrides', CELLS,
                         ids=[c[0] for c in CELLS])
def test_default_form_source_is_unchanged(name, shape, overrides,
                                          monkeypatch):
  """The many-stage and the short form leave the default form's text as
  it was, and every cell's default kernel is now one of those forms."""
  monkeypatch.setattr(cr_schedules, 'find_external_cr', lambda: None)
  monkeypatch.setattr(cr_schedules, 'time', _StepClock())
  stencil = build_cell(name, overrides)
  text = cuda_source.generate(make_tile_plan(stencil, shape, _deep=(),
                                             _short=())).text
  assert hashlib.sha256(text.encode()).hexdigest()[:16] == \
      DEFAULT_FORM_SOURCES[name]
  default = cuda_source.generate(make_tile_plan(stencil, shape)).text
  assert default != text


def test_nvcc_command_keeps_ieee_floats():
  cmd = build.nvcc_command('nvcc', 'k.cu', 'k.so')
  assert 'arch=compute_90a,code=sm_90a' in cmd
  assert '--fmad=false' in cmd
  assert not any('fast_math' in c or 'fast-math' in c for c in cmd)
  assert '-O3' in cmd and '-shared' in cmd


def test_source_note_names_the_tpu_kernel_and_the_bound():
  st = corpus.build('blur')
  text = cuda_source.generate(make_tile_plan(st, (40, 64))).text
  head = text.split('#include')[0]
  assert 'pallas_kernel.py PallasExecutor._build' in head
  assert 'bytes' in head and 'one pass over device' in head


def test_float_literals_print_exactly():
  from soda_tpu_torch.ir.types import Type
  f = Type('float')
  # seidel2d's .1111111f
  assert cuda_source.literal(0.1111111, f) == '(0x1.c71c6ep-4f)'
  assert cuda_source.literal(-0.0, f) == '(-0x0.p+0f)'
  assert cuda_source.literal(0.1, Type('double')) == '(0x1.999999999999ap-4)'
  assert cuda_source.literal(-2**31, Type('int32')) == \
      '((int32_t)(-2147483647ll - 1))'
  assert cuda_source.literal(-1, Type('uint32')) == '((uint32_t)4294967295ull)'


# the old kernels the public keys built before the short form took them:
# ``_short=()`` with the same keys keeps them byte for byte. Each row of
# testing.MODE_CELLS (the old mode kernel, _mode_kernel), and each short
# cell's default form at the rule's tile, its axis-0 extent halved
# (jacobi3d_256, whose rule takes 1: its axis-1 extent) and doubled
# (_kernel), and jacobi3d_256 with the JAX seeds' block_rows and mid_tile
OLD_FORM_SOURCES = (
    ('blur', {'stream_loop': True}, 'c0e1c51b7f5e86c3'),
    ('blur', {'stream_loop': 'peel'}, 'e6d4450644ee5856'),
    ('erosion', {'stream_loop': True}, 'a15bba6645706bfa'),
    ('erosion', {'stream_loop': 'peel'}, 'c826b7dc15070a7f'),
    ('jacobi3d', {'stream_loop': True}, 'ce76d122369e0992'),
    ('jacobi3d', {'stream_loop': 'peel'}, '810b754035a2becd'),
    ('heat3d', {'stream_loop': True}, 'c6eee5d1c33cea55'),
    ('heat3d', {'stream_loop': 'peel'}, '03ef746035e03a9d'),
    ('denoise2d', {'stream_loop': True}, '89aa565da0f15d57'),
    ('denoise2d', {'stream_loop': 'peel'}, '7ac6048cca53e2fe'),
    ('jacobi3d_256', {'stream_loop': True}, '037fe0b87745bcae'),
    ('jacobi3d_256', {'stream_loop': 'peel'}, '8ac6294e3e33c2e1'),
    ('jacobi3d', {'prefetch': 3, 'stream_loop': 'peel'}, '9e41a3e16fd72846'),
    ('jacobi3d_256', {'prefetch': 3, 'stream_loop': 'peel'},
     '1d2263b5bfaac92c'),
    ('heat3d', {'dma_split': 2}, '14d4725d2a20b83d'),
    ('jacobi3d', {'dma_split': 2}, '4ffc929207e7147d'),
    ('blur', {'out_dma': True}, '9f91bc59cbb24833'),
    ('erosion', {'out_dma': True}, 'ba7b0e29dfdc243b'),
    ('blur', {'tile': (64, 256)}, '41d1815e65b578c6'),
    ('blur', {'tile': (32, 256)}, 'e48c438e9ade1ad3'),
    ('blur', {'tile': (128, 256)}, '19b4c305193dcaa5'),
    ('jacobi2d', {'tile': (64, 128)}, '495a9a06ca9ed1f6'),
    ('jacobi2d', {'tile': (32, 128)}, '5c4684044af078a1'),
    ('jacobi2d', {'tile': (128, 128)}, '1695e7e3be4f1baa'),
    ('jacobi3d', {'tile': (2, 16, 128)}, '37d269c774890797'),
    ('jacobi3d', {'tile': (1, 16, 128)}, '195222ac336d4fe8'),
    ('jacobi3d', {'tile': (4, 16, 128)}, 'ef079a71308d667a'),
    ('heat3d', {'tile': (2, 16, 128)}, 'c3bacac570abfff0'),
    ('heat3d', {'tile': (1, 16, 128)}, 'ff2a700b1d761e79'),
    ('heat3d', {'tile': (4, 16, 128)}, 'cc49e9017ce9f236'),
    ('seidel2d', {'tile': (64, 128)}, '876dd6e650f40ce5'),
    ('seidel2d', {'tile': (32, 128)}, 'fec2bdeb41c729ed'),
    ('seidel2d', {'tile': (128, 128)}, '7e2763b7c1378ec5'),
    ('erosion', {'tile': (32, 128)}, '48a62c398908660b'),
    ('erosion', {'tile': (16, 128)}, '58981c60b469c654'),
    ('erosion', {'tile': (64, 128)}, '987cbe8f820242a5'),
    ('sobel2d', {'tile': (32, 256)}, 'deaf13f4b7dd554f'),
    ('sobel2d', {'tile': (16, 256)}, 'd99c13501f86e5de'),
    ('sobel2d', {'tile': (64, 256)}, '5b18cea29169f72d'),
    ('xcorr', {'tile': (32, 128)}, '63af6841c2e4fc06'),
    ('xcorr', {'tile': (16, 128)}, 'bdb43da4840ffd31'),
    ('xcorr', {'tile': (64, 128)}, 'baee7cc74bb9da95'),
    ('denoise2d', {'tile': (64, 128)}, '507ed32463b1002f'),
    ('denoise2d', {'tile': (32, 128)}, '4ec236113b4143d5'),
    ('denoise2d', {'tile': (128, 128)}, 'a54face0259d3aab'),
    ('denoise3d', {'tile': (2, 16, 128)}, 'ba77c04cf4005d50'),
    ('denoise3d', {'tile': (1, 16, 128)}, '826e217c3fda0281'),
    ('denoise3d', {'tile': (4, 16, 128)}, 'a8c51b20366b84ae'),
    ('jacobi3d_256', {'tile': (1, 32, 128)}, '58d8c5e765bacaa3'),
    ('jacobi3d_256', {'tile': (1, 16, 128)}, '10591c761980cd94'),
    ('jacobi3d_256', {'tile': (2, 32, 128)}, '99ffe4d68e7f80ce'),
    ('jacobi3d_256', {'block_rows': 16}, 'd8b17f92726baca9'),
    ('jacobi3d_256', {'mid_tile': 64}, 'b083512bd557a41a'),
)
_STENCILS = {}


def _bench_stencil(name):
  """A benchmark cell's stencil, built once under _StepClock."""
  if name not in _STENCILS:
    saved = cr_schedules.find_external_cr, cr_schedules.time
    cr_schedules.find_external_cr = lambda: None
    cr_schedules.time = _StepClock()
    try:
      _STENCILS[name] = build_cell(name, dict(
          (n, o) for n, _, o in CELLS)[name])
    finally:
      cr_schedules.find_external_cr, cr_schedules.time = saved
  return _STENCILS[name]


@pytest.mark.parametrize('name,keys,digest', OLD_FORM_SOURCES,
                         ids=['%s-%s' % (n, '-'.join(
                             '%s=%s' % kv for kv in sorted(k.items())))
                              for n, k, _ in OLD_FORM_SOURCES])
def test_old_form_source_is_unchanged(name, keys, digest):
  """``_short=()`` with the public keys builds the old kernels byte for
  byte; without it the same keys build the short form."""
  from soda_tpu_torch.backend.tile_plan import kernel_plan
  stencil = _bench_stencil(name)
  shape = dict((n, s) for n, s, _ in CELLS)[name]
  old = kernel_plan(stencil, shape, **keys, _short=())
  text = cuda_source.generate(old).text
  assert old.short is None
  assert hashlib.sha256(text.encode()).hexdigest()[:16] == digest
  new = kernel_plan(stencil, shape, **keys)
  assert new.short is not None and new.config == old.config


@pytest.mark.parametrize('name,shape,overrides', CELLS,
                         ids=[c[0] for c in CELLS])
def test_rule_tile_gives_the_default_kernel(name, shape, overrides):
  """``tile=`` the short form's own tile builds the default kernel's
  source, digest and all (contrast's default is the many-stage form:
  there the tile builds the short form at the many-stage form's tile)."""
  from soda_tpu_torch.backend.tile_plan import kernel_plan
  stencil = _bench_stencil(name)
  default = make_tile_plan(stencil, shape)
  got = kernel_plan(stencil, shape, tile=default.tile)
  if name == 'contrast':
    assert default.deep is not None and got.short is not None
    return
  assert cuda_source.generate(got).digest == \
      cuda_source.generate(default).digest
  assert got == default


# (index into testing.SEED_CONFIGS + LAYOUT_EXTRA, digest): the rows that
# carry a layout key, at their CPU shapes (testing.seed_small), built with
# ``_short=()``: the old layout forms (WarpPlan, _value_blocks, _kernel
# and _mode_kernel), byte for byte
OLD_LAYOUT_SOURCES = (
    (0, 'cf097f7c947a73f5'), (3, 'e0722c75bb650d35'),
    (6, '37534bda147ae01d'), (8, 'ac2cfdd572de7e9a'),
    (9, 'a9503d2d1d4a1d3e'), (10, '1bb8861885804b14'),
    (11, 'c0153ae12a1efe7e'), (12, 'da9dc81c5ad0c75c'),
    (13, 'da9dc81c5ad0c75c'), (14, '4545d42d9d465d4e'),
    (15, '866b9794534fa93d'), (18, '175eda75bf0ee730'),
    (19, '645007e747ecb4d4'), (20, '95eb1163d588db1c'),
    (21, 'f9b158efa6c53367'), (22, '412f8841cf0f2a87'),
    (23, '3eb333be26f2ea17'), (24, '6597c53763ffccf3'),
    (25, 'b00a3760cae2d965'),
)


def _seed_plan(index, **extra):
  """The plan of a seed row at its CPU shape (MIN_CTAS 1, as the CPU
  tests run the seeds)."""
  from soda_tpu_torch import testing
  from soda_tpu_torch.backend import tile_plan
  name, shape, overrides, keys = (testing.SEED_CONFIGS +
                                  testing.LAYOUT_EXTRA)[index]
  small, overrides = testing.seed_small(name, shape, overrides)
  stencil = build_cell(name, overrides)
  saved = tile_plan.MIN_CTAS
  tile_plan.MIN_CTAS = 1
  try:
    return tile_plan.kernel_plan(stencil, small, **keys, **extra)
  finally:
    tile_plan.MIN_CTAS = saved


@pytest.mark.parametrize('index,digest', OLD_LAYOUT_SOURCES,
                         ids=['%s-%d' % ((__import__('soda_tpu_torch.testing')
                                          .testing.SEED_CONFIGS +
                                          __import__('soda_tpu_torch.testing')
                                          .testing.LAYOUT_EXTRA)[i][0], i)
                              for i, _ in OLD_LAYOUT_SOURCES])
def test_old_layout_source_is_unchanged(index, digest):
  """``_short=()`` with a layout key builds the old layout form byte for
  byte; without it the same keys build the short form with its layout
  element (no warp window)."""
  old = _seed_plan(index, _short=())
  assert old.short is None and old.layout is not None
  assert cuda_source.generate(old).digest == digest
  new = _seed_plan(index)
  assert new.short is not None and new.warp is None
  assert new.config == old.config
  assert new.short.layout and new.short.layout[0] in ('region', 'chunk')


def test_roll_and_window_build_one_source():
  """shift_mode roll and window come to the same Hopper kernel (the
  window's edge columns, which a wrapped rotate would fill, are never
  stored): one source, one digest; so do rotate with and without
  transposed lane regions."""
  from soda_tpu_torch.backend.tile_plan import kernel_plan
  stencil = _bench_stencil('erosion')
  shape = (256, 512)
  texts = {cuda_source.generate(kernel_plan(
      stencil, shape, stage_mode='value', block_rows=32, **keys)).digest
           for keys in ({'shift_mode': 'roll'},
                        {'shift_mode': 'window', 'lane_shift': 'rotate'},
                        {'shift_mode': 'roll', 'transpose_lanes': 'on'})}
  assert len(texts) == 1


def test_compute_chunk_builds_the_short_form_at_its_tile():
  """compute_chunk (L4) is the short form at the tile its structural
  keys give, one source with it: the short form's stage loops already
  give each thread fixed cells of every chunk of planes."""
  from soda_tpu_torch.backend.tile_plan import kernel_plan
  stencil = _bench_stencil('jacobi3d_256')
  shape = (256, 256, 256)
  chunked = kernel_plan(stencil, shape, mid_tile=64, compute_chunk=8)
  plain = kernel_plan(stencil, shape, mid_tile=64)
  assert chunked.layout.form == 'L4' and chunked.short.layout == ('chunk',)
  assert chunked.short.region is None and chunked.tile == plain.tile
  assert cuda_source.generate(chunked).text == cuda_source.generate(
      plain).text
