"""The generated CUDA source, checked without nvcc.

The generator emits, behind ``#ifndef __CUDACC__``, a whole-grid host
loop over the same printed stage functions and soda_stencil.cuh helpers
the kernel uses. Here a host C++ compiler builds it (floating-point
contraction off, as ``--fmad=false`` does on the card; undefined
behaviour trapped where the toolchain links the sanitizer) and it is
held against the NumPy oracle on the 11 corpus kernels and the
semantics fuzz programs: integers bit-exact, floats within the
reference threshold; with two replicas, each grid at its own offset.
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
from soda_tpu_torch.testing import (CELLS, FUZZ_SEEDS, FUZZ_SHAPE, build_cell,
                                    check_outputs, gen_program, make_inputs,
                                    replica_inputs)

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
  for name, st, shape, _, _ in CASES:
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
# source, as the fused kernel's generator printed it before the sharded
# executor existed: the sharded path changes no kernel source. The
# stencils are built with the in-process schedulers under _StepClock.
CELL_SOURCES = {
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
def test_cell_source_is_unchanged(name, shape, overrides, monkeypatch):
  monkeypatch.setattr(cr_schedules, 'find_external_cr', lambda: None)
  monkeypatch.setattr(cr_schedules, 'time', _StepClock())
  text = cuda_source.generate(make_tile_plan(build_cell(name, overrides),
                                             shape)).text
  assert hashlib.sha256(text.encode()).hexdigest()[:16] == CELL_SOURCES[name]


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
