"""The narrow probe's CUDA text, run on the CPU through a g++ emulation.

There is no nvcc without a card, so ``csrc/probe_narrow.cu`` is compiled
with g++ (under UBSan) against a small emulation of what it uses: a CTA
is 256 host threads (``threadIdx``) with a barrier of their own
(``__syncthreads``) and a shared-memory buffer filled with a non-zero
pattern first; an ordinary launch runs its CTAs one after another, a
cooperative one all at once with a barrier across them
(``grid.sync``); ``__vmins2``, ``__vadd2`` and ``__byte_perm`` as
the CUDA and PTX manuals define them. The launch syntax is rewritten
into calls of the emulation and the empty ``asm`` statements that keep
nvcc from folding iterations are dropped; nothing else changes. The
library is loaded with ctypes and called as ``narrow.narrow_probe``
calls the card's, with CPU pointers. Every body runs at a small shape
(its strips of 256 cells, two CTAs, lines that wrap within them) and is
held bit for bit (floats: within ``probes.CHAIN_RTOL``) to its plain
version at 1, 2 and 5 iterations (a register chain also at
``narrow.EW_UNROLL`` + 5, through its main loop). The card runs the same text
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import ctypes
import dataclasses
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from soda_tpu_torch.experiments import copyshift, narrow, probes

CSRC = (pathlib.Path(__file__).resolve().parents[1] / 'soda_tpu_torch' /
        'csrc' / narrow.SOURCE)
# the small block every body runs on: a strip holds 256 cells (8 rows of
# 32 lanes, or 16 columns of 16 rows), so two CTAs cover it
SMALL = (16, 32)

PRELUDE = r'''
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __align__(n) alignas(n)

struct SodaDim { unsigned x = 0, y = 0, z = 0; };
static thread_local SodaDim threadIdx, blockIdx;
static SodaDim blockDim, gridDim;
static thread_local std::barrier<>* soda_emu_cta = nullptr;
static thread_local unsigned char* soda_emu_smem = nullptr;
static std::barrier<>* soda_emu_grid = nullptr;
static void __syncthreads() { soda_emu_cta->arrive_and_wait(); }

namespace cooperative_groups {
struct grid_group {
  void sync() { soda_emu_grid->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorCooperativeLaunchTooLarge = 82 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;
static cudaError_t cudaGetLastError() { return cudaSuccess; }
static cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
static cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;  // SMs
  return cudaSuccess;
}
static cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* v, const void*, int, int) {
  *v = 1;
  return cudaSuccess;
}
static cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
static const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

static int min(int a, int b) { return a < b ? a : b; }
static unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
static int max(int a, int b) { return a > b ? a : b; }
static unsigned __vmins2(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int h = 0; h < 2; ++h) {
    const short x = (short)(a >> (16 * h)), y = (short)(b >> (16 * h));
    r |= (unsigned)(unsigned short)(x < y ? x : y) << (16 * h);
  }
  return r;
}
static unsigned __vadd2(unsigned a, unsigned b) {
  return ((a + b) & 0xffffu) | ((((a >> 16) + (b >> 16)) & 0xffffu) << 16);
}
static unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7u))) & 0xffu) << (8 * i);
  return r;
}

// one launch: an ordinary one CTA by CTA, a cooperative one all at once
template <class F>
static void soda_emu_launch(bool coop, int grid, int block, int smem, void*,
                            F f) {
  gridDim.x = grid;
  blockDim.x = block;
  const int ctas_at_once = coop ? grid : 1;
  std::barrier<> all(ctas_at_once * block);
  soda_emu_grid = &all;
  for (int first = 0; first < grid; first += ctas_at_once) {
    std::vector<std::barrier<>*> bars;
    std::vector<std::vector<unsigned char>> mems;
    for (int c = 0; c < ctas_at_once; ++c) {
      bars.push_back(new std::barrier<>(block));
      mems.emplace_back(smem + 16, 0xA5);
    }
    std::vector<std::thread> threads;
    for (int c = 0; c < ctas_at_once; ++c)
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, c, t]() {
          threadIdx.x = t;
          blockIdx.x = first + c;
          soda_emu_cta = bars[c];
          soda_emu_smem = mems[c].data();
          f();
        });
    for (auto& th : threads) th.join();
    for (auto* b : bars) delete b;
  }
}
'''


def emulated_source() -> str:
  """The CUDA text with its launches rewritten for the emulation."""
  text = CSRC.read_text()
  text = text.replace('#include <cooperative_groups.h>\n', '')
  text = text.replace('#include <cuda_runtime.h>\n', '')
  text = text.replace(
      'extern __shared__ __align__(16) unsigned char smem_raw[];',
      'unsigned char* smem_raw = soda_emu_smem;')
  text, ordinary = re.subn(
      r'(\w+<\w+>)<<<([^>]*)>>>\((.*?)\);',
      r'soda_emu_launch(false, \2, [=]() { \1(\3); });', text, flags=re.S)
  text, coop = re.subn(
      r'return cudaLaunchCooperativeKernel\(.*?\);',
      'soda_emu_launch(true, blocks, kThreads, smem, stream, [=]() '
      '{ strip<B>(xg, yg, tg, p, n); });\n  return cudaSuccess;', text,
      flags=re.S)
  assert (ordinary, coop) == (4, 1), (ordinary, coop)
  text, opaque = re.subn(r'asm volatile\(""[^;]*\);', '', text)
  assert opaque == 4, opaque
  return PRELUDE + text


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('needs g++')
  tmp = tmp_path_factory.mktemp('narrow_emulation')
  src = tmp / 'probe_narrow.cc'
  src.write_text(emulated_source())
  out = tmp / 'libprobe_narrow.so'
  proc = subprocess.run(
      [gxx, '-std=c++20', '-O1', '-g', '-shared', '-fPIC', '-pthread',
       '-fsanitize=undefined', '-fno-sanitize-recover=all', '-Wall',
       '-Wno-unused-function', '-Wno-unused-variable', '-o', str(out),
       str(src)], capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stderr[-4000:]
  so = ctypes.CDLL(str(out))
  c = ctypes
  launch = so.probe_narrow_launch
  launch.argtypes = ([c.c_int, c.c_int, c.POINTER(c.c_int), c.c_int] +
                     [c.c_int] * 4 + [c.c_void_p] * 4 +
                     [c.c_longlong, c.c_void_p, c.POINTER(c.c_int)])
  launch.restype = c.c_int
  so.probe_narrow_ops.restype = c.c_char_p
  names = so.probe_narrow_ops().decode()
  ops = dict(zip(narrow.FORMS, ([n for n in part.split(',') if n]
                                for part in names.split(';'))))
  return launch, ops


def small_body(body: narrow.NarrowBody) -> narrow.NarrowBody:
  """``body`` on the SMALL block (a fold's input with its margin of 32
  along the axis the script gives one)."""
  in_shape = None
  if body.in_shape is not None:
    in_shape = tuple(s + (i != o) * 32 for s, i, o in
                     zip(SMALL, body.in_shape, body.shape))
  return dataclasses.replace(body, shape=SMALL, kshape=None,
                             in_shape=in_shape)


def small_inputs(body: narrow.NarrowBody, seed: int):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(body.n_inputs):
    if body.dtype == torch.float32:
      x = rng.uniform(-1, 1, body.input_shape).astype(np.float32)
    elif body.dtype == torch.int16:
      x = rng.integers(-2**15, 2**15, body.input_shape, dtype=np.int16)
    else:
      x = rng.integers(-2**31, 2**31, body.input_shape, dtype=np.int32)
    out.append(torch.from_numpy(x))
  return out


def emulate(lib, body, xs, n):
  launch, ops = lib
  flat, rows, cols, in_rows, in_cols = narrow.launch_geometry(body)
  args = (ctypes.c_int * max(len(flat), 1))(*flat)
  y = torch.empty(body.shape, dtype=body.dtype)
  tmp = torch.empty_like(y)
  ctas = ctypes.c_int(0)
  status = launch(narrow.FORMS.index(body.form),
                  ops[body.form].index(body.op), args, len(flat), rows, cols,
                  in_rows, in_cols, xs[0].data_ptr(),
                  xs[-1].data_ptr(), y.data_ptr(), tmp.data_ptr(), n, None,
                  ctypes.byref(ctas))
  assert status == 0, (body.name, status)
  return y, ctas.value


# one body of each (form, op) the source has, and both strip axes of the
# strip ops that run along one axis in the scripts; exp24's shift chains
# (one-step phases, an independent phase with cross taps); exp32's rotate
# controls (one phase of five chained steps)
def _cases():
  seen, out = set(), []
  for body in (list(narrow.BODIES.values()) +
               list(narrow.EXP24_SHIFT.values()) +
               list(copyshift.ROTATE.values())):
    if (body.form, body.op, body.phases) not in seen:
      seen.add((body.form, body.op, body.phases))
      out.append(body)
  return out


CASES = _cases()


def test_cases_cover_every_op_of_the_source():
  names = re.findall(r'X\((\w+)\)', CSRC.read_text())
  assert sorted({b.op for b in CASES}) == sorted(set(names))


@pytest.mark.parametrize('body', CASES, ids=[b.name for b in CASES])
def test_emulated_kernel_matches_its_plain_version(lib, body):
  small = small_body(body)
  xs = small_inputs(small, 7)
  # (a register chain also through its main loop: a trip and a rest)
  iters = ((1,) if not small.chain else probes.CHECK_ITERS + (
      (narrow.EW_UNROLL + 5,) if small.form == 'ew' else ()))
  for n in iters:
    got, ctas = emulate(lib, small, xs, n)
    want = small.plain(*xs, n=n)
    abs_err, rel_err = probes.max_error(got, want)
    assert narrow.narrow_ok(small, abs_err, rel_err), (body.name, n, abs_err)
    if small.form == 'strip':
      assert ctas == 2, (body.name, ctas)


def test_emulated_launch_refuses_what_the_kernel_does_not_take(lib):
  launch, ops = lib
  x = torch.zeros(SMALL, dtype=torch.int32)
  c = ctypes
  ctas = c.c_int(0)

  def status(form, op, flat, rows=16, cols=32, n=1):
    args = (c.c_int * max(len(flat), 1))(*flat)
    return launch(form, op, args, len(flat), rows, cols, rows, cols,
                  x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), n,
                  None, c.byref(ctas))

  strip = narrow.FORMS.index('strip')
  add = ops['strip'].index('AddI32')
  one = [1, 0, 1, 1, 0]  # a lane phase of one step
  assert status(strip, 0, one) == 0
  assert status(strip, 0, one * 10) == 0
  assert status(strip, 0, [1, 1, 1, 1, 1, 1]) == 0  # one cross tap
  assert status(strip, 0, one, cols=24) != 0  # lines a power of two
  assert status(strip, 0, [1, 0, 11] + [1] * 11 + [0]) != 0  # 10 steps
  assert status(strip, 0, one * 11) != 0  # at most 10 phases
  assert status(strip, 0, [1, 0, 1, 1, 1, 1]) != 0  # cross: independent
  assert status(strip, add, [1, 1, 1, 1, 1, 1]) != 0  # cross: a min
  assert status(strip, 0, one[:-1]) != 0
  assert status(strip, 0, []) != 0
  assert status(strip, 0, one, n=0) != 0
  assert status(strip, len(ops['strip']), one) != 0
  assert status(narrow.FORMS.index('fold'), 0, [0] * 50) != 0  # 25 taps
