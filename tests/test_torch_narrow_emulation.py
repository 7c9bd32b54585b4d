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
import hashlib
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
#include <atomic>
#include <barrier>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __grid_constant__

struct alignas(16) uint4 { unsigned x, y, z, w; };

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
                   cudaErrorLaunchOutOfResources = 7,
                   cudaErrorCooperativeLaunchTooLarge = 82 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
                         cudaFuncAttributeNonPortableClusterSizeAllowed = 12 };
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

// cp.async of 16 bytes: both ends 16-byte aligned, the source inside the
// input the test named (soda_emu_configure); it lands when the thread
// waits for its group (deferred) or at once (eager)
struct SodaEmuCopy { void* dst; const void* src; };
static thread_local std::vector<SodaEmuCopy> soda_emu_copies;
static thread_local std::vector<std::vector<SodaEmuCopy>> soda_emu_groups;
static bool soda_emu_eager = false;
static const unsigned char* soda_emu_in_lo = nullptr;
static const unsigned char* soda_emu_in_hi = nullptr;
// what the emulation caught in the last launch (0: nothing): 1 a
// misaligned copy, 2 a copy from outside the input, 3 copies never
// waited for, 4 copies never committed
static std::atomic<int> soda_emu_fault{0};
extern "C" int soda_emu_last_fault() { return soda_emu_fault.exchange(0); }
static void cp_async16(void* dst, const void* src) {
  const unsigned char* s = (const unsigned char*)src;
  if ((uintptr_t)dst % 16 || (uintptr_t)src % 16) {
    soda_emu_fault = 1;
    return;
  }
  if (soda_emu_in_lo && (s < soda_emu_in_lo || s + 16 > soda_emu_in_hi)) {
    soda_emu_fault = 2;
    return;
  }
  if (soda_emu_eager)
    memcpy(dst, src, 16);
  else
    soda_emu_copies.push_back({dst, src});
}
static void cp_async_commit() {
  soda_emu_groups.push_back(soda_emu_copies);
  soda_emu_copies.clear();
}
static void cp_async_wait_one() {
  while (soda_emu_groups.size() > 1) {
    for (const SodaEmuCopy& c : soda_emu_groups.front())
      memcpy(c.dst, c.src, 16);
    soda_emu_groups.erase(soda_emu_groups.begin());
  }
}
extern "C" void soda_emu_configure(int eager, const void* in, long long bytes) {
  soda_emu_eager = eager != 0;
  soda_emu_in_lo = (const unsigned char*)in;
  soda_emu_in_hi = in ? (const unsigned char*)in + bytes : nullptr;
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
          for (const auto& group : soda_emu_groups)
            if (!group.empty()) soda_emu_fault = 3;
          if (!soda_emu_copies.empty()) soda_emu_fault = 4;
          soda_emu_groups.clear();
          soda_emu_copies.clear();
        });
    for (auto& th : threads) th.join();
    for (auto* b : bars) delete b;
  }
}

// -- clusters (strip_cluster): a cluster launch runs a cluster's CTAs at
// once, each a warp's 32 threads with a barrier of their own (at
// __syncwarp and twice at each __shfl_sync); a cluster
// barrier in halves (an arrival, a wait for every thread's); another
// CTA's shared memory read through its rank. A read of another CTA's
// shared memory made after the reader's a-th arrival, where that CTA
// leaves after its a-th wait or sooner, may come after it left: the
// launch aborts.
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
[[noreturn]] static void soda_emu_fail(const char* what) {
  fprintf(stderr, "%s\n", what);
  abort();
}
struct SodaEmuWarp {
  std::barrier<> bar{32};
  unsigned long long slot[32];
};
static thread_local SodaEmuWarp* soda_emu_warp = nullptr;
static void __syncwarp(unsigned mask = 0xffffffffu) {
  if (mask != 0xffffffffu || soda_emu_warp == nullptr)
    soda_emu_fail("__syncwarp: a full warp's mask inside a cluster launch");
  soda_emu_warp->bar.arrive_and_wait();
}
template <class T>
static T __shfl_sync(unsigned mask, T v, int src) {
  static_assert(sizeof(T) <= 8, "a shuffled value is a register");
  if (mask != 0xffffffffu || soda_emu_warp == nullptr)
    soda_emu_fail("__shfl_sync: a full warp's mask inside a cluster launch");
  unsigned long long bits = 0;
  memcpy(&bits, &v, sizeof(T));
  soda_emu_warp->slot[threadIdx.x & 31] = bits;
  soda_emu_warp->bar.arrive_and_wait();
  bits = soda_emu_warp->slot[src & 31];
  soda_emu_warp->bar.arrive_and_wait();
  T out;
  memcpy(&out, &bits, sizeof(T));
  return out;
}
struct SodaEmuCluster {
  int ctas = 0, threads = 0;
  size_t bytes = 0;
  std::vector<unsigned char*> smem;
  std::mutex mu;
  std::condition_variable cv;
  long long arrived = 0, completed = 0;
  std::vector<long long> left;  // a CTA's waits when its threads left
  std::vector<long long> read;  // the most arrivals of a reader from
                                // another CTA at a read of its memory
};
static SodaEmuCluster* soda_emu_cl = nullptr;
static thread_local long long soda_emu_arrivals = 0, soda_emu_waits = 0;
static unsigned cluster_rank() { return blockIdx.x % soda_emu_cl->ctas; }
static void cluster_arrive() {
  if (soda_emu_arrivals != soda_emu_waits)
    soda_emu_fail("barrier.cluster: two arrivals without a wait");
  ++soda_emu_arrivals;
  std::lock_guard<std::mutex> g(soda_emu_cl->mu);
  if (++soda_emu_cl->arrived ==
      static_cast<long long>(soda_emu_cl->ctas) * soda_emu_cl->threads) {
    soda_emu_cl->arrived = 0;
    ++soda_emu_cl->completed;
    soda_emu_cl->cv.notify_all();
  }
}
static void cluster_wait() {
  if (soda_emu_waits + 1 != soda_emu_arrivals)
    soda_emu_fail("barrier.cluster: a wait without an arrival");
  ++soda_emu_waits;
  std::unique_lock<std::mutex> g(soda_emu_cl->mu);
  if (!soda_emu_cl->cv.wait_for(g, std::chrono::seconds(60), [] {
        return soda_emu_cl->completed >= soda_emu_waits;
      }))
    soda_emu_fail("barrier.cluster: a phase never completes");
}
struct RemoteAddr {
  int cta;
  const unsigned* p;
};
static RemoteAddr remote(const unsigned* p, unsigned rank) {
  const unsigned char* c = reinterpret_cast<const unsigned char*>(p);
  if (rank >= static_cast<unsigned>(soda_emu_cl->ctas) || c < soda_emu_smem ||
      c >= soda_emu_smem + soda_emu_cl->bytes)
    soda_emu_fail("mapa: no such CTA, or not shared memory");
  return {static_cast<int>(rank),
          reinterpret_cast<const unsigned*>(soda_emu_cl->smem[rank] +
                                            (c - soda_emu_smem))};
}
static uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
static unsigned ld_remote(RemoteAddr a, int word) {
  const unsigned char* c = reinterpret_cast<const unsigned char*>(a.p + word);
  const unsigned char* base = soda_emu_cl->smem[a.cta];
  if (c < base || c + 4 > base + soda_emu_cl->bytes)
    soda_emu_fail("ld.shared::cluster outside the CTA's shared memory");
  if (a.cta != static_cast<int>(cluster_rank())) {
    std::lock_guard<std::mutex> g(soda_emu_cl->mu);
    long long& most = soda_emu_cl->read[a.cta];
    if (soda_emu_arrivals > most) most = soda_emu_arrivals;
  }
  return a.p[word];
}
template <class F>
static cudaError_t cudaOccupancyMaxActiveClusters(
    int* n, F*, const cudaLaunchConfig_t* c) {
  // one cluster a card; none of more CTAs than 16, or past 227 KB a CTA
  const unsigned ctas = c->numAttrs ? c->attrs[0].val.clusterDim.x : 0;
  *n = ctas >= 1 && ctas <= 16 && c->dynamicSmemBytes <= 232448;
  return cudaSuccess;
}
// each cluster of the grid one after another, its CTAs at once
template <class... P, class... A>
static cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c,
                                      void (*kernel)(P...), A&&... args) {
  if (c->numAttrs != 1 || c->attrs[0].id != cudaLaunchAttributeClusterDimension)
    soda_emu_fail("a cluster launch without cluster dimensions");
  const int ctas = static_cast<int>(c->attrs[0].val.clusterDim.x);
  const int threads = static_cast<int>(c->blockDim.x);
  if (ctas < 1 || c->gridDim.x % ctas || threads % 32)
    soda_emu_fail("a cluster launch of whole clusters and warps");
  gridDim.x = c->gridDim.x;
  blockDim.x = threads;
  for (unsigned first = 0; first < c->gridDim.x; first += ctas) {
    SodaEmuCluster cl;
    cl.ctas = ctas;
    cl.threads = threads;
    cl.bytes = c->dynamicSmemBytes;
    cl.left.assign(ctas, -1);
    cl.read.assign(ctas, -1);
    std::vector<std::vector<unsigned char>> mems;
    std::vector<std::barrier<>*> bars;
    std::vector<SodaEmuWarp*> warps;
    for (int r = 0; r < ctas; ++r) {
      mems.emplace_back(cl.bytes + 16, 0xA5);
      bars.push_back(new std::barrier<>(threads));
      for (int w = 0; w < threads / 32; ++w) warps.push_back(new SodaEmuWarp);
    }
    for (auto& m : mems) cl.smem.push_back(m.data());
    soda_emu_cl = &cl;
    std::vector<std::thread> pool;
    for (int r = 0; r < ctas; ++r)
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, r, t]() {
          threadIdx.x = t;
          blockIdx.x = first + r;
          soda_emu_cta = bars[r];
          soda_emu_smem = cl.smem[r];
          soda_emu_warp = warps[r * (threads / 32) + t / 32];
          soda_emu_arrivals = soda_emu_waits = 0;
          kernel(args...);
          std::lock_guard<std::mutex> g(cl.mu);
          if (cl.left[r] < 0 || soda_emu_waits < cl.left[r])
            cl.left[r] = soda_emu_waits;
        });
    for (auto& th : pool) th.join();
    for (int r = 0; r < ctas; ++r)
      if (cl.read[r] >= 0 && cl.read[r] >= cl.left[r])
        soda_emu_fail("a CTA's shared memory read after that CTA passed its "
                      "last barrier");
    soda_emu_cl = nullptr;
    for (auto* b : bars) delete b;
    for (auto* w : warps) delete w;
  }
  return cudaSuccess;
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
  assert (ordinary, coop) == (6, 1), (ordinary, coop)
  text, opaque = re.subn(r'asm volatile\(""[^;]*\);', '', text)
  assert opaque == 9, opaque
  return PRELUDE + text


@pytest.fixture(scope='module')
def emu_so(tmp_path_factory):
  """The emulated library, its entry points' types set."""
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
  so.probe_narrow_geometry.argtypes = (
      [c.c_int, c.c_int, c.POINTER(c.c_int), c.c_int] + [c.c_int] * 4 +
      [c.POINTER(c.c_int)])
  so.probe_narrow_geometry.restype = c.c_int
  so.soda_emu_configure.argtypes = [c.c_int, c.c_void_p, c.c_longlong]
  so.soda_emu_last_fault.restype = c.c_int
  so.probe_narrow_ops.restype = c.c_char_p
  return so


@pytest.fixture(scope='module')
def lib(emu_so):
  """(launch, ops by form, configure, fault): ``configure(eager, input,
  bytes)`` sets how the next launch's cp.async copies land and the input
  they must read inside; ``fault()`` what the emulation caught since it
  was last asked (0: nothing)."""
  names = emu_so.probe_narrow_ops().decode()
  ops = dict(zip(narrow.FORMS, ([n for n in part.split(',') if n]
                                for part in names.split(';'))))
  return (emu_so.probe_narrow_launch, ops, emu_so.soda_emu_configure,
          emu_so.soda_emu_last_fault)


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


def emulate(lib, body, xs, n, old=False, eager=False):
  """``body``'s launch on the CPU tensors ``xs`` (``old``: its old form,
  as ``narrow.launch(..., _old=True)``; ``eager``: cp.async copies land
  at once, not at their wait); (output, grid)."""
  launch, ops, configure, fault = lib
  configure(int(eager), xs[0].data_ptr(),
            xs[0].untyped_storage().nbytes() -
            xs[0].storage_offset() * xs[0].element_size())
  flat, rows, cols, in_rows, in_cols = narrow.launch_geometry(body)
  args = (ctypes.c_int * max(len(flat), 1))(*flat)
  y = torch.empty(body.shape, dtype=body.dtype)
  tmp = torch.empty_like(y)
  ctas = ctypes.c_int(0)
  form = (narrow.OLD_FORMS[body.form] if old else
          narrow.FORMS.index(body.form))
  status = launch(form, ops[body.form].index(body.op), args, len(flat),
                  rows, cols,
                  in_rows, in_cols, xs[0].data_ptr(),
                  xs[-1].data_ptr(), y.data_ptr(), tmp.data_ptr(), n, None,
                  ctypes.byref(ctas))
  assert status == 0, (body.name, status)
  assert fault() == 0, (body.name, 'cp.async fault')
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
  launch, ops, _, _ = lib
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


# -- the one-shot forms on Hopper: vec_binary and tile_fold -------------------

ONE_SHOT = [b for b in narrow.BODIES.values() if not b.chain]
BINARY = [b for b in ONE_SHOT if b.form == 'binary']
FOLD = [b for b in ONE_SHOT if b.form == 'fold']
# binary: 481 cells (a scalar tail past 60 int16 or 120 int32 vectors),
# 1024 cells (whole vectors), and inputs one cell past a 16-byte boundary
# (every cell one a thread)
BINARY_SHAPES = {'ragged': (13, 37), 'whole': (16, 64),
                 'misaligned': (13, 37)}
# fold: outputs of 21 x 296 (int16: two tile columns, the second 40 cells;
# int32: three; tile rows ragged) and 13 x 300 (int16: rows of 300 cells,
# no 16-byte stores, an input row of 332 copied cell by cell), each with
# the body's margin; and 'wrap', the input no larger than the output, so
# that the taps wrap round both extents inside a tile's box
FOLD_SHAPES = {'margin': (21, 296), 'ragged': (13, 300), 'wrap': (21, 296)}


def at_shape(body, shape, margin=True):
  in_shape = None
  if body.in_shape is not None and margin:
    in_shape = tuple(s + i - o for s, i, o in
                     zip(shape, body.in_shape, body.shape))
  return dataclasses.replace(body, shape=shape, kshape=None,
                             in_shape=in_shape)


def aligned_inputs(body, seed, offset=0):
  """Seeded inputs in fresh (64-byte aligned) memory, each starting
  ``offset`` cells past its allocation."""
  out = []
  for x in small_inputs(body, seed):
    flat = torch.empty(x.numel() + offset, dtype=x.dtype)
    flat[offset:] = x.reshape(-1)
    out.append(flat[offset:].view(x.shape))
  return out


def _ids(cases):
  return ['%s-%s' % (b.name, v) for b, v, *_ in cases]


BINARY_CASES = [(b, v) for b in BINARY for v in BINARY_SHAPES]


@pytest.mark.parametrize('body,variant', BINARY_CASES,
                         ids=_ids(BINARY_CASES))
def test_vec_binary_matches_plain_and_old_form(lib, body, variant):
  """Each binary body on vec_binary, bit for bit against its plain
  version and the old binary kernel; the grid strides (two SMs, one CTA
  each, in the emulation)."""
  small = at_shape(body, BINARY_SHAPES[variant])
  xs = aligned_inputs(small, 11, offset=int(variant == 'misaligned'))
  assert (xs[0].data_ptr() % 16 != 0) == (variant == 'misaligned')
  got, ctas = emulate(lib, small, xs, 1)
  old, _ = emulate(lib, small, xs, 1, old=True)
  want = small.plain(*xs)
  assert torch.equal(got, want), body.name
  assert torch.equal(old, want), body.name
  assert ctas <= 2


FOLD_CASES = [(b, v, e) for b in FOLD for v in FOLD_SHAPES
              for e in (False, True)]


@pytest.mark.parametrize('body,variant,eager', FOLD_CASES,
                         ids=['%s-%s' % (i, 'eager' if e else 'deferred')
                              for i, (_, _, e) in zip(_ids(FOLD_CASES),
                                                      FOLD_CASES)])
def test_tile_fold_matches_plain_and_old_form(lib, body, variant, eager):
  """Each fold body on tile_fold, bit for bit against its plain version
  and the old fold kernel, its box's copies landing at their wait or at
  once, each inside the input (the float roll is a copy)."""
  small = at_shape(body, FOLD_SHAPES[variant], margin=variant != 'wrap')
  xs = aligned_inputs(small, 13)
  got, ctas = emulate(lib, small, xs, 1, eager=eager)
  old, _ = emulate(lib, small, xs, 1, old=True)
  want = small.plain(*xs)
  assert torch.equal(got, want), body.name
  assert torch.equal(old, want), body.name
  assert ctas >= 2


def _geometry(emu_so, lib, body):
  _, ops, _, _ = lib
  flat, rows, cols, in_rows, in_cols = narrow.launch_geometry(body)
  args = (ctypes.c_int * max(len(flat), 1))(*flat)
  out = (ctypes.c_int * 4)()
  status = emu_so.probe_narrow_geometry(
      narrow.FORMS.index(body.form), ops[body.form].index(body.op), args,
      len(flat), rows, cols, in_rows, in_cols, out)
  return status, list(out)


def test_fold_box_past_shared_memory_is_refused(emu_so, lib):
  """A fold whose taps' box cannot fit a CTA's 227 KB raises at launch
  (the old form, which reads device memory, takes it): two boxes of 2008
  rows of 256 int16 cells."""
  body = dataclasses.replace(
      narrow.BODIES['exp13 i16 19-tap sublane where-min fold'],
      shape=(64, 256), in_shape=(4096, 256), taps=((0, 0), (2000, 0)))
  status, _ = _geometry(emu_so, lib, body)
  assert status != 0
  launch, ops, configure, _ = lib
  flat, rows, cols, in_rows, in_cols = narrow.launch_geometry(body)
  x = torch.zeros(body.input_shape, dtype=body.dtype)
  y = torch.zeros(body.shape, dtype=body.dtype)
  args = (ctypes.c_int * len(flat))(*flat)
  ctas = ctypes.c_int(0)
  configure(0, None, 0)
  for form, refused in ((2, True), (narrow.OLD_FORMS['fold'], False)):
    status = launch(form, ops['fold'].index(body.op), args, len(flat), rows,
                    cols, in_rows, in_cols, x.data_ptr(), None, y.data_ptr(),
                    None, 1, None, ctypes.byref(ctas))
    assert (status != 0) == refused, form
  # a margin of 216 rows fits at 8 rows a tile, two boxes (16 rows would
  # pass 227 KB); two CTAs walk its 8 tiles (two SMs in the emulation)
  fits = dataclasses.replace(body, taps=((0, 0), (216, 0)))
  status, (_, smem, grid, tile_rows) = _geometry(emu_so, lib, fits)
  assert status == 0 and tile_rows == 8 and smem == 2 * 224 * 32 * 16
  assert grid == 2


@pytest.mark.parametrize('name', [b.name for b in FOLD])
def test_fold_boxes_fit_at_the_scripts_and_the_bench_shape(emu_so, lib,
                                                           name):
  """Every fold body's box at its script's shape and at (8192, 2048) with
  its margin: inside shared memory, 32-row tiles at the bench shape."""
  body = narrow.BODIES[name]
  for shape in (body.shape, (8192, 2048)):
    status, (_, smem, grid, tile_rows) = _geometry(
        emu_so, lib, at_shape(body, shape))
    assert status == 0 and 0 < smem <= 232448, (name, shape)
    if shape == (8192, 2048):
      assert tile_rows == 32 and grid == 2, (name, grid)


# sha256 (first 16 hex digits) of what stays as the parent had it: each
# kernel section (the old binary and fold forms, ew, strip; their op
# structs) from its header to the next, and the launchers and planners
PARENT_SECTIONS = {
    '// -- binary: y = f(a, b)': 'b8e8fd8ba863eb96',
    '// -- ew: y = f^n(x)': '868c4be63d6fbc36',
    '// -- fold: shifted slices': 'a89d7ed92d9d8219',
    '// -- strip: chains': 'e9bc381f77727bb3',
}
PARENT_DEFINITIONS = {
    'template <class Op>\ncudaError_t launch_binary(': 'cf174a5105a9941b',
    'template <class Op>\ncudaError_t launch_ew(': '92d04b873d62a196',
    'template <class Op>\ncudaError_t launch_fold(': '6ab97c0db8595c40',
    'template <class B>\ncudaError_t launch_strip(': '181ec82d46bbc271',
    'int plan_phase(': '183086006337f9f6',
    'int log2_exact(': 'bada8e1859dc53a7',
    'int blocks_for(': 'c7df25162ee0f6df',
}


def _digest(text):
  return hashlib.sha256(text.encode()).hexdigest()[:16]


@pytest.mark.parametrize('header', sorted(PARENT_SECTIONS))
def test_old_forms_and_other_kernels_are_unchanged(header):
  text = CSRC.read_text()
  assert text.count(header) == 1
  start = text.index(header)
  end = text.index('\n// -- ', start + 1) + 1
  assert _digest(text[start:end]) == PARENT_SECTIONS[header]


@pytest.mark.parametrize('head', sorted(PARENT_DEFINITIONS))
def test_old_launchers_are_unchanged(head):
  text = CSRC.read_text()
  assert text.count(head) == 1
  start = text.index(head)
  end = text.index('\n}\n', start) + 3
  assert _digest(text[start:end]) == PARENT_DEFINITIONS[head]


def test_default_path_launches_the_new_forms_only():
  """The public forms dispatch to vec_binary and tile_fold; binary and
  fold run only under their private form indices (4, 5)."""
  text = CSRC.read_text()
  launch = text[text.index('int probe_narrow_launch('):]
  assert '(form == 0 ? kVecBinary : kBinary)' in launch
  assert '(form == 2 ? kTileFold : kFold)' in launch
  assert narrow.OLD_FORMS == {'binary': 4, 'fold': 5}
  assert narrow.KERNEL_NAMES['binary'] == 'vec_binary'
  assert narrow.KERNEL_NAMES['fold'] == 'tile_fold'


@pytest.mark.parametrize('name,taps', [
    ('exp13 i16 lane-shifted slice add (off 3)', ((0, 0), (0, 0), (0, 3))),
    ('exp12 8-operand shifted add-chain', ((0, 5), (2, 5), (0, 5), (0, 1))),
    ('exp13 i16 19-tap lane where-min fold',
     ((3, 30), (0, 0), (3, 2), (1, 31), (0, 0))),
    # column windows: a repeated row, rows 60 apart, two columns
    ('exp13 i16 sublane-shifted slice add (off 5)',
     ((0, 0), (3, 0), (3, 0), (60, 0), (7, 8), (1, 8), (2, 3))),
])
def test_tile_fold_takes_repeated_and_scattered_taps(lib, name, taps):
  """A tap that repeats another (an add counts it twice), taps over
  several rows and past a window's reach, in any order: tile_fold, its
  plain version and the old form agree bit for bit."""
  body = dataclasses.replace(narrow.BODIES[name], shape=(21, 296),
                             in_shape=(85, 336), taps=taps)
  xs = aligned_inputs(body, 17)
  got, _ = emulate(lib, body, xs, 1)
  old, _ = emulate(lib, body, xs, 1, old=True)
  want = body.plain(*xs)
  assert torch.equal(got, want) and torch.equal(old, want)
