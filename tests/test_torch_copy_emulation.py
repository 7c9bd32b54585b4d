"""The copy-shift and 2.5-D jacobi CUDA text, run on the CPU through a g++
emulation.

There is no nvcc without a card, so ``csrc/probe_copy.cu`` and
``csrc/probe_25d.cu`` are compiled with g++ under AddressSanitizer and
UBSan against a small emulation of what they use. Each source keeps its
PTX in small inline helpers behind ``#ifndef SODA_EMULATE``; the
emulation defines SODA_EMULATE and gives its own:

- ``cp.async.bulk`` shared -> shared with ``mbarrier`` completion: a
  copy's addresses and size must be 16-byte aligned and lie in the CTA's
  shared memory, and the launch must be a cluster launch (on an H100 the
  copy raises an illegal instruction in one without); ``mbarrier``
  init, ``arrive.expect_tx`` and ``try_wait.parity`` keep the barrier's
  arrivals, transaction bytes and phase; a phase whose bytes overshoot
  aborts, one that never completes aborts after a time;
- ``cp.async`` of 16 and 4 bytes in commit groups (16- and 4-byte
  aligned);
- the proxy and init fences as no-ops.

A copy lands either when a wait on its barrier (its group's wait) finds
it (deferred) or at once (eager): a kernel right under both orders reads
no slot before its copy lands and overwrites no source while it is still
being copied. A CTA is 256 host threads with a barrier of their own
(``__syncthreads``), its shared memory a buffer of exactly the launch's
size filled with a non-zero pattern; CTAs run one after another. The
launch syntax is rewritten into a call of the emulation; nothing else of
the text changes. Every exp32 case of the copy kernel (the rotate
controls run in the strip kernel: tests/test_torch_narrow_emulation.py)
and the 2.5-D kernel at small shapes (three row blocks, a run of several
tiles, one band) are held bit for bit to their plain versions. The card
runs the same text (tests/test_torch_gpu.py, chip_smoke.py).
"""

import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from soda_tpu_torch.experiments import copyshift, layout25d, probes

CSRC = (pathlib.Path(__file__).resolve().parents[1] / 'soda_tpu_torch' /
        'csrc')
# the copy kernel's block here: row copies of 16 rows in bands of 16
# lanes (2 cells a thread, 128 CTAs), lane copies of 1920 lanes on
# whole rows (8 cells a thread, 32 CTAs)
SMALL = (32, 2048)
# the 2.5-D kernel's grids: (shape, block)
GRIDS = (((96, 2, 128), 32), ((192, 2, 128), 64), ((128, 1, 128), 128))

PRELUDE = r'''
#include <barrier>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

#define SODA_EMULATE
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __align__(n) alignas(n)

struct SodaDim { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
static thread_local SodaDim threadIdx, blockIdx;
static SodaDim blockDim, gridDim;
static std::barrier<>* soda_emu_cta = nullptr;
static unsigned char* soda_emu_smem = nullptr;
static size_t soda_emu_smem_bytes = 0;
static bool soda_emu_eager = false;
static bool soda_emu_cluster = false;
static void __syncthreads() { soda_emu_cta->arrive_and_wait(); }
static int min(int a, int b) { return a < b ? a : b; }
static int max(int a, int b) { return a > b ? a : b; }

[[noreturn]] static void soda_emu_fail(const char* what) {
  fprintf(stderr, "%s\n", what);
  abort();
}

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
typedef void* cudaStream_t;
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
static cudaError_t cudaGetLastError() { return cudaSuccess; }
static cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
static const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

// -- the bulk-copy engine and mbarriers ---------------------------------------
struct EmuCopy { void* dst; const void* src; unsigned bytes; };
struct EmuBar {
  unsigned count = 0, arrivals = 0;
  long long tx = 0;
  unsigned long long phase = 0;  // phases completed
  std::vector<EmuCopy> copies;
};
static std::mutex soda_emu_mu;
static std::map<const void*, EmuBar> soda_emu_bars;

static void emu_in_smem(const void* p, size_t bytes, const char* what) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  if (c < soda_emu_smem || c + bytes > soda_emu_smem + soda_emu_smem_bytes)
    soda_emu_fail(what);
}
static EmuBar& emu_bar(const void* bar) {
  auto it = soda_emu_bars.find(bar);
  if (it == soda_emu_bars.end()) soda_emu_fail("mbarrier used before init");
  return it->second;
}
static void emu_complete(EmuBar& b) {
  if (b.tx < 0) soda_emu_fail("more bytes landed than the phase expected");
  if (b.arrivals == 0 && b.tx == 0 && b.copies.empty()) {
    ++b.phase;
    b.arrivals = b.count;
  }
}
static void emu_land(EmuBar& b, const EmuCopy& c) {
  memcpy(c.dst, c.src, c.bytes);
  b.tx -= c.bytes;
}
static void bar_init(uint64_t* bar, unsigned count) {
  emu_in_smem(bar, 8, "mbarrier outside shared memory");
  if ((uintptr_t)bar % 8) soda_emu_fail("misaligned mbarrier");
  std::lock_guard<std::mutex> g(soda_emu_mu);
  EmuBar& b = soda_emu_bars[bar];
  b = EmuBar{};
  b.count = b.arrivals = count;
}
static void fence_bar_init() {}
static void fence_async() {}
static void bar_expect(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> g(soda_emu_mu);
  EmuBar& b = emu_bar(bar);
  if (b.arrivals == 0) soda_emu_fail("more arrivals than the barrier counts");
  --b.arrivals;
  b.tx += bytes;
  emu_complete(b);
}
static void bulk_copy(void* dst, const void* src, unsigned bytes,
                      uint64_t* bar) {
  if (!soda_emu_cluster)
    soda_emu_fail("bulk copy to shared::cluster outside a cluster launch");
  if ((uintptr_t)dst % 16 || (uintptr_t)src % 16 || bytes % 16 || !bytes)
    soda_emu_fail("misaligned cp.async.bulk");
  emu_in_smem(dst, bytes, "bulk copy destination outside shared memory");
  emu_in_smem(src, bytes, "bulk copy source outside shared memory");
  std::lock_guard<std::mutex> g(soda_emu_mu);
  EmuBar& b = emu_bar(bar);
  EmuCopy c{dst, src, bytes};
  if (soda_emu_eager) {
    emu_land(b, c);
    emu_complete(b);
  } else {
    b.copies.push_back(c);
  }
}
static thread_local std::chrono::steady_clock::time_point soda_emu_since;
static thread_local bool soda_emu_waiting = false;
static bool bar_try_wait(uint64_t* bar, unsigned parity) {
  bool done;
  {
    std::lock_guard<std::mutex> g(soda_emu_mu);
    EmuBar& b = emu_bar(bar);
    // deferred copies land when a wait finds every arrival of the phase
    if (b.arrivals == 0 && !b.copies.empty()) {
      std::vector<EmuCopy> copies;
      copies.swap(b.copies);
      for (const EmuCopy& c : copies) emu_land(b, c);
      emu_complete(b);
    }
    done = (b.phase & 1) != (parity & 1);
  }
  if (done) {
    soda_emu_waiting = false;
    return true;
  }
  const auto now = std::chrono::steady_clock::now();
  if (!soda_emu_waiting) {
    soda_emu_waiting = true;
    soda_emu_since = now;
  } else if (now - soda_emu_since > std::chrono::seconds(20)) {
    soda_emu_fail("an mbarrier phase never completes");
  }
  std::this_thread::yield();
  return false;
}
static void st_shared(int* p, int v) {
  emu_in_smem(p, 4, "st.shared outside shared memory");
  *p = v;
}
static int ld_shared(const int* p) {
  emu_in_smem(p, 4, "ld.shared outside shared memory");
  return *p;
}
static void opaque(int&) {}

// -- cp.async ------------------------------------------------------------------
struct EmuAsync { void* dst; const void* src; int bytes; };
static thread_local std::vector<std::vector<EmuAsync>> soda_emu_groups;
static thread_local std::vector<EmuAsync> soda_emu_open;
static void emu_async(void* dst, const void* src, int bytes) {
  if ((uintptr_t)dst % bytes || (uintptr_t)src % bytes)
    soda_emu_fail("misaligned cp.async");
  emu_in_smem(dst, bytes, "cp.async destination outside shared memory");
  EmuAsync c{dst, src, bytes};
  if (soda_emu_eager) memcpy(dst, src, bytes); else soda_emu_open.push_back(c);
}
static void cp_async16(void* dst, const void* src) { emu_async(dst, src, 16); }
static void cp_async4(void* dst, const void* src) { emu_async(dst, src, 4); }
static void cp_async_commit() {
  soda_emu_groups.push_back(soda_emu_open);
  soda_emu_open.clear();
}
template <int N>
static void cp_async_wait() {
  while (soda_emu_groups.size() > (size_t)N) {
    for (const EmuAsync& c : soda_emu_groups.front())
      memcpy(c.dst, c.src, c.bytes);
    soda_emu_groups.erase(soda_emu_groups.begin());
  }
}

// -- launches: CTAs one after another, 256 threads each ------------------------
template <class F>
static void soda_emu_launch(dim3 grid, unsigned block, size_t smem,
                            cudaStream_t, F f) {
  gridDim.x = grid.x;
  gridDim.y = grid.y;
  blockDim.x = block;
  void* mem = nullptr;
  if (posix_memalign(&mem, 128, smem ? smem : 1)) soda_emu_fail("no memory");
  soda_emu_smem = static_cast<unsigned char*>(mem);
  soda_emu_smem_bytes = smem;
  std::barrier<> cta(block);
  soda_emu_cta = &cta;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block; ++t)
    threads.emplace_back([&, t]() {
      threadIdx.x = t;
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          if (t == 0) {
            memset(soda_emu_smem, 0xA5, smem);
            soda_emu_bars.clear();
          }
          cta.arrive_and_wait();
          blockIdx.x = bx;
          blockIdx.y = by;
          f();
          for (const auto& group : soda_emu_groups)
            if (!group.empty()) soda_emu_fail("cp.async never waited for");
          if (!soda_emu_open.empty()) soda_emu_fail("cp.async not committed");
          soda_emu_groups.clear();
          cta.arrive_and_wait();
          if (t == 0)
            for (const auto& [bar, b] : soda_emu_bars)
              if (!b.copies.empty() || b.tx)
                soda_emu_fail("bulk copies never waited for");
        }
    });
  for (auto& th : threads) th.join();
  free(mem);
}
template <class... E, class... A>
static cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* config,
                                      void (*kernel)(E...), A&&... args) {
  bool cluster = false;
  for (unsigned a = 0; a < config->numAttrs; ++a)
    cluster |= config->attrs[a].id == cudaLaunchAttributeClusterDimension &&
               config->attrs[a].val.clusterDim.x == 1 &&
               config->attrs[a].val.clusterDim.y == 1 &&
               config->attrs[a].val.clusterDim.z == 1;
  soda_emu_cluster = cluster;
  soda_emu_launch(config->gridDim, config->blockDim.x,
                  config->dynamicSmemBytes, config->stream,
                  [&]() { kernel(args...); });
  soda_emu_cluster = false;
  return cudaSuccess;
}
'''

COPY_MAIN = r'''
// argv: eager kind axis rows cols cp in out n_dists dists... n_iters ns...
int main(int argc, char** argv) {
  int q = 1;
  soda_emu_eager = atoi(argv[q++]) != 0;
  const int kind = atoi(argv[q++]), axis = atoi(argv[q++]);
  const int rows = atoi(argv[q++]), cols = atoi(argv[q++]);
  const int cp = atoi(argv[q++]);
  const char* in = argv[q++];
  const char* out = argv[q++];
  std::vector<int> dists(atoi(argv[q++]));
  for (int& d : dists) d = atoi(argv[q++]);
  std::vector<long long> ns(atoi(argv[q++]));
  for (long long& n : ns) n = atoll(argv[q++]);
  std::vector<int> x((size_t)rows * cols), y(x.size());
  FILE* f = fopen(in, "rb");
  if (!f || fread(x.data(), 4, x.size(), f) != x.size()) abort();
  fclose(f);
  f = fopen(out, "wb");
  for (long long n : ns) {
    int ctas = 0;
    const int status = probe_copy_launch(kind, axis, dists.data(),
                                         (int)dists.size(), rows, cols, cp,
                                         x.data(), y.data(), n, nullptr,
                                         &ctas);
    printf("%d %d\n", status, ctas);
    fwrite(y.data(), 4, y.size(), f);
  }
  fclose(f);
  return 0;
}
'''

JACOBI_MAIN = r'''
// argv: eager h w block in out
int main(int argc, char** argv) {
  soda_emu_eager = atoi(argv[1]) != 0;
  const int h = atoi(argv[2]), w = atoi(argv[3]), block = atoi(argv[4]);
  std::vector<float> x((size_t)h * w), y(x.size(), 0.0f);
  FILE* f = fopen(argv[5], "rb");
  if (!f || fread(x.data(), 4, x.size(), f) != x.size()) abort();
  fclose(f);
  int ctas = 0;
  printf("%d", probe_25d_launch(x.data(), y.data(), h, w, block, nullptr,
                                &ctas));
  printf(" %d\n", ctas);
  f = fopen(argv[6], "wb");
  fwrite(y.data(), 4, y.size(), f);
  fclose(f);
  return 0;
}
'''


def emulated_source(name: str) -> str:
  """A source's CUDA text with its launches rewritten for the emulation."""
  text = (CSRC / name).read_text().replace('#include <cuda_runtime.h>\n', '')
  text, shared = re.subn(
      r'extern __shared__ __align__\((\d+)\) unsigned char smem_raw\[\];',
      'unsigned char* smem_raw = soda_emu_smem;', text)
  text, launches = re.subn(
      r'(\w+)<<<(.*?)>>>\((.*?)\);',
      r'soda_emu_launch(\2, [=]() { \1(\3); });', text, flags=re.S)
  assert shared == 1, shared
  assert launches == (1 if name == layout25d.SOURCE else 0), launches
  return PRELUDE + text


def _build(tmp, name, main):
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('needs g++')
  src = tmp / (name + '.cc')
  src.write_text(emulated_source(name) + main)
  exe = tmp / name.replace('.cu', '')
  proc = subprocess.run(
      [gxx, '-std=c++20', '-O1', '-g', '-pthread',
       '-fsanitize=address,undefined', '-fno-sanitize-recover=all', '-Wall',
       '-Wno-unused-function', '-Wno-unused-variable', '-o', str(exe),
       str(src)], capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stderr[-4000:]
  return exe


@pytest.fixture(scope='module')
def exes(tmp_path_factory):
  tmp = tmp_path_factory.mktemp('copy_emulation')
  return tmp, {'copy': _build(tmp, copyshift.SOURCE, COPY_MAIN),
               '25d': _build(tmp, layout25d.SOURCE, JACOBI_MAIN)}


def _run(exe, args):
  proc = subprocess.run([str(exe), *map(str, args)], capture_output=True,
                        text=True, timeout=300,
                        env={'ASAN_OPTIONS': 'detect_leaks=0'})
  assert proc.returncode == 0, proc.stderr[-4000:]
  return proc.stdout.split()


def emulate_copy(exes, case, x, iters, eager, cp=None):
  """``case``'s kernel on the CPU block ``x`` at each of ``iters``
  iterations: (outputs, launch statuses, CTAs)."""
  tmp, built = exes
  rows, cols = x.shape
  cp = copyshift.copy_len((rows, cols), case.axis) if cp is None else cp
  src, out = tmp / 'copy.in', tmp / 'copy.out'
  x.numpy().tofile(src)
  words = _run(built['copy'], [int(eager), copyshift.KINDS.index(case.kind),
                               case.axis, rows, cols, cp, src, out,
                               len(case.dists), *case.dists, len(iters),
                               *iters])
  got = np.fromfile(out, np.int32).reshape(len(iters), rows, cols)
  return ([torch.from_numpy(g.copy()) for g in got],
          [int(w) for w in words[0::2]], [int(w) for w in words[1::2]])


COPY_CASES = [c for c in copyshift.MAIN_CASES + copyshift.CHECK_CASES
              if c.kind != 'rotate']


@pytest.mark.parametrize('eager', [False, True], ids=['deferred', 'eager'])
@pytest.mark.parametrize('case', COPY_CASES, ids=[c.name for c in COPY_CASES])
def test_emulated_copy_kernel_matches_its_plain_version(exes, case, eager):
  x = torch.from_numpy(np.random.default_rng(7).integers(
      -30000, 30000, SMALL, dtype=np.int32))
  outs, statuses, ctas = emulate_copy(exes, case, x, probes.CHECK_ITERS,
                                      eager)
  assert statuses == [0] * len(outs)
  assert set(ctas) == {32 if case.axis else 128}, ctas
  for n, got in zip(probes.CHECK_ITERS, outs):
    assert torch.equal(got, copyshift.copy_plain(case, x, n)), (case.name, n)


def test_emulated_copy_launch_refuses_what_no_bulk_copy_can_do(exes):
  x = torch.zeros(SMALL, dtype=torch.int32)
  lane = copyshift.CASES['dma5_lane_d8']
  # a lane copy not a multiple of four lanes
  assert emulate_copy(exes, lane, x, (1,), True, cp=1918)[1] == [1]
  # a copy past the block's end
  assert emulate_copy(exes, copyshift.CASES['dma5_sub_d8'], x, (1,), True,
                      cp=25)[1] == [1]
  # the fan along the lanes
  fan = copyshift._case('lane fan', 'fan', 1, (1, 3, 6, 9))
  assert emulate_copy(exes, fan, x, (1,), True)[1] == [1]
  assert emulate_copy(exes, lane, x, (1,), True)[1] == [0]


@pytest.mark.parametrize('eager', [False, True], ids=['deferred', 'eager'])
@pytest.mark.parametrize('shape, block', GRIDS,
                         ids=['%s-%d' % (s, b) for s, b in GRIDS])
def test_emulated_25d_kernel_matches_its_plain_version(exes, shape, block,
                                                       eager):
  tmp, built = exes
  x = layout25d.grid_input(shape, 'cpu')
  h, w = shape[0], shape[1] * shape[2]
  src, out = tmp / '25d.in', tmp / '25d.out'
  x.numpy().tofile(src)
  status, ctas = _run(built['25d'], [int(eager), h, w, block, src, out])
  assert (int(status), int(ctas)) == (0, (w // layout25d.BAND) * (h // block))
  got = torch.from_numpy(np.fromfile(out, np.float32).reshape(x.shape))
  # rows 0, 1, h-2 and h-1 are not written (the buffer's zeros stay)
  assert torch.equal(got, layout25d.jacobi25d_plain(x))
