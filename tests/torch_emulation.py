"""A host emulation of the generated CUDA kernels, for the CPU tests.

There is no nvcc on a machine without a card, so the kernel text of a
plan (backend/cuda_source.py) is compiled with g++ against a small
emulation of what it uses: a CTA is 512 host threads (``threadIdx``),
``__syncthreads`` a barrier, a warp 32 of them with a barrier of their
own (``__syncwarp``; ``__shfl_sync`` posts each lane's value between two
of its barriers), ``__vadd2`` and ``__byte_perm`` as the PTX manual
defines them, shared memory one buffer per CTA filled with a non-zero
pattern first, and ``soda::cp_async`` a copy that lands when
``cp_async_wait`` retires its group (deferred) or at once (eager): a
kernel right under both orders reads no slot before its copies land
and overwrites none that is still read. Each copy's alignment is
checked, and the build runs under AddressSanitizer and UBSan, so a read
past an input or past shared memory fails. The card runs the same text
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import os
import pathlib
import subprocess

import numpy as np

from soda_tpu_torch.backend import cuda_source
from soda_tpu_torch.backend.cuda_source import THREADS, storage_ctype

CSRC = (pathlib.Path(__file__).resolve().parents[1] / 'soda_tpu_torch' /
        'csrc')

PRELUDE = r'''
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>

struct SodaDim { unsigned x = 0, y = 0, z = 0; };
static thread_local SodaDim threadIdx;
static SodaDim blockIdx;
static std::barrier<>* soda_emu_sync = nullptr;
static unsigned char* soda_emu_smem = nullptr;
static bool soda_emu_eager = false;
static void __syncthreads() { soda_emu_sync->arrive_and_wait(); }

// a warp: 32 of the CTA's threads, with a barrier of their own
static std::barrier<>* soda_emu_warp[%(warps)d];
static unsigned long long soda_emu_lanes[%(threads)d];
static void __syncwarp(unsigned = 0xffffffffu) {
  soda_emu_warp[threadIdx.x >> 5]->arrive_and_wait();
}
// each lane posts its value, the warp meets, each reads its source
// lane's, the warp meets again (so the slots may be reused)
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  unsigned long long u = 0;
  memcpy(&u, &v, sizeof(T));
  soda_emu_lanes[threadIdx.x] = u;
  __syncwarp();
  u = soda_emu_lanes[(threadIdx.x & ~31u) + ((unsigned)src & 31u)];
  __syncwarp();
  T out;
  memcpy(&out, &u, sizeof(T));
  return out;
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
#define SODA_EMULATE

#define __global__
#define __device__
#define __forceinline__
#define __launch_bounds__(n)

#include "soda_stencil.cuh"

namespace soda {
struct EmuCopy { void* dst; const void* src; int bytes, src_bytes; };
static thread_local std::vector<std::vector<EmuCopy>> emu_groups;
static thread_local std::vector<EmuCopy> emu_open;
static void emu_land(const EmuCopy& c) {
  memcpy(c.dst, c.src, c.src_bytes);
  memset((char*)c.dst + c.src_bytes, 0, c.bytes - c.src_bytes);
}
template <int Bytes>
void cp_async(void* dst, const void* src, int src_bytes) {
  if ((uintptr_t)dst %% Bytes || (src_bytes && (uintptr_t)src %% Bytes) ||
      src_bytes < 0 || src_bytes > Bytes) {
    fprintf(stderr, "misaligned cp.async\n");
    abort();
  }
  EmuCopy c{dst, src, Bytes, src_bytes};
  if (soda_emu_eager) emu_land(c); else emu_open.push_back(c);
}
static void cp_async_commit() {
  emu_groups.push_back(emu_open);
  emu_open.clear();
}
template <int N>
void cp_async_wait() {
  while (emu_groups.size() > (size_t)N) {
    for (const EmuCopy& c : emu_groups.front()) emu_land(c);
    emu_groups.erase(emu_groups.begin());
  }
}
static void store16(void* dst, const void* src) {
  if ((uintptr_t)dst %% 16 || (uintptr_t)src %% 16) {
    fprintf(stderr, "misaligned 16-byte store\n");
    abort();
  }
  memcpy(dst, src, 16);
}
}  // namespace soda
'''

MAIN = r'''
// argv: replicas, eager, then one file per input and param (read), then
// one per output (written)
int main(int argc, char** argv) {
  const long long replicas = atoll(argv[1]);
  soda_emu_eager = atoi(argv[2]) != 0;
  const long long sizes[] = {%(sizes)s};
  const int n_in = %(n_in)d, n_all = %(n_all)d;
  std::vector<unsigned char*> bufs;
  for (int i = 0; i < n_all; ++i) {
    bufs.push_back(new unsigned char[sizes[i]]);
    if (i < n_in) {
      FILE* f = fopen(argv[3 + i], "rb");
      if (!f || fread(bufs[i], 1, sizes[i], f) != (size_t)sizes[i]) abort();
      fclose(f);
    } else {
      memset(bufs[i], 0, sizes[i]);
    }
  }
  const long long blocks = %(ctas)dll * replicas;
  long long block = 0;
  auto next = [&]() noexcept {
    ++block;
    if (block < blocks) {
      blockIdx.x = (unsigned)(block %% %(ctas)d);
      blockIdx.y = (unsigned)(block / %(ctas)d);
      memset(soda_emu_smem, 0xa5, %(smem)d);
    }
  };
  std::barrier<> sync(%(threads)d);
  for (int w = 0; w < %(warps)d; ++w) soda_emu_warp[w] = new std::barrier<>(32);
  std::barrier<decltype(next)> done(%(threads)d, next);
  soda_emu_sync = &sync;
  soda_emu_smem = new unsigned char[%(smem)d];
  memset(soda_emu_smem, 0xa5, %(smem)d);
  std::vector<std::thread> threads;
  for (int t = 0; t < %(threads)d; ++t) {
    threads.emplace_back([&, t]() {
      threadIdx.x = t;
      while (block < blocks) {
        if (replicas == 1)
          soda_fused_%(digest)s<false>(%(args)s);
        else
          soda_fused_%(digest)s<true>(%(args)s);
        // groups left at the end must be the empty ones committed for
        // steps past the run's end
        for (const auto& group : soda::emu_groups)
          if (!group.empty()) {
            fprintf(stderr, "copies never waited for\n");
            abort();
          }
        if (!soda::emu_open.empty()) {
          fprintf(stderr, "copies never committed\n");
          abort();
        }
        soda::emu_groups.clear();
        done.arrive_and_wait();
      }
    });
  }
  for (auto& t : threads) t.join();
  for (int i = n_in; i < n_all; ++i) {
    FILE* f = fopen(argv[3 + i], "wb");
    if (!f || fwrite(bufs[i], 1, sizes[i], f) != (size_t)sizes[i]) abort();
    fclose(f);
  }
  for (unsigned char* b : bufs) delete[] b;
  delete[] soda_emu_smem;
  return 0;
}
'''


def compile_kernel(gxx, tmp, index, plan, reps):
  """The emulation of the case's kernel: the stage functions and the
  kernel text of its generated source (no launcher), the prelude and a
  main program; returns the executable."""
  stencil = plan.stencil
  text = cuda_source.generate(plan).text
  parts = text.split('#ifdef __CUDACC__\n')
  stages = parts[1].split('#endif\n', 1)[1]
  kernel = parts[2].split('extern "C" int soda_launch_')[0].replace(
      'extern __shared__ __align__(16) unsigned char soda_smem[];',
      'unsigned char* soda_smem = soda_emu_smem;')
  digest = kernel.split('soda_fused_')[1].split('(')[0]
  cells = int(np.prod(plan.shape))
  sizes, casts = [], []
  for n in stencil.input_names:
    t = stencil.symbol_table[n]
    casts.append('(const %s*)bufs[%d]' % (storage_ctype(t), len(sizes)))
    sizes.append(reps * cells * t.np_dtype.itemsize)
  for stmt in stencil.param_stmts:
    casts.append('(const %s*)bufs[%d]' % (storage_ctype(stmt.dtype),
                                          len(sizes)))
    sizes.append(int(np.prod(stmt.size)) * stmt.dtype.np_dtype.itemsize)
  n_in = len(sizes)
  for n in stencil.output_names:
    t = stencil.symbol_table[n]
    casts.append('(%s*)bufs[%d]' % (storage_ctype(t), len(sizes)))
    sizes.append(reps * cells * t.np_dtype.itemsize)
  main = MAIN % {
      'sizes': ', '.join('%dll' % s for s in sizes), 'n_in': n_in,
      'n_all': len(sizes), 'ctas': plan.n_ctas, 'smem': plan.smem_bytes,
      'threads': THREADS, 'warps': THREADS // 32, 'digest': digest,
      'args': ', '.join(casts)}
  src = tmp / ('case%d.cpp' % index)
  prelude = PRELUDE % {'threads': THREADS, 'warps': THREADS // 32}
  src.write_text('\n'.join([prelude, '#define SODA_STAGE static inline',
                            stages, kernel, main]))
  exe = tmp / ('case%d' % index)
  proc = subprocess.run(
      [gxx, '-std=c++20', '-O1', '-pthread', '-ffp-contract=off',
       '-fsanitize=address,undefined', '-fno-sanitize-recover=all',
       '-Wno-unknown-pragmas', '-I', str(CSRC),
       '-o', str(exe), str(src)], capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(proc.stderr[-4000:])
  return exe


def run_kernel(exe, tmp, stencil, grids, params, eager):
  paths = []
  for n in stencil.input_names:
    path = tmp / ('%s.in.%s' % (exe.name, n))
    np.ascontiguousarray(np.stack([g[n] for g in grids])).tofile(path)
    paths.append(str(path))
  for stmt in stencil.param_stmts:
    path = tmp / ('%s.par.%s' % (exe.name, stmt.name))
    np.ascontiguousarray(params[stmt.name]).tofile(path)
    paths.append(str(path))
  outs = [tmp / ('%s.out.%s' % (exe.name, n)) for n in stencil.output_names]
  proc = subprocess.run([str(exe), str(len(grids)), str(int(eager)), *paths,
                         *map(str, outs)], capture_output=True, text=True,
                        timeout=300,
                        env=dict(os.environ, ASAN_OPTIONS='detect_leaks=0'))
  if proc.returncode != 0:
    raise RuntimeError(proc.stderr[-4000:])
  return [np.fromfile(p, stencil.symbol_table[n].np_dtype)
          for p, n in zip(outs, stencil.output_names)]


