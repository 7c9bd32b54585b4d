"""The mode kernels' generated CUDA, run on the CPU by an emulation.

There is no nvcc here, so the kernel text of a mode plan (stream_loop,
prefetch, dma_split, out_dma: backend/cuda_source.py ``_mode_kernel``)
is compiled with g++ against a small emulation of what it uses: a CTA
is 512 host threads (``threadIdx``), ``__syncthreads`` a barrier, shared
memory one buffer per CTA filled with a non-zero pattern first, and
``soda::cp_async`` a copy that lands when ``cp_async_wait`` retires its
group (deferred) or at once (eager): a kernel right under both orders
reads no slot before its copies land and overwrites none that is still
read. Each copy's alignment is checked, and the build runs under
AddressSanitizer, so a read past an input or past shared memory fails.
Each kernel's outputs are held against the NumPy oracle on their valid
regions: integers bit-exact, floats within the reference threshold.
The card runs the same text (tests/test_torch_gpu.py, chip_smoke.py).
"""

import concurrent.futures
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from soda_tpu_torch.backend import cuda_source, reference, tile_plan
from soda_tpu_torch.backend.cuda_source import THREADS, storage_ctype
from soda_tpu_torch.testing import (MODE_CASES as CASES, check_outputs,
                                    mode_inputs, mode_stencil)

REPO = pathlib.Path(__file__).resolve().parent.parent

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
  if ((uintptr_t)dst % Bytes || (src_bytes && (uintptr_t)src % Bytes) ||
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
  if ((uintptr_t)dst % 16 || (uintptr_t)src % 16) {
    fprintf(stderr, "misaligned 16-byte store\n");
    abort();
  }
  memcpy(dst, src, 16);
}
}  // namespace soda
'''

DRIVER = r'''
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


def _case_id(case):
  name, shape, opts, min_ctas, reps = case
  keys = '-'.join('%s=%s' % kv for kv in sorted(opts.items()))
  return '%s-%s-%s-ctas%d-r%d' % (name, 'x'.join(map(str, shape)), keys,
                                  min_ctas, reps)


def _plan(case):
  name, shape, opts, min_ctas, _ = case
  saved = tile_plan.MIN_CTAS
  tile_plan.MIN_CTAS = min_ctas
  try:
    return tile_plan.kernel_plan(mode_stencil(name), shape, **opts)
  finally:
    tile_plan.MIN_CTAS = saved


def _compile(gxx, tmp, index, case, plan):
  """The emulation of the case's kernel: the stage functions and the
  kernel text of its generated source (no launcher), the prelude and a
  driver; returns the executable."""
  stencil = plan.stencil
  text = cuda_source.generate(plan).text
  parts = text.split('#ifdef __CUDACC__\n')
  stages = parts[1].split('#endif\n', 1)[1]
  kernel = parts[2].split('extern "C" int soda_launch_')[0].replace(
      'extern __shared__ __align__(16) unsigned char soda_smem[];',
      'unsigned char* soda_smem = soda_emu_smem;')
  digest = kernel.split('soda_fused_')[1].split('(')[0]
  reps = case[4]
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
  driver = DRIVER % {
      'sizes': ', '.join('%dll' % s for s in sizes), 'n_in': n_in,
      'n_all': len(sizes), 'ctas': plan.n_ctas, 'smem': plan.smem_bytes,
      'threads': THREADS, 'digest': digest, 'args': ', '.join(casts)}
  src = tmp / ('case%d.cpp' % index)
  src.write_text('\n'.join([PRELUDE, '#define SODA_STAGE static inline',
                            stages, kernel, driver]))
  exe = tmp / ('case%d' % index)
  proc = subprocess.run(
      [gxx, '-std=c++20', '-O1', '-pthread', '-ffp-contract=off',
       '-fsanitize=address,undefined', '-fno-sanitize-recover=all',
       '-Wno-unknown-pragmas', '-I', str(REPO / 'soda_tpu_torch' / 'csrc'),
       '-o', str(exe), str(src)], capture_output=True, text=True)
  assert proc.returncode == 0, proc.stderr[-4000:]
  return exe


@pytest.fixture(scope='module')
def built(tmp_path_factory):
  """Every case's plan and emulation (the compilers run at once)."""
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('no g++ on this machine')
  tmp = tmp_path_factory.mktemp('emu')
  plans = [_plan(case) for case in CASES]
  with concurrent.futures.ThreadPoolExecutor(4) as pool:
    exes = list(pool.map(lambda i: _compile(gxx, tmp, i, CASES[i], plans[i]),
                         range(len(CASES))))
  return tmp, plans, exes


def _run(exe, tmp, stencil, grids, params, eager):
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
  assert proc.returncode == 0, proc.stderr[-4000:]
  return [np.fromfile(p, stencil.symbol_table[n].np_dtype)
          for p, n in zip(outs, stencil.output_names)]


@pytest.mark.parametrize('index', range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_mode_kernel_matches_oracle(built, index):
  tmp, plans, exes = built
  name, shape, _, _, reps = CASES[index]
  stencil = plans[index].stencil
  grids = mode_inputs(stencil, name, shape, reps)
  params = reference.make_test_params(stencil)
  for eager in (False, True):
    outs = _run(exes[index], tmp, stencil, grids, params, eager)
    for r, grid in enumerate(grids):
      got = {n: o.reshape((len(grids),) + shape)[r]
             for n, o in zip(stencil.output_names, outs)}
      with np.errstate(all='ignore'):
        want = reference.run(stencil, grid, params)
      check_outputs(stencil, shape, got, want, '%s %s replica %d' % (
          name, 'eager' if eager else 'deferred', r))


def test_cases_reach_every_path():
  """The cases above cover each branch of the generated mode kernel."""
  plans = [_plan(case) for case in CASES]
  seen = set()
  for plan in plans:
    cfg = plan.config
    seen.add('slots%d' % plan.slots)
    seen.add('split' if cfg.dma_split > 1 else 'whole fill')
    if plan.rolling:
      seen.add('rolling')
    if plan.peel and plan.steady[0] <= plan.steady[1]:
      seen.add('peel steady')
    elif cfg.stream_loop == 'peel':
      seen.add('peel under 4 steps')
    if plan.n_chunks > 1 and plan.grid[0] % plan.steps:
      seen.add('ragged last run')
    for name in plan.stencil.input_names:
      if plan.buffered(name):
        width, phase = tile_plan.copy_width(plan.stencil, name, plan.shape,
                                            plan.tile, plan.spans)
        itemsize = plan.dtype(name).np_dtype.itemsize
        seen.add('copy %d/%d phase %d' % (width, itemsize, phase))
    if cfg.out_dma:
      for name in plan.stencil.output_names:
        itemsize = plan.dtype(name).np_dtype.itemsize
        vec = (plan.tile[-1] * itemsize % 16 == 0 and
               plan.shape[-1] * itemsize % 16 == 0)
        seen.add('store16' if vec else 'store element')
  assert seen >= {
      'slots1', 'slots2', 'slots3', 'slots4', 'split', 'whole fill',
      'rolling', 'peel steady', 'peel under 4 steps', 'ragged last run',
      'copy 4/2 phase 0', 'copy 4/2 phase 1', 'copy 0/2 phase 0',
      'copy 0/1 phase 0', 'copy 4/4 phase 0', 'copy 8/8 phase 0',
      'store16', 'store element'}, sorted(seen)
