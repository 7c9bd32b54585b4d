"""The streaming probe's CUDA text, run on the CPU through a g++ emulation.

There is no nvcc without a card, so ``csrc/probe_stream.cu`` is compiled
with g++ under AddressSanitizer and UBSan against the copy emulation of
tests/test_torch_copy_emulation.py (its CTAs of host threads,
``__syncthreads``, ``mbarrier``s, 16-byte ``cp.async`` in commit groups),
extended here with what the bulk kernel uses:

- ``cp.async.bulk`` global -> shared completing on an ``mbarrier``
  (``bulk_load``);
- ``cp.async.bulk`` shared -> global in the issuing thread's bulk groups
  (``bulk_store``), ``commit_group`` and ``wait_group.read``.

Every copy is checked 16-byte aligned, of a size that is a multiple of
16, its shared side inside the CTA's shared memory and its global side
inside the input or the output. A fill lands when a wait on its barrier
finds it (deferred) or at once (eager); a store reads its slot at the
``wait_group.read`` that retires its group (deferred) or at once
(eager). A fill issued into a slot that a store has still to read
aborts, and so does a CTA that ends with a store not waited for. So a
kernel right under both orders reads no slot before its fill lands and
refills none before its store has read it.

Every case of exp27 and exp30 runs on the old kernel and on the bulk
kernel, on a few dozen tiles: the loop form on ``probes.CPU_CTAS`` CTAs,
so runs are ragged, the grid form's last run short; each output is held
bit for bit to ``stream_probe_plain`` walking the same CTAs and to
x + 1. A source with the store's ``wait_group.read`` before a refill
taken out must fail in every case whose CTAs refill a slot. The card
runs the same text (tests/test_torch_gpu.py, chip_smoke.py).
"""

import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from soda_tpu_torch.experiments import probes
from test_torch_copy_emulation import PRELUDE

CSRC = (pathlib.Path(__file__).resolve().parents[1] / 'soda_tpu_torch' /
        'csrc')
CASES = probes.EXP27_CASES + probes.EXP30_CASES
KERNELS = ('old', 'bulk')
TILES = 29  # 7 CTAs walk 5 or 4 tiles; grid runs of 8, 8, 8 and 5
FEW_TILES, FEW_CTAS = 13, 5  # 3, 3, 3, 2, 2 tiles: short of a 4-deep prologue

STREAM_PRELUDE = r'''
struct alignas(16) float4 { float x, y, z, w; };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
static cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
static cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return cudaSuccess;
}
static cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, const void*, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

// the global memory a launch may touch: its input and its output
static std::vector<std::pair<const unsigned char*, size_t>> soda_emu_globals;
static void emu_in_global(const void* p, size_t bytes, const char* what) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  for (const auto& [at, size] : soda_emu_globals)
    if (c >= at && c + bytes <= at + size) return;
  soda_emu_fail(what);
}
static void emu_bulk_aligned(const void* a, const void* b, unsigned bytes) {
  if ((uintptr_t)a % 16 || (uintptr_t)b % 16 || bytes % 16 || !bytes)
    soda_emu_fail("misaligned cp.async.bulk");
}

// a thread's bulk stores: the open group, and the committed ones whose
// sources have not been read yet
static thread_local std::vector<EmuCopy> soda_emu_store_open;
static thread_local std::vector<std::vector<EmuCopy>> soda_emu_store_groups;
static bool emu_overlaps(const void* a, size_t n, const void* b, size_t m) {
  const unsigned char *x = (const unsigned char*)a, *y = (const unsigned char*)b;
  return x < y + m && y < x + n;
}

static void bulk_load(void* dst, const void* src, unsigned bytes,
                      uint64_t* bar) {
  emu_bulk_aligned(dst, src, bytes);
  emu_in_smem(dst, bytes, "bulk load destination outside shared memory");
  emu_in_global(src, bytes, "bulk load source outside the input");
  for (const auto& group : soda_emu_store_groups)
    for (const EmuCopy& c : group)
      if (emu_overlaps(dst, bytes, c.src, c.bytes))
        soda_emu_fail("a slot refilled before its bulk store read it");
  for (const EmuCopy& c : soda_emu_store_open)
    if (emu_overlaps(dst, bytes, c.src, c.bytes))
      soda_emu_fail("a slot refilled before its bulk store read it");
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
static void bulk_store(void* dst, const void* src, unsigned bytes) {
  emu_bulk_aligned(dst, src, bytes);
  emu_in_smem(src, bytes, "bulk store source outside shared memory");
  emu_in_global(dst, bytes, "bulk store destination outside the output");
  if (soda_emu_eager)
    memcpy(dst, src, bytes);
  else
    soda_emu_store_open.push_back(EmuCopy{dst, src, bytes});
}
static void bulk_commit() {
  soda_emu_store_groups.push_back(soda_emu_store_open);
  soda_emu_store_open.clear();
}
template <int N>
static void bulk_wait_read() {
  while (soda_emu_store_groups.size() > (size_t)N) {
    for (const EmuCopy& c : soda_emu_store_groups.front())
      memcpy(c.dst, c.src, c.bytes);
    soda_emu_store_groups.erase(soda_emu_store_groups.begin());
  }
}
// at a thread's exit from a CTA: no bulk store left to read its slot
static void soda_emu_bulk_exit() {
  if (!soda_emu_store_open.empty() || !soda_emu_store_groups.empty())
    soda_emu_fail("a bulk store never waited for");
}
'''

MAIN = r'''
// argv: eager old(1 the old kernel, 0 the bulk one) kind depth split
// chunks tiles run ctas in out; prints the launch's status
int main(int argc, char** argv) {
  soda_emu_eager = atoi(argv[1]) != 0;
  const bool old = atoi(argv[2]) != 0;
  const int kind = atoi(argv[3]);
  const int depth = atoi(argv[4]), split = atoi(argv[5]);
  const int chunks = atoi(argv[6]);
  const long long tiles = atoll(argv[7]);
  const int run = atoi(argv[8]), ctas = atoi(argv[9]);
  const size_t n = (size_t)tiles * chunks * 4;
  std::vector<float> x(n), y(n, -7.0f);
  FILE* f = fopen(argv[10], "rb");
  if (!f || fread(x.data(), 4, n, f) != n) abort();
  fclose(f);
  soda_emu_globals = {{(const unsigned char*)x.data(), n * 4},
                      {(const unsigned char*)y.data(), n * 4}};
  const int status =
      old ? probe_stream_launch(kind, depth, split, x.data(), y.data(), tiles,
                                chunks, run, ctas, nullptr)
          : probe_stream_bulk_launch(kind, depth, split, x.data(), y.data(),
                                     tiles, chunks, run, ctas, nullptr);
  printf("%d\n", status);
  f = fopen(argv[11], "wb");
  fwrite(y.data(), 4, n, f);
  fclose(f);
  return 0;
}
'''

# the refill's wait for the store before it, as the source has it
BULK_REFILL_WAIT = 'if (s > 0) bulk_wait_read<0>();'


def emulated_source(text: str) -> str:
  """The source's CUDA text with its shared memory and launches rewritten
  for the emulation."""
  text = text.replace('#include <cuda_runtime.h>\n', '')
  text, bulk = re.subn(
      r'extern __shared__ __align__\(128\) unsigned char smem_raw\[\];',
      'unsigned char* smem_raw = soda_emu_smem;', text)
  text, old = re.subn(
      r'extern __shared__ float4 smem\[\];',
      'float4* smem = reinterpret_cast<float4*>(soda_emu_smem);', text)
  text, launches = re.subn(
      r'(\w+)<<<(.*?)>>>\((.*?)\);',
      r'soda_emu_launch(\2, [=]() { \1(\3); soda_emu_bulk_exit(); });', text,
      flags=re.S)
  assert (bulk, old, launches) == (1, 1, 2), (bulk, old, launches)
  return PRELUDE + STREAM_PRELUDE + text


def _build(tmp, name, text):
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('needs g++')
  src = tmp / (name + '.cc')
  src.write_text(emulated_source(text) + MAIN)
  exe = tmp / name
  proc = subprocess.run(
      [gxx, '-std=c++20', '-O1', '-g', '-pthread',
       '-fsanitize=address,undefined', '-fno-sanitize-recover=all', '-Wall',
       '-Wno-unused-function', '-Wno-unused-variable',
       '-Wno-unknown-pragmas', '-o', str(exe), str(src)],
      capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stderr[-4000:]
  return exe


def _mutated(text: str) -> str:
  """The source with the refill's wait for the store before it taken
  out."""
  assert text.count(BULK_REFILL_WAIT) == 1
  return text.replace(BULK_REFILL_WAIT, '')


@pytest.fixture(scope='module')
def exes(tmp_path_factory):
  tmp = tmp_path_factory.mktemp('stream_emulation')
  text = (CSRC / probes.SOURCES[0]).read_text()
  return tmp, {'source': _build(tmp, 'stream', text),
               'mutated': _build(tmp, 'mutated', _mutated(text))}


def emulate(exes, case, kernel, x, ctas, eager, exe='source'):
  """``case``'s kernel (``kernel``: 'old' or 'bulk') on the CPU tensor
  ``x`` over ``ctas`` CTAs: (launch status, output, the process)."""
  tmp, built = exes
  tiles = x.numel() // probes._tile_floats(case.blk)
  src, out = tmp / 'x.in', tmp / 'y.out'
  x.numpy().tofile(src)
  proc = subprocess.run(
      [str(built[exe]), str(int(eager)), str(int(kernel == 'old')),
       str(probes.KINDS[case.kind]), str(case.depth), str(case.split),
       str(probes._tile_floats(case.blk) // 4), str(tiles),
       str(probes._stream_run(case.depth)), str(ctas), str(src), str(out)],
      capture_output=True, text=True, timeout=300,
      env={'ASAN_OPTIONS': 'detect_leaks=0'})
  if proc.returncode:
    return None, None, proc
  got = torch.from_numpy(np.fromfile(out, np.float32).reshape(x.shape))
  return int(proc.stdout.split()[0]), got, proc


def _input(case, tiles, seed=3):
  return torch.from_numpy(np.random.default_rng(seed).standard_normal(
      tiles * probes._tile_floats(case.blk), dtype=np.float32))


@pytest.mark.parametrize('eager', [False, True], ids=['deferred', 'eager'])
@pytest.mark.parametrize('kernel', KERNELS)
@pytest.mark.parametrize('case', CASES, ids=[c.name for c in CASES])
def test_emulated_stream_kernel_is_x_plus_one(exes, case, kernel, eager):
  x = _input(case, TILES)
  ctas = probes.stream_ctas(*case.args, TILES, 'cpu')
  status, got, proc = emulate(exes, case, kernel, x, ctas, eager)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert status == 0
  assert torch.equal(got, probes.stream_probe_plain(x, *case.args,
                                                    ctas=ctas))
  assert torch.equal(got, x + 1)


SHORT_WALK_CASES = [c for c in CASES if c.kind == 'loop' and c.depth > 2]


@pytest.mark.parametrize('kernel', KERNELS)
@pytest.mark.parametrize('case', SHORT_WALK_CASES,
                         ids=[c.name for c in SHORT_WALK_CASES])
def test_emulated_stream_kernel_walks_shorter_than_its_ring(exes, case,
                                                            kernel):
  """Each CTA walks fewer tiles than the ring's prologue fills."""
  x = _input(case, FEW_TILES, seed=4)
  status, got, proc = emulate(exes, case, kernel, x, FEW_CTAS, eager=False)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert status == 0 and torch.equal(got, x + 1)


# the cases whose CTAs refill a slot (grid sync's walk one tile each)
REFILL_CASES = [c for c in CASES if (c.kind, c.depth) != ('grid', 1)]


@pytest.mark.parametrize('case', REFILL_CASES,
                         ids=[c.name for c in REFILL_CASES])
def test_emulation_catches_a_refill_before_the_store_read_its_slot(
    exes, case):
  """The source without the refill's wait passes when stores read their
  slots at issue, and aborts when they read them at their wait."""
  x = _input(case, TILES)
  ctas = probes.stream_ctas(*case.args, TILES, 'cpu')
  status, _, proc = emulate(exes, case, 'bulk', x, ctas, eager=True,
                            exe='mutated')
  assert proc.returncode == 0 and status == 0  # the store landed at issue
  _, _, proc = emulate(exes, case, 'bulk', x, ctas, eager=False,
                       exe='mutated')
  assert proc.returncode != 0
  assert 'refilled before its bulk store read it' in proc.stderr

