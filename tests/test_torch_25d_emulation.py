"""exp9's 2.5-D jacobi CUDA text, its two kernels, run on the CPU through a
g++ emulation.

There is no nvcc without a card, so ``csrc/probe_25d.cu`` is compiled with
g++ under AddressSanitizer and UBSan against the copy emulation of
tests/test_torch_copy_emulation.py (CTAs of host threads,
``__syncthreads``, ``mbarrier``s, ``cp.async`` in commit groups) and the
stream emulation's bulk copies completing on an ``mbarrier``
(tests/test_torch_stream_emulation.py), with what the bulk kernel adds:

- warps of 32 host threads with a barrier of their own (``__syncwarp``);
- a plain ``mbarrier.arrive`` (the empty barriers);
- 2-D tensor maps and ``cp.async.bulk.tensor`` copies of a box, columns
  outside the tensor landing as zeros, the destination 128-byte aligned;
- the ring's slots tracked: a fill's bytes are live from their issue
  until the warp whose wait found them arrives on a barrier (its slot's
  empty one) and a wait on that barrier has then found the arrival; a
  fill into live bytes aborts ("a slot refilled before its readers were
  done") whatever the threads' timing.

Every copy is checked aligned, of a size a multiple of 16, its shared
side inside the CTA's shared memory and its global side (a box's rows)
inside the input. A fill lands when a wait on its barrier finds the
phase's arrival (deferred) or at once (eager); the old kernel's
``cp.async`` at its group's wait or at once. The bulk kernel (a tensor
copy a slab, one a wrap area) runs on grids of one band (both wraps in
one CTA) and of several, runs of 2-20 tiles on rings of 3-8 slots (most
runs not a multiple of the depth) with 1-4 sweeping warps, and on the
rings ``layout25d.ring`` picks for the script's blocks; the old kernel
on its grids; each output is held bit for bit to ``jacobi25d_plain`` and
to the kernel's walk. A source whose refill does not wait for the
slot's empty barrier must abort, and the launch refuses each ring the
kernel does not take. The card runs the same text
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from soda_tpu_torch.experiments import layout25d
from test_torch_copy_emulation import PRELUDE
from test_torch_stream_emulation import STREAM_PRELUDE

CSRC = (pathlib.Path(__file__).resolve().parents[1] / 'soda_tpu_torch' /
        'csrc')

J25_PRELUDE = r'''
#include <memory>
// -- warps: 32 of a CTA's threads with a barrier of their own ----------------
static std::barrier<>* soda_emu_warp_bars[32];
static const bool soda_emu_warps_made = [] {
  for (auto& b : soda_emu_warp_bars) b = new std::barrier<>(32);
  return true;
}();
static void __syncwarp(unsigned = 0xffffffffu) {
  soda_emu_warp_bars[threadIdx.x >> 5]->arrive_and_wait();
}
struct alignas(8) float2 { float x, y; };
[[noreturn]] static void trap() { soda_emu_fail("trap"); }

// -- 2-D tensor maps and their copies -----------------------------------------
#define __grid_constant__
struct CUtensorMap {
  const float* base;
  int h, w, box_cols, box_rows;
};
static int make_map(CUtensorMap* map, const void* x, int h, int w,
                    int box_cols, int box_rows) {
  if ((uintptr_t)x % 16 || (box_cols * 4) % 16 || box_cols > 256 ||
      box_rows > 256)
    return 1;
  *map = CUtensorMap{static_cast<const float*>(x), h, w, box_cols, box_rows};
  return 0;
}
// the box, columns outside the tensor zero, staged where a deferred
// landing copies it from
static std::vector<std::unique_ptr<float[]>> soda_emu_boxes;
static void tensor_load(void* dst, const CUtensorMap* map, int c, int r,
                        uint64_t* bar) {
  const unsigned bytes = 4u * map->box_cols * map->box_rows;
  if ((uintptr_t)dst % 128) soda_emu_fail("misaligned tensor copy");
  emu_in_smem(dst, bytes, "tensor copy destination outside shared memory");
  if (r < 0 || r + map->box_rows > map->h)
    soda_emu_fail("tensor box rows outside the tensor");
  std::lock_guard<std::mutex> g(soda_emu_mu);
  soda_emu_boxes.emplace_back(new float[bytes / 4]);
  float* box = soda_emu_boxes.back().get();
  for (int i = 0; i < map->box_rows; ++i)
    for (int j = 0; j < map->box_cols; ++j) {
      const int col = c + j;
      box[i * map->box_cols + j] =
          col < 0 || col >= map->w ? 0.0f
                                   : map->base[(size_t)(r + i) * map->w + col];
    }
  EmuBar& b = emu_bar(bar);
  EmuCopy copy{dst, box, bytes};
  if (soda_emu_eager) {
    emu_land(b, copy);
    emu_complete(b);
  } else {
    b.copies.push_back(copy);
  }
}

static void bar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> g(soda_emu_mu);
  EmuBar& b = emu_bar(bar);
  if (b.arrivals == 0) soda_emu_fail("more arrivals than the barrier counts");
  --b.arrivals;
  emu_complete(b);
}

// -- the ring's slots ---------------------------------------------------------
// A fill's bytes stay live from their issue: filled, claimed by the warp
// whose wait on their barrier found them, released when that warp
// arrives on a barrier (the slot's empty one), and free only once a
// thread's wait on that barrier has found the release. A fill into bytes
// that are not free aborts, whatever the threads' timing.
struct EmuLive {
  const unsigned char* at;
  unsigned bytes;
  const void* bar;  // the fill's barrier, then the release's
  int warp;  // -1 filled, else the claiming warp
  bool released;
};
static std::mutex soda_emu_live_mu;
static std::vector<EmuLive> soda_emu_live;
static void emu25_track(void* dst, unsigned bytes, uint64_t* bar) {
  std::lock_guard<std::mutex> g(soda_emu_live_mu);
  for (const EmuLive& l : soda_emu_live)
    if (emu_overlaps(dst, bytes, l.at, l.bytes))
      soda_emu_fail("a slot refilled before its readers were done");
  soda_emu_live.push_back(EmuLive{static_cast<const unsigned char*>(dst),
                                  bytes, bar, -1, false});
}
static bool emu25_try_wait(uint64_t* bar, unsigned parity) {
  if (!bar_try_wait(bar, parity)) return false;
  std::lock_guard<std::mutex> g(soda_emu_live_mu);
  for (EmuLive& l : soda_emu_live)
    if (l.bar == bar && !l.released && l.warp < 0)
      l.warp = (int)(threadIdx.x >> 5);
  std::erase_if(soda_emu_live,
                [&](const EmuLive& l) { return l.released && l.bar == bar; });
  return true;
}
static void emu25_arrive(uint64_t* bar) {
  {
    std::lock_guard<std::mutex> g(soda_emu_live_mu);
    for (EmuLive& l : soda_emu_live)
      if (!l.released && l.warp == (int)(threadIdx.x >> 5)) {
        l.released = true;
        l.bar = bar;
      }
  }
  bar_arrive(bar);
}
// at a CTA's end, once all its threads are done, every fill has been
// swept and released (the last ones need no wait: nothing refills them)
static void soda_emu_ring_exit() {
  __syncthreads();
  if (threadIdx.x == 0) {
    std::lock_guard<std::mutex> g(soda_emu_live_mu);
    for (const EmuLive& l : soda_emu_live)
      if (!l.released) soda_emu_fail("a fill never swept");
    soda_emu_live.clear();
  }
}
static void emu25_tensor_load(void* dst, const CUtensorMap* map, int c,
                              int r, uint64_t* bar) {
  emu25_track(dst, 4u * map->box_cols * map->box_rows, bar);
  tensor_load(dst, map, c, r, bar);
}
#define tensor_load emu25_tensor_load
#define bar_try_wait emu25_try_wait
#define bar_arrive emu25_arrive
'''

MAIN = r'''
// argv: eager kind(0 the old kernel, 1 the bulk kernel) h w block warps
// depth in out; prints the launch's status and CTAs
int main(int argc, char** argv) {
  soda_emu_eager = atoi(argv[1]) != 0;
  const int kind = atoi(argv[2]);
  const int h = atoi(argv[3]), w = atoi(argv[4]), block = atoi(argv[5]);
  const int warps = atoi(argv[6]), depth = atoi(argv[7]);
  const size_t n = (size_t)h * w;
  std::vector<float> x(n), y(n, 0.0f);
  FILE* f = fopen(argv[8], "rb");
  if (!f || fread(x.data(), 4, n, f) != n) abort();
  fclose(f);
  soda_emu_globals = {{(const unsigned char*)x.data(), n * 4}};
  int ctas = 0;
  const int status =
      kind == 0 ? probe_25d_launch(x.data(), y.data(), h, w, block, nullptr,
                                   &ctas)
                : probe_25d_bulk_launch(x.data(), y.data(), h, w, block,
                                        warps, depth, nullptr, &ctas);
  printf("%d %d\n", status, ctas);
  f = fopen(argv[9], "wb");
  fwrite(y.data(), 4, n, f);
  fclose(f);
  return 0;
}
'''

# the refill's wait for the slot's empty barrier, as the source has it
REFILL_WAIT = re.compile(
    r'if \(t >= depth\)\s*bar_wait\(&empty\[slot\],[^;]*;')

# (shape, block, warps, depth): one band (both wraps in one CTA) and
# several; runs of 2-20 tiles on rings of 3-8 slots (a multiple of the
# warps), all but (96, 4, 128)'s 6 tiles on 3 slots not a multiple of the
# depth; runs shorter than the ring; 1-4 sweeping warps
GRIDS = [((96, 1, 128), 32, 1, 3), ((96, 3, 128), 32, 2, 4),
         ((192, 2, 128), 64, 1, 3), ((128, 1, 128), 128, 3, 6),
         ((256, 2, 128), 128, 2, 6), ((160, 1, 128), 160, 2, 4),
         ((96, 4, 128), 96, 1, 3), ((320, 2, 128), 320, 4, 8),
         ((64, 2, 128), 64, 4, 8)]
# the launch's kind of each kernel
OLD, NEW = layout25d.KINDS['old'], layout25d.KINDS['new']
# the old kernel's grids (tests/test_torch_copy_emulation.py's, then a run
# of 5 tiles in one band and one of 2 in two)
OLD_GRIDS = [((96, 2, 128), 32), ((192, 2, 128), 64), ((128, 1, 128), 128),
             ((160, 1, 128), 160), ((64, 2, 128), 64)]


def emulated_source(text: str) -> str:
  """The source's CUDA text with its shared memory and launches rewritten
  for the emulation."""
  text = text.replace('#include <cuda_runtime.h>\n', '').replace(
      '#include <cuda.h>\n', '')
  text, shared = re.subn(
      r'extern __shared__ __align__\((\d+)\) unsigned char (smem_\w+)\[\];',
      r'unsigned char* \2 = soda_emu_smem;', text)
  text, launches = re.subn(
      r'(\w+)<<<(.*?)>>>\((.*?)\);',
      r'soda_emu_launch(\2, [=]() { \1(\3); soda_emu_ring_exit(); });', text,
      flags=re.S)
  assert (shared, launches) == (2, 2), (shared, launches)
  return PRELUDE + STREAM_PRELUDE + J25_PRELUDE + text


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


def mutated(text: str) -> str:
  """The source with the refill's wait for the slot's empty barrier taken
  out."""
  text, n = REFILL_WAIT.subn('', text)
  assert n == 1
  return text


@pytest.fixture(scope='module')
def exes(tmp_path_factory):
  tmp = tmp_path_factory.mktemp('emulation_25d')
  text = (CSRC / layout25d.SOURCE).read_text()
  return tmp, {'source': _build(tmp, 'j25', text),
               'mutated': _build(tmp, 'j25_mutated', mutated(text))}


def emulate(exes, x, block, kind, eager, warps=1, depth=3, exe='source'):
  """A kernel of the source (``kind``: OLD or NEW) on the CPU grid ``x``:
  (launch status, CTAs, output, the process)."""
  tmp, built = exes
  h = x.shape[0]
  w = x.numel() // h
  src, out = tmp / 'x.in', tmp / 'y.out'
  x.numpy().tofile(src)
  proc = subprocess.run(
      [str(built[exe]), str(int(eager)), str(kind), str(h), str(w),
       str(block), str(warps), str(depth), str(src), str(out)],
      capture_output=True, text=True, timeout=300,
      env={'ASAN_OPTIONS': 'detect_leaks=0'})
  if proc.returncode:
    return None, None, None, proc
  status, ctas = map(int, proc.stdout.split())
  got = torch.from_numpy(np.fromfile(out, np.float32).reshape(x.shape))
  return status, ctas, got, proc


@pytest.mark.parametrize('eager', [False, True], ids=['deferred', 'eager'])
@pytest.mark.parametrize('shape, block, warps, depth', GRIDS,
                         ids=['%s-%d-w%d-d%d' % g for g in GRIDS])
def test_emulated_bulk_kernel_matches_its_plain_versions(exes, shape, block,
                                                         warps, depth, eager):
  x = layout25d.grid_input(shape, 'cpu')
  status, ctas, got, proc = emulate(exes, x, block, NEW, eager, warps, depth)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert (status, ctas) == (0, layout25d.ctas(shape, block))
  # rows 0, 1, h-2 and h-1 are not written: the buffer's zeros stay, as
  # the plain versions'
  assert torch.equal(got, layout25d.jacobi25d_plain(x))
  assert torch.equal(got, layout25d.jacobi25d_walk(x, block))


@pytest.mark.parametrize('eager', [False, True], ids=['deferred', 'eager'])
@pytest.mark.parametrize('shape, block', OLD_GRIDS,
                         ids=['%s-%d' % g for g in OLD_GRIDS])
def test_emulated_old_kernel_matches_its_plain_versions(exes, shape, block,
                                                        eager):
  x = layout25d.grid_input(shape, 'cpu')
  status, ctas, got, proc = emulate(exes, x, block, OLD, eager)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert (status, ctas) == (0, layout25d.ctas(shape, block))
  assert torch.equal(got, layout25d.jacobi25d_plain(x))
  assert torch.equal(got, layout25d.jacobi25d_walk(x, block, _old=True))


# (the script's block, its ring at (8192, 2048) on 132 SMs, a small grid
# and block to run it on): at 256 a run of 8 tiles on 4 slots, at 512 16
# on 8, at 1024 a run of 2 tiles, shorter than the ring
HOST_RINGS = [(256, (2, 4), (128, 2, 128), 128),
              (512, (4, 8), (256, 1, 128), 256),
              (1024, (8, 16), (64, 2, 128), 32)]


@pytest.mark.parametrize('eager', [False, True], ids=['deferred', 'eager'])
@pytest.mark.parametrize('script_block, ring, shape, block', HOST_RINGS,
                         ids=['block%d' % r[0] for r in HOST_RINGS])
def test_emulated_bulk_kernel_on_the_ring_the_host_picks(
    exes, script_block, ring, shape, block, eager):
  """The ring ``layout25d.ring`` gives each of the script's blocks at
  (8192, 2048) on 132 SMs, on a small grid."""
  assert layout25d.ring(layout25d.ctas(layout25d.SHAPE, script_block)) == ring
  x = layout25d.grid_input(shape, 'cpu')
  status, _, got, proc = emulate(exes, x, block, NEW, eager, *ring)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert status == 0 and torch.equal(got, layout25d.jacobi25d_plain(x))


# (block, warps, depth) the bulk launch refuses on a (96, 1, 128) grid
REFUSED = [(24, 1, 3),  # a run of whole 16-row tiles
           (32, 1, 2),  # two fills in flight
           (32, 2, 5),  # each slot one warp's
           (32, 9, 18),  # at most 8 warps
           (32, 2, 26),  # at most 24 slots
           (32, 0, 3)]  # a sweeping warp


@pytest.mark.parametrize('block, warps, depth', REFUSED,
                         ids=['b%d-w%d-d%d' % r for r in REFUSED])
def test_emulated_bulk_launch_refuses_what_the_kernel_does_not_take(
    exes, block, warps, depth):
  x = layout25d.grid_input((96, 1, 128), 'cpu')
  status, _, _, proc = emulate(exes, x, block, NEW, True, warps, depth)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert status == 1, (block, warps, depth)


# grids whose CTAs refill a slot
REFILL_GRIDS = [g for g in GRIDS if g[1] // layout25d.BULK_TILE > g[3]]


@pytest.mark.parametrize('eager', [False, True], ids=['deferred', 'eager'])
@pytest.mark.parametrize('shape, block, warps, depth', REFILL_GRIDS,
                         ids=['%s-%d-w%d-d%d' % g for g in REFILL_GRIDS])
def test_emulation_catches_a_refill_before_the_slot_was_swept(
    exes, shape, block, warps, depth, eager):
  """The source without the refill's wait on the slot's empty barrier
  aborts: eager, at the refill's copy into the slot; deferred, where the
  slot's first fill has not landed yet, already at its second arrival
  on the slot's full barrier in one phase."""
  x = layout25d.grid_input(shape, 'cpu')
  _, _, _, proc = emulate(exes, x, block, NEW, eager, warps, depth,
                          exe='mutated')
  assert proc.returncode != 0
  said = proc.stderr.splitlines()[0] if proc.stderr else ''
  assert said == 'a slot refilled before its readers were done' or (
      not eager and said == 'more arrivals than the barrier counts'), said
