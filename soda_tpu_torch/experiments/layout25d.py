"""exp9's 2.5-D jacobi probe: its kernels, its plain versions and bound.

One hand-written CUDA source, ``csrc/probe_25d.cu``, replaces the Pallas
probe of experiments/exp9_layout25d.py:108 (``build_25d``): two fused
jacobi2d sweeps, ``(c + n + s + e + w) * 0.2f``, over the grid the script
sees as (h, W/128, 128), east and west wrapping at the ends of a row of W
(its chunk-boundary fix-up, :40-58). Rows [2, h-2) are stored, every
column; rows 0, 1, h-2 and h-1 are not written, as on the TPU. On the
card a CTA owns a band of BAND columns and a run of ``block`` rows (the
script's block) and walks it a tile of rows at a time. The default
kernel, the bulk kernel ``jacobi25d_tmap``: a ring of ``depth`` slabs of
BULK_TILE + 4 rows, each filled by one 2-D tensor copy (and the wrapped
columns of the first and last bands by one more each) on an
``mbarrier``, and ``warps`` warps sharing out the tiles, each walking
its slab's rows with both sweeps in registers (``ring`` picks warps and
depth). The old kernel
(``_old=True``, private to the tests, ``chip_smoke.py`` and
``layout25d_replay``): two shared-memory slabs of TILE + 4 rows by
``cp.async``, sweep 1 through shared memory (see the source).

``jacobi25d_plain`` is the whole-grid function; ``jacobi25d_walk``
follows a kernel: its CTAs' row runs, their tiles, each tile's clipped
slab start and ring slot (the default kernel's: the slot a tile takes,
filled ``depth`` tiles ahead and refilled once its warp has swept it;
the old kernel's: two slots, the next tile's filled first), the wrapped
halo columns and the rows each tile stores. Both leave rows 0, 1, h-2
and h-1 zero. ``jacobi25d`` launches a kernel for a CUDA tensor
(raising if CUDA refuses) and runs its walk only for a CPU tensor; each
launch adds one to ``probes.LAUNCHES[(KERNEL, 'block <block>')]`` (the
old kernel: ``OLD_KERNEL``'s key).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from soda_tpu_torch import profiling, utils
from soda_tpu_torch.backend import tile_plan
from soda_tpu_torch.experiments import probes

SOURCE = 'probe_25d.cu'
KERNEL = 'probe_25d'  # probes.LAUNCHES' key: (KERNEL, 'block <block>')
OLD_KERNEL = 'probe_25d[old]'  # the old kernel's
# the kernels, the old one and the new (bulk) one: their kinds in the
# source's host interface and their entries' names in the built source
KINDS = {'old': 0, 'new': 1}
ENTRIES = {'old': 'jacobi25d', 'new': 'jacobi25d_tmap'}
SCRIPT = 'exp9_layout25d'
LINE = 108
LANES = 128  # the script's chunk
BAND = 128  # columns a CTA owns (the source's kBand)
TILE = 32  # rows a tile of the old kernel (kTile)
HALO = 2  # two sweeps, a row or column each
# the bulk kernel (kBulkTile, kSlotBytes, kBulkBarBytes, kMaxWarps,
# kMaxDepth): a slot is BULK_TILE + 4 rows of BAND + 8 floats and two
# wrap areas, 128-byte aligned
BULK_TILE = 16
SLOT_BYTES = 11648
BAR_BYTES = 384
MAX_WARPS = 8
MAX_DEPTH = 24
# experiments/exp9_layout25d.py:134-163: the grid, the blocks, the check
SHAPE = (8192, 16, LANES)
BLOCKS = (256, 512, 1024)
CHECK_SHAPE, CHECK_BLOCK = (64, 16, LANES), 32
_FIFTH = 0.2  # multiplied as float32, as the script's np.float32(0.2)


def grid_input(shape, device) -> torch.Tensor:
  """``default_rng(0).standard_normal(shape, float32)``: the script's
  check input (its timed run uses zeros; here the timed run takes this
  too, so that it is checked)."""
  x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
  return torch.from_numpy(x).to(device)


def _flat(x: torch.Tensor) -> torch.Tensor:
  """x as its (h, W) grid."""
  return x.reshape(x.shape[0], -1)


def _check(x: torch.Tensor, block: int) -> Tuple[int, int]:
  if x.dim() not in (2, 3) or x.dtype != torch.float32 or \
      not x.is_contiguous():
    raise utils.InputError('2.5-D jacobi: a contiguous float32 (h, W) or '
                           '(h, W/128, 128) grid, got %s %s' % (
                               x.dtype, tuple(x.shape)))
  h, w = _flat(x).shape
  if w % BAND or h < TILE + 2 * HALO or block < TILE or block % TILE or \
      h % block:
    raise utils.InputError('2.5-D jacobi: W a multiple of %d, h a multiple '
                           'of the block, the block of %d rows, h >= %d; '
                           'got (%d, %d), block %d' % (
                               BAND, TILE, TILE + 2 * HALO, h, w, block))
  return h, w


def _slab_sweep(v: torch.Tensor) -> torch.Tensor:
  """One jacobi sweep, (c + n + s + e + w) * 0.2f in that order, over v's
  rows [1, rows-1) and columns [1, cols-1): v's first and last columns
  are halo columns."""
  c = v[1:-1, 1:-1]
  return ((((c + v[:-2, 1:-1]) + v[2:, 1:-1]) + v[1:-1, 2:]) +
          v[1:-1, :-2]) * v.new_tensor(_FIFTH)


def sweep(v: torch.Tensor) -> torch.Tensor:
  """One sweep over v's rows [1, rows-1), all its columns, east and west
  wrapping at the row's ends."""
  return _slab_sweep(torch.cat([v[:, -1:], v, v[:, :1]], 1))


def jacobi25d_plain(x: torch.Tensor) -> torch.Tensor:
  """The probe's function over the whole grid: two sweeps, rows [1, h-1)
  then [2, h-2); rows 0, 1, h-2 and h-1 zero."""
  v = _flat(x)
  out = torch.zeros_like(v)
  out[HALO:-HALO] = sweep(sweep(v))
  return out.reshape(x.shape)


def slab_start(t0: int, h: int, tile: int = TILE) -> int:
  """The first row of the slab of the tile of ``tile`` rows at row t0:
  HALO rows before it, clipped to [0, h - tile - 2 * HALO]
  (exp9_layout25d.py:64-69)."""
  return min(max(t0 - HALO, 0), h - tile - 2 * HALO)


def ctas(shape, block: int) -> int:
  """The grid's CTAs: a band of BAND columns by a run of ``block`` rows
  each."""
  h, w = shape[0], int(np.prod(shape[1:]))
  return (w // BAND) * (h // block)


def ring(n_ctas: int, sms: int = tile_plan.SMS) -> Tuple[int, int]:
  """(warps, depth) of the bulk kernel for a grid of ``n_ctas`` CTAs on
  ``sms`` SMs: as many CTAs an SM as the grid needs to run in one wave,
  MAX_WARPS sweeping warps an SM shared among them, and as many slots as
  that many CTAs leave room for (a multiple of the warps, so that each
  slot is one warp's, and at least warps + 2: two fills in flight while
  each warp sweeps a slot). At (8192, 2048) on 132 SMs: block 256 (512
  CTAs, 4 an SM) 2 warps, 4 slots; block 512 4, 8; block 1024 8, 16."""
  per_sm = max(1, -(-n_ctas // sms))
  warps = max(1, MAX_WARPS // per_sm)
  room = tile_plan.ctas_budget(per_sm) - BAR_BYTES
  least = -(-(warps + 2) // warps) * warps
  return warps, max(least, min(MAX_DEPTH, room // SLOT_BYTES) // warps *
                    warps)


def _walk_old(x: torch.Tensor, block: int) -> torch.Tensor:
  """The old kernel's walk: each CTA (a band of BAND columns, a run of
  ``block`` rows) its tiles in order, the next tile's slab filled into
  the other buffer slot before this one's is read, each slab TILE + 4
  rows from its clipped start by BAND + 4 columns (the halo columns
  wrapping at the row's ends), two sweeps on it, and the tile's rows of
  [2, h-2) stored."""
  h, w = _check(x, block)
  v = _flat(x)
  out = torch.zeros_like(v)
  rows = TILE + 2 * HALO
  tiles = block // TILE
  for run0 in range(0, h, block):
    for c0 in range(0, w, BAND):
      cols = torch.arange(c0 - HALO, c0 + BAND + HALO, device=x.device) % w
      slots: List[Optional[Tuple[torch.Tensor, int]]] = [None, None]

      def fill(t, cols=cols):
        start = slab_start(run0 + t * TILE, h)
        slots[t % 2] = (v[start:start + rows].index_select(1, cols), start)

      fill(0)
      for t in range(tiles):
        t0 = run0 + t * TILE
        if t + 1 < tiles:
          fill(t + 1)
        slab, start = slots[t % 2]
        s2 = _slab_sweep(_slab_sweep(slab))  # slab rows [2, rows-2)
        lo, hi = max(t0, HALO), min(t0 + TILE, h - HALO)
        if lo < hi:
          out[lo:hi, c0:c0 + BAND] = s2[lo - start - HALO:hi - start - HALO]
  return out.reshape(x.shape)


def jacobi25d_walk(x: torch.Tensor, block: int, _old: bool = False,
                   sms: int = tile_plan.SMS,
                   schedule: Optional[List[Tuple[int, ...]]] = None
                   ) -> torch.Tensor:
  """The probe's function walked as a kernel walks it (``_old``: the old
  kernel's walk). The bulk kernel's: each CTA (a band of BAND columns, a
  run of ``block`` rows) with ``ring``'s warps and depth for ``sms`` SMs
  fills slots 0 .. depth-1 with its first tiles' slabs, BULK_TILE + 4
  rows from the clipped start by the columns [c0 - 4, c0 + BAND + 4)
  (wrapping at the row's ends); warp t % warps sweeps tile t from slot
  t % depth, twice over the slab's columns [c0 - 2, c0 + BAND + 2), and
  stores the tile's rows of [2, h-2); only then is the slot refilled,
  with tile t + depth. ``schedule``, a list, receives (run0, c0, tile,
  warp, slot) a tile as the walk sweeps it: the ring of a card of
  ``sms`` SMs (the launch takes the card's own count; an H100 SXM has
  tile_plan.SMS)."""
  if _old:
    return _walk_old(x, block)
  h, w = _check(x, block)
  v = _flat(x)
  out = torch.zeros_like(v)
  rows = BULK_TILE + 2 * HALO
  tiles = block // BULK_TILE
  warps, depth = ring(ctas((h, w), block), sms)
  for run0 in range(0, h, block):
    for c0 in range(0, w, BAND):
      cols = torch.arange(c0 - 4, c0 + BAND + 4, device=x.device) % w
      slots: List[Optional[Tuple[int, torch.Tensor]]] = [None] * depth

      def fill(t, cols=cols, slots=slots):
        start = slab_start(run0 + t * BULK_TILE, h, BULK_TILE)
        slots[t % depth] = (start, v[start:start + rows].index_select(1, cols))

      for t in range(min(depth, tiles)):
        fill(t)
      for t in range(tiles):
        start, slab = slots[t % depth]
        if schedule is not None:
          schedule.append((run0, c0, t, t % warps, t % depth))
        s2 = _slab_sweep(_slab_sweep(slab[:, 2:-2]))  # slab rows [2, rows-2)
        t0 = run0 + t * BULK_TILE
        lo, hi = max(t0, HALO), min(t0 + BULK_TILE, h - HALO)
        out[lo:hi, c0:c0 + BAND] = s2[lo - start - HALO:hi - start - HALO]
        if t + depth < tiles:  # the warp has signalled the slot empty
          fill(t + depth)
  return out.reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _lib() -> Dict[str, object]:
  from soda_tpu_torch.backend import build
  lib = build.load_library(build.csrc_source(SOURCE))
  c = ctypes
  out = {
      'launch': build.bind(lib, 'probe_25d_launch',
                           [c.c_void_p, c.c_void_p, c.c_int, c.c_int,
                            c.c_int, c.c_void_p, c.POINTER(c.c_int)]),
      'error': build.bind(lib, 'probe_25d_error_string', [c.c_int],
                          c.c_char_p),
  }
  out['bulk'] = build.bind(lib, 'probe_25d_bulk_launch',
                          [c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int,
                           c.c_int, c.c_int, c.c_void_p, c.POINTER(c.c_int)])
  out['resident'] = build.bind(lib, 'probe_25d_resident',
                               [c.c_int, c.c_int, c.c_int, c.POINTER(c.c_int)])
  got = [c.c_int(0) for _ in range(7)]
  build.bind(lib, 'probe_25d_geometry', [c.POINTER(c.c_int)] * 2)(
      *map(c.byref, got[:2]))
  build.bind(lib, 'probe_25d_bulk_geometry', [c.POINTER(c.c_int)] * 5)(
      *map(c.byref, got[2:]))
  want = (BAND, TILE, BULK_TILE, SLOT_BYTES, BAR_BYTES, MAX_WARPS, MAX_DEPTH)
  if tuple(g.value for g in got) != want:
    raise RuntimeError('probe_25d.cu is built with band, tiles, slot, '
                       'barriers, warps and depth %s; this module walks %s'
                       % (tuple(g.value for g in got), want))
  return out


def launch_key(block: int, old: bool = False) -> Tuple[str, str]:
  """probes.LAUNCHES' key of a kernel at ``block``: the default kernel
  KERNEL's, the old one OLD_KERNEL's."""
  return OLD_KERNEL if old else KERNEL, 'block %d' % block


def _raise(what: str, status: int) -> None:
  if status:
    raise RuntimeError('2.5-D jacobi %s failed: %s' % (
        what, _lib()['error'](status).decode()))


def resident(device, kind: str = 'new', warps: int = 1,
             depth: int = 3) -> int:
  """CTAs an SM holds of a kernel (``KINDS``), the bulk kernel's with
  ``warps`` and ``depth`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``;
  raises if CUDA refuses)."""
  per_sm = ctypes.c_int(0)
  with torch.cuda.device(device):
    _raise('occupancy query', _lib()['resident'](
        KINDS[kind], warps, depth, ctypes.byref(per_sm)))
  return per_sm.value


def sms(device) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


def launch_config(shape, block: int, device, kind: str = 'new'
                  ) -> Dict[str, int]:
  """A kernel's grid on the card: CTAs, warps and ring depth (the old
  kernel: 8 warps, 2 slabs), threads, CTAs an SM."""
  n = ctas(shape, block)
  if kind == 'old':
    warps, depth, threads = 8, 2, 256
  else:
    warps, depth = ring(n, sms(device))
    threads = (warps + 1) * 32
  return {'ctas': n, 'warps': warps, 'depth': depth, 'threads': threads,
          'per_sm': resident(device, kind, warps, depth)}


def jacobi25d(x: torch.Tensor, block: int,
              ctas: Optional[List[int]] = None,
              _old: bool = False) -> torch.Tensor:
  """Two jacobi sweeps of the grid ``x`` ((h, W) or (h, W/128, 128)
  float32), CTAs of ``block`` rows: the bulk kernel (``_old``: the old
  kernel) for a CUDA tensor, its walked plain version for a CPU tensor.
  Rows 0, 1, h-2 and h-1 of a kernel's output are not written. ``ctas``,
  a list, receives the kernel's grid size."""
  h, w = _check(x, block)
  if x.device.type == 'cpu':
    return jacobi25d_walk(x, block, _old)
  if x.device.type != 'cuda':
    raise utils.InputError('2.5-D jacobi: a cpu or cuda tensor, got %s' %
                           x.device)
  if x.data_ptr() % 16:
    raise utils.InputError('2.5-D jacobi: the kernels copy 16 bytes at a '
                           'time; x must start on a 16-byte boundary')
  lib = _lib()
  y = torch.empty_like(x)
  grid = ctypes.c_int(0)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream().cuda_stream
    if _old:
      status = lib['launch'](x.data_ptr(), y.data_ptr(), h, w, block,
                             stream, ctypes.byref(grid))
    else:
      warps, depth = ring((w // BAND) * (h // block), sms(x.device))
      status = lib['bulk'](x.data_ptr(), y.data_ptr(), h, w, block, warps,
                           depth, stream, ctypes.byref(grid))
  _raise('kernel %s (block %d) launch' % ('old' if _old else 'new', block),
         status)
  probes.LAUNCHES[launch_key(block, _old)] += 1
  if ctas is not None:
    ctas.append(grid.value)
  return y


def entry_of(by_entry: Dict[str, object], kind: str = 'new'
             ) -> object:
  """A kernel's (``KINDS``) value in a mapping keyed by the source's
  mangled entry names (``build.ptxas_report``, a SASS listing): the
  name's length, the name, 'E'."""
  name = ENTRIES[kind]
  tag = '%d%sE' % (len(name), name)
  found = [v for k, v in by_entry.items() if tag in k]
  if len(found) != 1:
    raise RuntimeError('%s: %d entries named %s in %s' % (
        SOURCE, len(found), name, sorted(by_entry)))
  return found[0]


def kernel_stats(kind: str = 'new') -> Dict[str, int]:
  """Registers and spilled bytes of a kernel's entry as built."""
  from soda_tpu_torch.backend import build
  entry = entry_of(build.ptxas_report(build.csrc_source(SOURCE)), kind)
  return {'registers': entry['registers'],
          'spills': entry['spill_stores'] + entry['spill_loads']}


def stored(x: torch.Tensor) -> torch.Tensor:
  """The rows the probe writes, [2, h-2), of a grid."""
  return _flat(x)[HALO:-HALO]


def sweep1_per_output(old: bool = False) -> float:
  """Sweep-1 values a kernel computes an output: a tile's slab rows but
  the first and last, over the tile's outputs, by the band and its two
  edge columns (old: 34 x 130 / (32 x 128)), or the 6 columns a lane
  computes for its 4 (new: 18 x 6 / (16 x 4))."""
  if old:
    return (TILE + 2) * (BAND + 2) / (TILE * BAND)
  return (BULK_TILE + 2) * 6 / (BULK_TILE * 4)


def shared_accesses_per_output(old: bool = False) -> float:
  """Shared-memory load and store instructions the threads issue an
  output, as the source has them: the old kernel 5 scalar loads and a
  store a sweep-1 value and 5 loads an output (11.5); the bulk kernel a
  16-byte and two 8-byte loads a slab row, for 4 outputs a lane and row
  of the tile, and no store (0.94)."""
  if old:
    return 6 * sweep1_per_output(True) + 5
  return 3 * (BULK_TILE + 2 * HALO) / (4 * BULK_TILE)


def bound_ms(shape) -> float:
  """Least milliseconds of one call: the grid read once and written once
  (float32) at the spec memory rate (the sweeps' 9 flops a cell are far
  below it): ``profiling.bound_ms`` of jacobi2d at (h, W)."""
  return 2 * 4 * float(np.prod(shape)) / profiling.H100_BYTES_PER_S * 1e3
