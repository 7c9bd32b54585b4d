"""exp9's 2.5-D jacobi probe: its kernel, its plain versions and bound.

One hand-written CUDA source, ``csrc/probe_25d.cu`` (``jacobi25d``),
replaces the Pallas probe of experiments/exp9_layout25d.py:108
(``build_25d``): two fused jacobi2d sweeps, ``(c + n + s + e + w) *
0.2f``, over the grid the script sees as (h, W/128, 128), east and west
wrapping at the ends of a row of W (its chunk-boundary fix-up, :40-58).
Rows [2, h-2) are stored, every column; rows 0, 1, h-2 and h-1 are not
written, as on the TPU. On the card a CTA owns a band of BAND columns
and a run of ``block`` rows (the script's block) and walks it TILE rows
at a time through two shared-memory slab buffers (see the source).

``jacobi25d_plain`` is the whole-grid function; ``jacobi25d_walk``
follows the kernel: its CTAs' row runs, their tiles, each tile's clipped
slab start and buffer slot, the wrapped halo columns and the rows each
tile stores. Both leave rows 0, 1, h-2 and h-1 zero. ``jacobi25d``
launches the kernel for a CUDA tensor (raising if CUDA refuses) and runs
the walk only for a CPU tensor; each launch adds one to
``probes.LAUNCHES[('probe_25d', 'block <block>')]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from soda_tpu_torch import profiling, utils
from soda_tpu_torch.experiments import probes

SOURCE = 'probe_25d.cu'
KERNEL = 'probe_25d'  # probes.LAUNCHES' key: (KERNEL, 'block <block>')
SCRIPT = 'exp9_layout25d'
LINE = 108
LANES = 128  # the script's chunk
BAND = 128  # columns a CTA owns (the source's kBand)
TILE = 32  # rows a tile (kTile)
HALO = 2  # two sweeps, a row or column each
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


def slab_start(t0: int, h: int) -> int:
  """The first row of the slab of the tile at row t0: HALO rows before it,
  clipped to [0, h - TILE - 2 * HALO] (exp9_layout25d.py:64-69)."""
  return min(max(t0 - HALO, 0), h - TILE - 2 * HALO)


def jacobi25d_walk(x: torch.Tensor, block: int) -> torch.Tensor:
  """The probe's function walked as the kernel walks it: each CTA (a band
  of BAND columns, a run of ``block`` rows) its tiles in order, the next
  tile's slab filled into the other buffer slot before this one's is
  read, each slab TILE + 4 rows from its clipped start by BAND + 4
  columns (the halo columns wrapping at the row's ends), two sweeps on
  it, and the tile's rows of [2, h-2) stored."""
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
  band, tile = c.c_int(0), c.c_int(0)
  build.bind(lib, 'probe_25d_geometry', [c.POINTER(c.c_int)] * 2)(
      c.byref(band), c.byref(tile))
  if (band.value, tile.value) != (BAND, TILE):
    raise RuntimeError('probe_25d.cu is built with band %d, tile %d; this '
                       'module walks %d, %d' % (band.value, tile.value, BAND,
                                                TILE))
  return out


def jacobi25d(x: torch.Tensor, block: int,
              ctas: Optional[List[int]] = None) -> torch.Tensor:
  """Two jacobi sweeps of the grid ``x`` ((h, W) or (h, W/128, 128)
  float32), CTAs of ``block`` rows: the 2.5-D kernel for a CUDA tensor,
  its walked plain version for a CPU tensor. Rows 0, 1, h-2 and h-1 of a
  kernel's output are not written. ``ctas``, a list, receives the
  kernel's grid size."""
  h, w = _check(x, block)
  if x.device.type == 'cpu':
    return jacobi25d_walk(x, block)
  if x.device.type != 'cuda':
    raise utils.InputError('2.5-D jacobi: a cpu or cuda tensor, got %s' %
                           x.device)
  lib = _lib()
  y = torch.empty_like(x)
  grid = ctypes.c_int(0)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = lib['launch'](x.data_ptr(), y.data_ptr(), h, w, block, stream,
                           ctypes.byref(grid))
  if status:
    raise RuntimeError('2.5-D jacobi kernel (block %d) failed to launch: %s'
                       % (block, lib['error'](status).decode()))
  probes.LAUNCHES[(KERNEL, 'block %d' % block)] += 1
  if ctas is not None:
    ctas.append(grid.value)
  return y


def stored(x: torch.Tensor) -> torch.Tensor:
  """The rows the probe writes, [2, h-2), of a grid."""
  return _flat(x)[HALO:-HALO]


def bound_ms(shape) -> float:
  """Least milliseconds of one call: the grid read once and written once
  (float32) at the spec memory rate (the sweeps' 9 flops a cell are far
  below it): ``profiling.bound_ms`` of jacobi2d at (h, W)."""
  return 2 * 4 * float(np.prod(shape)) / profiling.H100_BYTES_PER_S * 1e3
