"""The experiment probes' kernels, their plain versions and bounds.

Two hand-written CUDA sources replace four Pallas probes of the JAX
package's ``experiments/``:

- ``csrc/probe_stream.cu`` (``stream_probe``): y = x + 1 streamed through
  shared memory a tile at a time, for exp27_gridloop.py:122 (one kernel
  entry per grid step against one entry with a loop, single and double
  buffered) and exp30_dma_granularity.py:110 (per-step bytes, copies per
  fill, ring depth). The default kernel fills and stores each tile by
  the bulk-copy engine (``cp.async.bulk``, one thread a CTA, an
  ``mbarrier`` a slot); the old one, per-thread ``cp.async`` fills and
  register stores, stays behind ``_old=True`` for comparisons.
- ``csrc/probe_chain.cu`` (``chain_probe``): a body applied n times to a
  (256, 1024) block, for exp24_stage_tax.py:75 and
  exp45_transcendental_tax.py:71 (``pallas_loop``). The chunked bodies
  run ``chain_chunk_cluster``: the block one thread-block cluster of 16
  bands of half a chunk's rows, each column's rows in a thread's
  registers, the margin rows read from the next bands' shared memory;
  the first ``chain_chunk`` (a grid barrier an iteration) stays behind
  ``_old=True``. exp24's chains of shifted
  mins run in the narrow probe's kernels (``csrc/probe_narrow.cu``, see
  narrow.py): the strip kernel, a grid barrier a phase past the first;
  indep10 ``strip_cluster``, the strip kernel behind ``_old=True``.

Each wrapper launches its kernel for a CUDA tensor (raising if CUDA
refuses the launch) and runs its plain version only for a CPU tensor;
``LAUNCHES`` counts the launches, keyed by kernel and configuration.
``stream_probe_plain`` walks the kernel's own schedule (tiles per CTA,
ring slot per step, the split boundaries of each fill);
``chain_probe_plain`` applies the body in torch, as the JAX scripts'
bodies write it (``torch.roll`` for their wrap-around shifts, chunked
bodies chunk by chunk). The case lists and bodies are this package's
own copies of the JAX scripts'.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
import statistics
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from soda_tpu_torch import profiling, utils

# the hand-written sources in csrc/ (backend/build.csrc_source): the
# streaming and chain probes here, the copy-shift probe (copyshift.py),
# the 2.5-D jacobi (layout25d.py), the narrow probe (narrow.py)
SOURCES = ('probe_stream.cu', 'probe_chain.cu', 'probe_copy.cu',
           'probe_25d.cu', 'probe_narrow.cu')
# kernel launches, keyed by (kernel, configuration)
LAUNCHES: collections.Counter = collections.Counter()

# -- the streaming probe -----------------------------------------------------

ROW_FLOATS = 256  # a row: 1 KiB
BLK_ROWS = 4  # rows per unit of `blk`: a tile is blk x 4 KiB
THREADS = 256
GRID_DB_RUN = 8  # tiles a CTA walks in the double-buffered grid form
KINDS = {'grid': 0, 'loop': 1}
# shared memory a CTA may use on sm_90 (227 KiB)
MAX_CTA_SMEM = 232448
# the bulk kernel's mbarriers, before its ring (the source's kBarBytes)
STREAM_BAR_BYTES = 128
# the loop form's CTAs in a plain walk on the CPU, where no card says how
# many fit: few, so that each CTA walks several tiles, ragged runs too
CPU_CTAS = 7


@dataclasses.dataclass(frozen=True)
class StreamCase:
  """One case of exp27 or exp30: its name there and the kernel's
  template arguments."""
  name: str
  kind: str  # 'grid' or 'loop'
  blk: int  # tile rows / 4
  split: int = 1  # copies per fill
  depth: int = 2  # ring slots

  @property
  def args(self) -> Tuple[str, int, int, int]:
    return self.kind, self.blk, self.split, self.depth

  @property
  def key(self) -> Tuple[str, str]:
    """LAUNCHES' key of the default kernel (``old_key``: the old one)."""
    return _stream_key(*self.args)

  @property
  def old_key(self) -> Tuple[str, str]:
    return _stream_key(*self.args, old=True)


def _stream_key(kind: str, blk: int, split: int, depth: int,
                old: bool = False) -> Tuple[str, str]:
  """LAUNCHES' key of the streaming kernel with these arguments: the
  default kernel 'probe_stream', the old one 'probe_stream[old]'."""
  return ('probe_stream[old]' if old else 'probe_stream',
          '%s blk%d split%d depth%d' % (kind, blk, split, depth))


# experiments/exp27_gridloop.py:142-147 (BLK = 4)
EXP27_CASES = (
    StreamCase('grid sync', 'grid', 4, depth=1),
    StreamCase('loop sync', 'loop', 4, depth=1),
    StreamCase('grid db', 'grid', 4, depth=2),
    StreamCase('loop db', 'loop', 4, depth=2),
)
# experiments/exp30_dma_granularity.py:297-307 (the loop-db form)
EXP30_CASES = (
    StreamCase('blk2', 'loop', 2),
    StreamCase('blk4 (exp27 ref)', 'loop', 4),
    StreamCase('blk8', 'loop', 8),
    StreamCase('blk16', 'loop', 16),
    StreamCase('blk4 split2', 'loop', 4, split=2),
    StreamCase('blk4 split4', 'loop', 4, split=4),
    StreamCase('blk4 depth3', 'loop', 4, depth=3),
    StreamCase('blk2 depth3', 'loop', 2, depth=3),
    StreamCase('blk2 depth4', 'loop', 2, depth=4),
)


def stream_input(n: int, device) -> torch.Tensor:
  """The JAX scripts' input: ``default_rng(0).standard_normal((n, n,
  n), float32)``."""
  import numpy as np
  x = np.random.default_rng(0).standard_normal((n, n, n), dtype=np.float32)
  return torch.from_numpy(x).to(device)


def _tile_floats(blk: int) -> int:
  return blk * BLK_ROWS * ROW_FLOATS


def _check_stream(x: torch.Tensor, kind: str, blk: int, split: int,
                  depth: int) -> int:
  """Raise utils.InputError unless the kernels take these arguments;
  returns the number of tiles."""
  if kind not in KINDS or depth not in (1, 2, 3, 4) or split not in (1, 2, 4):
    raise utils.InputError('stream probe: kind grid|loop, depth 1-4, split '
                           '1|2|4; got %r, %r, %r' % (kind, depth, split))
  if blk < 1 or blk % split:
    raise utils.InputError('stream probe: blk %d is not a multiple of split '
                           '%d' % (blk, split))
  if STREAM_BAR_BYTES + depth * _tile_floats(blk) * 4 > MAX_CTA_SMEM:
    raise utils.InputError('stream probe: %d slots of %d KiB exceed a '
                           'CTA\'s shared memory' % (depth, 4 * blk))
  if x.dtype != torch.float32 or not x.is_contiguous() or \
      x.numel() % _tile_floats(blk):
    raise utils.InputError('stream probe: a contiguous float32 tensor of '
                           'whole %d-float tiles, got %s %s' % (
                               _tile_floats(blk), x.dtype, tuple(x.shape)))
  return x.numel() // _tile_floats(blk)


@functools.lru_cache(maxsize=None)
def _stream_lib(old: bool) -> Dict[str, Callable]:
  """The C entries of the old kernel (``old``) or of the bulk kernel."""
  from soda_tpu_torch.backend import build
  lib = build.load_library(build.csrc_source(SOURCES[0]))
  c = ctypes
  prefix = 'probe_stream' if old else 'probe_stream_bulk'
  return {
      'ctas': build.bind(lib, prefix + '_ctas',
                         [c.c_int] * 4 + [c.POINTER(c.c_int)]),
      'launch': build.bind(lib, prefix + '_launch',
                           [c.c_int] * 3 +
                           [c.c_void_p, c.c_void_p, c.c_longlong] +
                           [c.c_int] * 3 + [c.c_void_p]),
      'error': build.bind(lib, 'probe_stream_error_string', [c.c_int],
                          c.c_char_p),
  }


def _stream_run(depth: int) -> int:
  """Tiles a CTA of the grid form walks (the loop form: all it can)."""
  return 1 if depth == 1 else GRID_DB_RUN


@functools.lru_cache(maxsize=None)
def _card_ctas(old: bool, kind: str, blk: int, split: int, depth: int,
               index: int) -> int:
  """CTAs of the kernel that fit on card ``index`` at once: its SMs x
  the CTAs an SM holds, by the card's occupancy calculator."""
  lib = _stream_lib(old)
  out = ctypes.c_int(0)
  with torch.cuda.device(index):
    status = lib['ctas'](KINDS[kind], depth, split, _tile_floats(blk) // 4,
                         ctypes.byref(out))
  if status:
    raise RuntimeError('stream probe: occupancy query failed: %s' %
                       lib['error'](status).decode())
  return out.value


def stream_resident(kind: str, blk: int, split: int, depth: int, device,
                    old: bool = False) -> int:
  """CTAs of the bulk kernel (``old``: the old one) that the card holds
  at once."""
  index = torch.device(device).index
  return _card_ctas(old, kind, blk, split, depth,
                    torch.cuda.current_device() if index is None else index)


def stream_ctas(kind: str, blk: int, split: int, depth: int, tiles: int,
                device, old: bool = False) -> int:
  """CTAs the kernel runs on: the grid form one per run of tiles; the
  loop form every CTA that fits on the card at once
  (``stream_resident``; on the CPU: CPU_CTAS)."""
  if kind == 'grid':
    return -(-tiles // _stream_run(depth))
  if torch.device(device).type == 'cpu':
    return CPU_CTAS
  return stream_resident(kind, blk, split, depth, device, old)


def stream_schedule(kind: str, depth: int, tiles: int, ctas: int
                    ) -> Iterator[List[int]]:
  """Each CTA's tiles, in the order it walks them."""
  if kind == 'loop':
    for b in range(ctas):
      yield list(range(b, tiles, ctas))
  else:
    run = _stream_run(depth)
    for b in range(ctas):
      yield list(range(b * run, min(b * run + run, tiles)))


def stream_probe(x: torch.Tensor, kind: str, blk: int, split: int = 1,
                 depth: int = 2, *, _old: bool = False) -> torch.Tensor:
  """``x + 1`` through the streaming probe kernel (a CUDA tensor) or its
  plain version (a CPU tensor): ``blk`` x 4 KiB tiles, ``kind`` 'grid'
  (no state carried between CTAs; depth 1: a tile per CTA, else a run
  of GRID_DB_RUN tiles) or 'loop' (a persistent grid), a ring of
  ``depth`` slots, each fill ``split`` copies. The kernel is the bulk
  kernel; ``_old`` (private: tests, chip_smoke.py and stream_replay)
  launches the old one."""
  tiles = _check_stream(x, kind, blk, split, depth)
  if x.device.type == 'cpu':
    return stream_probe_plain(x, kind, blk, split, depth)
  if x.device.type != 'cuda':
    raise utils.InputError('stream probe: a cpu or cuda tensor, got %s' %
                           x.device)
  if x.data_ptr() % 16:
    raise utils.InputError('stream probe: the kernels copy 16 bytes at a '
                           'time; x must start on a 16-byte boundary')
  lib = _stream_lib(_old)
  ctas = stream_ctas(kind, blk, split, depth, tiles, x.device, _old)
  y = torch.empty_like(x)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = lib['launch'](KINDS[kind], depth, split, x.data_ptr(),
                           y.data_ptr(), tiles, _tile_floats(blk) // 4,
                           _stream_run(depth), ctas, stream)
  if status:
    raise RuntimeError('stream probe kernel failed to launch: %s' %
                       lib['error'](status).decode())
  LAUNCHES[_stream_key(kind, blk, split, depth, _old)] += 1
  return y


def stream_probe_plain(x: torch.Tensor, kind: str, blk: int, split: int = 1,
                       depth: int = 2, ctas: Optional[int] = None
                       ) -> torch.Tensor:
  """The streaming probe's function in plain PyTorch, walked as both
  kernels walk it: per CTA (``ctas``; default: as ``stream_ctas``), its
  tiles in order; ``depth - 1`` fills ahead, each copied into its ring
  slot in ``split`` contiguous parts; each step's tile read back from
  its slot, plus 1, stored."""
  tiles = _check_stream(x, kind, blk, split, depth)
  if ctas is None:
    ctas = stream_ctas(kind, blk, split, depth, tiles, x.device)
  size = _tile_floats(blk)
  src = x.reshape(tiles, size)
  out = torch.empty_like(src)
  part = size // split
  slots: List[Optional[torch.Tensor]] = [None] * depth
  for walk in stream_schedule(kind, depth, tiles, ctas):

    def fill(s):
      slot = torch.empty(size, dtype=x.dtype, device=x.device)
      for p in range(split):
        slot[p * part:(p + 1) * part] = src[walk[s], p * part:(p + 1) * part]
      slots[s % depth] = slot

    for s in range(min(depth - 1, len(walk))):
      fill(s)
    for s, tile in enumerate(walk):
      if s + depth - 1 < len(walk):
        fill(s + depth - 1)
      out[tile] = slots[s % depth] + 1
  return out.reshape(x.shape)


def stream_bound_ms(x: torch.Tensor) -> float:
  """Least milliseconds for x + 1: x read once, y written once, at the
  spec memory rate (the add is free beside them)."""
  return 2 * x.numel() * x.element_size() / profiling.H100_BYTES_PER_S * 1e3


# -- the chain probe ---------------------------------------------------------

SHAPE = (256, 1024)  # exp24_stage_tax.py:35, exp45_transcendental_tax.py:36
CELLS = SHAPE[0] * SHAPE[1]
DISTS0 = (1, 2, 4, 8, 3)  # exp24_stage_tax.py:38-40
DISTS1 = (1, 2, 4, 8, 3)
MARGIN0 = sum(DISTS0)
# the chain probe's forms (a shift chain runs in the narrow probe's strip
# kernel)
FORMS = {'elementwise': 0, 'chunk': 1, 'stencil': 2}
# a float body against its plain version: the largest relative error
# (both round every operation alone; rsqrtf and torch's rsqrt may
# differ by 2 ulp)
CHAIN_RTOL = 1e-5
# iterations at which a kernel is held against its plain version: one
# and two (both ping-pong parities) and five, before the chains settle
# on a fixed point or a global minimum (at 64 most have, whatever the
# kernel did)
CHECK_ITERS = (1, 2, 5)
# issue lanes per SM and clock (Hopper architecture white paper)
UNIT_LANES = {'fp32': 128, 'int32': 64, 'sfu': 16}
# probe_chain_launch's form of the old chunk kernel (the first chain_chunk,
# kept for comparisons; the public path never passes it)
OLD_CHUNK_FORM = 3


class Barriers(collections.namedtuple('Barriers', 'grid cluster')):
  """Barriers per iteration a kernel takes: grid barriers (a cooperative
  launch's ``grid.sync``) and cluster barriers (``barrier.cluster``
  arrive and wait pairs)."""


def _roll(v: torch.Tensor, axis: int, d: int) -> torch.Tensor:
  """v[(i + d) % S] along ``axis``: the scripts' concatenate of
  ``v[d:], v[:d]`` and ``pltpu.roll(v, -d % S)`` alike."""
  return torch.roll(v, -d, dims=axis)


def _sqrt(v: torch.Tensor) -> torch.Tensor:
  """IEEE float32 square root (through float64, which rounds it
  exactly; torch's vectorised CPU float32 sqrt is off by an ulp at
  times)."""
  return torch.sqrt(v.to(torch.float64)).to(v.dtype)


def _rdiv(a: float, v: torch.Tensor) -> torch.Tensor:
  """a / v as one IEEE division (torch's ``a / v`` is a reciprocal
  times a)."""
  return torch.div(v.new_full((), a), v)


@dataclasses.dataclass(frozen=True)
class ChainBody:
  """One body of exp24 or exp45: its name there, its steps per
  iteration (the scripts' ``steps``), its plain version, its operations
  per cell and iteration by unit (``ops``: int32, fp32, special
  function), and the kernel's form: 'elementwise', 'shift' (``taps``:
  (axis, distance, last tap of a phase)), 'chunk' (``chunk``: rows,
  lanes) or 'stencil' (``phases``).

  ``ops`` counts the body as written: an add, subtract, multiply, min,
  xor or shift one op; ``a + (b >> k)`` one (Hopper's shift-add,
  LEA.HI); a divide a reciprocal (special function) and a multiply; a
  square root or reciprocal square root one special-function op; a
  chunked body's recomputed margins too. Shifts of the block move data
  and are not counted."""
  name: str
  experiment: str
  dtype: torch.dtype
  steps: int
  step: Callable[[torch.Tensor], torch.Tensor]
  ops: Tuple[float, float, float]
  form: str
  taps: Tuple[Tuple[int, int, bool], ...] = ()
  chunk: Optional[Tuple[int, int]] = None
  phases: int = 0
  note: str = ''

  @property
  def barriers(self) -> Barriers:
    """Grid and cluster barriers per iteration on the card: a shift
    chain's its narrow body's (``narrow.NarrowBody.barriers``: a grid
    barrier a phase of several on the strip kernel, one cluster barrier
    on ``strip_cluster``); a chunked body's one cluster barrier (the
    margin rows' exchange, its two buffers alternating); a stencil's a
    grid barrier a phase."""
    if self.form == 'shift':
      from soda_tpu_torch.experiments import narrow
      return narrow.EXP24_SHIFT[self.name].barriers
    return {'elementwise': Barriers(0, 0), 'chunk': Barriers(0, 1)}.get(
        self.form, Barriers(self.phases, 0))

  @property
  def old_barriers(self) -> Barriers:
    """The barriers of the old kernels: the strip kernel's (a shift
    chain; ``chain_probe(..., _old=True)`` runs it for indep10), the old
    chunk kernel's grid barrier an iteration (a chunked body)."""
    if self.form == 'shift':
      from soda_tpu_torch.experiments import narrow
      return narrow.EXP24_SHIFT[self.name].old_barriers
    if self.form != 'chunk':
      raise utils.InputError('chain probe %s: no old form of a %s body' % (
          self.name, self.form))
    return Barriers(1, 0)


def _chained(axis_dists) -> Tuple[Tuple[int, int, bool], ...]:
  return tuple((a, d, True) for a, d in axis_dists)


def _shift_step(taps, combine=torch.minimum, shift=_roll):
  """One iteration of a chain of wrap-around shifts, the plain version of
  every shift chain the probes run (exp24's here; the narrow probe's
  strips): each tap (axis, distance, last of a phase) combines the
  accumulator with the phase's values shifted by ``shift(v, axis, d)``;
  a phase's last tap makes the accumulator the next phase's values."""
  def step(v):
    acc = v
    for axis, d, last in taps:
      acc = combine(acc, shift(v, axis, d))
      if last:
        v = acc
    return v
  return step


def _ew10_step(v):  # exp24 body_ew10_real
  for k in range(5):
    v = torch.minimum(v, v ^ (0x5A5A + k))
    v = (v.to(torch.int64) + (v >> 3)).to(torch.int32)  # int32 wraps
  return v


def _chunk_step(k_rows: int, lane_tile: Optional[int]):
  """exp24's make_body_chunk: the ten steps per chunk of rows (and lane
  tile), the row steps on shrinking slices of the chunk plus its
  wrapped margin, the lane steps rolling inside the tile."""
  def on_chunk(w):
    for d in DISTS0:
      w = torch.minimum(w[:-d], w[d:])
    for d in DISTS1:
      w = torch.minimum(w, torch.cat([w[:, d:], w[:, :d]], dim=1))
    return w

  def step(v):
    rows, cols = v.shape
    chunks = []
    for r0 in range(0, rows, k_rows):
      hi = r0 + k_rows + MARGIN0
      w = v[r0:hi] if hi <= rows else torch.cat([v[r0:], v[:hi - rows]])
      if lane_tile is None:
        chunks.append(on_chunk(w))
      else:
        chunks.append(torch.cat([on_chunk(w[:, c0:c0 + lane_tile])
                                 for c0 in range(0, cols, lane_tile)], dim=1))
    return torch.cat(chunks)
  return step


def _times(n: int, f):
  def step(v):
    for _ in range(n):
      v = f(v)
    return v
  return step


def _rolls(v):
  return _roll(v, 0, 1), _roll(v, 0, -1), _roll(v, 1, 1), _roll(v, 1, -1)


def _sum_sq(base, *ds):
  s = base + ds[0] * ds[0]
  for d in ds[1:]:
    s = s + d * d
  return s


def _gstage(g_fn):
  def step(v):
    up, dn, lf, rt = _rolls(v)
    return g_fn(_sum_sq(1.0, v - up, v - dn, v - lf, v - rt))
  return step


def _g_noroll(v):
  return torch.rsqrt(_sum_sq(1.0, v - v * 0.5, v - v * 0.25, v - v * 0.75,
                             v - v * 0.125))


def _update2d(v, up, dn, lf, rt, gu, gd, gl, gr):
  r0 = v * v * 4.9
  r1 = ((r0 * (2.5 + r0 * (10.2 + r0))) *
        (4.3 + r0 * (5.4 + r0 * (6.3 + r0))))
  num = v + 7.7 * (dn * gd + up * gu + rt * gr + lf * gl + 5.7 * v * r1)
  den = 11.1 + 7.7 * (gd + gu + gl + gr + 5.7)
  return (num * den) * 1e-6 + 0.5


def _full2d(g_fn):
  def step(v):
    up, dn, lf, rt = _rolls(v)
    g = g_fn(_sum_sq(1.0, v - up, v - dn, v - lf, v - rt))
    return _update2d(v, up, dn, lf, rt, *_rolls(g))
  return step


def _full2d_noroll(v):
  def fake_rolls(x):
    return x * 0.5, x * 0.25, x * 0.75, x * 0.125

  up, dn, lf, rt = fake_rolls(v)
  g = torch.rsqrt(_sum_sq(1.0, v - up, v - dn, v - lf, v - rt))
  return _update2d(v, up, dn, lf, rt, *fake_rolls(g))


def _full3d(v):
  up, dn, lf, rt = _rolls(v)
  io, oi = _roll(v, 0, 2), _roll(v, 0, -2)
  g = torch.rsqrt(_sum_sq(0.00005, v - up, v - dn, v - lf, v - rt, v - io,
                          v - oi))
  gu, gd, gl, gr = _rolls(g)
  gi, go = _roll(g, 0, 2), _roll(g, 0, -2)
  r0 = v * v * (1.0 / 0.03)
  r1 = ((r0 * (2.38944 + r0 * (0.950037 + r0))) /
        (4.65314 + r0 * (2.57541 + r0 * (1.48937 + r0))))
  num = v + 5.0 * (dn * gd + up * gu + rt * gr + lf * gl + io * gi +
                   oi * go + (1.0 / 0.03) * v * r1)
  den = 1.0 + 5.0 * (gd + gu + gl + gr + gi + go + (1.0 / 0.03))
  return (num / den) * 1e-6 + 0.5


def _fma(s):
  return s * 0.0625 + 0.125


_I32, _F32 = torch.int32, torch.float32
_ROLL10 = _chained([(0, d) for d in DISTS0] + [(1, d) for d in DISTS1])


def _chunk_ops(k_rows: int) -> Tuple[float, float, float]:
  """A chunked body's int32 ops per cell: the row steps' mins over the
  chunk's shrinking slices (k_rows + MARGIN0 rows less each distance so
  far), over k_rows, then one min a cell per lane step."""
  rows = [k_rows + MARGIN0 - sum(DISTS0[:i + 1]) for i in range(len(DISTS0))]
  return (sum(rows) / k_rows + len(DISTS1), 0, 0)


def _shift_body(name, experiment, taps, steps, note=''):
  return ChainBody(name, experiment, _I32, steps, _shift_step(taps),
                   (len(taps), 0, 0), 'shift', taps=taps, note=note)


def _ew_body(name, f, ops, steps=10, dtype=_F32):
  return ChainBody(name, 'exp24' if dtype == _I32 else 'exp45', dtype, steps,
                   f, ops, 'elementwise')


def _stencil_body(name, f, ops, phases):
  return ChainBody(name, 'exp45', _F32, 1, f, ops, 'stencil', phases=phases)


# experiments/exp24_stage_tax.py:235-243, in order
EXP24_BODIES = (
    _ew_body('ew10', _ew10_step, (15, 0, 0), dtype=_I32),
    _shift_body('roll10', 'exp24', _ROLL10, 10),
    _shift_body('proll10', 'exp24', _ROLL10, 10),
    _shift_body('indep10', 'exp24',
                tuple((a, d, False) for a, d, _ in _ROLL10[:-1]) +
                (_ROLL10[-1],), 10),
    _shift_body('proll5_sub', 'exp24', _chained((0, d) for d in DISTS0), 5),
    _shift_body('proll5_lane', 'exp24', _chained((1, d) for d in DISTS1), 5),
    ChainBody('chunk32', 'exp24', _I32, 10, _chunk_step(32, None),
              _chunk_ops(32), 'chunk', chunk=(32, 1024)),
    ChainBody('chunk128', 'exp24', _I32, 10, _chunk_step(128, None),
              _chunk_ops(128), 'shift', taps=_ROLL10,
              note='barrier form: 146 rows x 4 KiB exceed 227 KB'),
    ChainBody('chunk64x512', 'exp24', _I32, 10, _chunk_step(64, 512),
              _chunk_ops(64), 'chunk', chunk=(64, 512)),
)
# exp24_stage_tax.py:228-233 (--dists): five rolls of one distance
EXP24_DIST_BODIES = tuple(
    _shift_body('%s_d%d' % (tag, d), 'exp24', _chained([(axis, d)] * 5), 5)
    for tag, axis, dists in (('sub', 0, (1, 2, 7, 8, 16, 64)),
                             ('lane', 1, (1, 2, 7, 8, 64, 128, 256, 512)))
    for d in dists)
# experiments/exp45_transcendental_tax.py:266-292, in order
EXP45_BODIES = (
    _ew_body('fma10', _times(10, lambda v: v * 0.875 + 0.25), (0, 20, 0)),
    _ew_body('muladd10', _times(10, lambda v: (v + 0.25) * 0.875),
             (0, 20, 0)),
    _ew_body('div10', _times(10, lambda v: _rdiv(1.75, v + 1.5)),
             (0, 20, 10)),
    _ew_body('recip10', _times(10, lambda v: _rdiv(1.0, v + 1.5)),
             (0, 20, 10)),
    _ew_body('sqrt10', _times(10, lambda v: _sqrt(v + 0.5)), (0, 10, 10)),
    _ew_body('rsqrt10', _times(10, lambda v: torch.rsqrt(v + 0.5)),
             (0, 10, 10)),
    _ew_body('recipsqrt10', _times(10, lambda v: _rdiv(1.0, _sqrt(v + 0.5))),
             (0, 20, 20)),
    _stencil_body('gstage', _gstage(torch.rsqrt), (0, 12, 1), 1),
)
# exp45 --decompose (gstage runs there too)
EXP45_DECOMPOSE_BODIES = (
    _stencil_body('gstage', _gstage(torch.rsqrt), (0, 12, 1), 1),
    _ew_body('g_noroll', _g_noroll, (0, 16, 1), 1),
    _stencil_body('g_norsqrt', _gstage(_fma), (0, 14, 0), 1),
    _stencil_body('full2d', _full2d(torch.rsqrt), (0, 45, 1), 2),
    _stencil_body('full2d_norsqrt', _full2d(_fma), (0, 47, 0), 2),
    _ew_body('full2d_noroll', _full2d_noroll, (0, 53, 1), 1),
    _stencil_body('full3d', _full3d, (0, 57, 3), 2),
)
CHAIN_BODIES: Dict[str, ChainBody] = {
    b.name: b for b in (EXP24_BODIES + EXP24_DIST_BODIES + EXP45_BODIES +
                        EXP45_DECOMPOSE_BODIES)}


def chain_input(dtype: torch.dtype, device) -> torch.Tensor:
  """The JAX scripts' block: ``RandomState(0).randint(-30000, 30000)``
  int32 (exp24) or ``.uniform(0.1, 2.0)`` float32 (exp45)."""
  import numpy as np
  rng = np.random.RandomState(0)
  if dtype == torch.int32:
    x = rng.randint(-30000, 30000, SHAPE, np.int32)
  else:
    x = rng.uniform(0.1, 2.0, SHAPE).astype(np.float32)
  return torch.from_numpy(x).to(device)


@functools.lru_cache(maxsize=None)
def _chain_lib() -> Dict[str, object]:
  from soda_tpu_torch.backend import build
  lib = build.load_library(build.csrc_source(SOURCES[1]))
  c = ctypes
  ops = build.bind(lib, 'probe_chain_ops', [], c.c_char_p)().decode()
  ew, stencil = (part.split(',') for part in ops.split(';'))
  return {
      'ops': {'elementwise': ew, 'stencil': stencil},
      'launch': build.bind(lib, 'probe_chain_launch',
                           [c.c_int] * 4 + [c.c_void_p] * 4 +
                           [c.c_longlong, c.c_void_p, c.POINTER(c.c_int)]),
      'error': build.bind(lib, 'probe_chain_error_string', [c.c_int],
                          c.c_char_p),
  }


def _body(body) -> ChainBody:
  if isinstance(body, ChainBody):
    return body
  if body not in CHAIN_BODIES:
    raise utils.InputError('unknown chain body %r (one of %s)' % (
        body, ', '.join(CHAIN_BODIES)))
  return CHAIN_BODIES[body]


def _check_chain(x: torch.Tensor, body: ChainBody, n: int) -> None:
  if tuple(x.shape) != SHAPE or x.dtype != body.dtype or \
      not x.is_contiguous():
    raise utils.InputError('chain probe %s: a contiguous %s block of %s, got '
                           '%s %s' % (body.name, body.dtype, SHAPE, x.dtype,
                                      tuple(x.shape)))
  if n < 1:
    raise utils.InputError('chain probe: n >= 1, got %d' % n)


def chain_probe(x: torch.Tensor, body, n: int,
                ctas: Optional[List[int]] = None, *,
                _old: bool = False) -> torch.Tensor:
  """``body`` (a ChainBody or its name) applied ``n`` times to the
  (256, 1024) block ``x``: the chain probe kernel (a shift chain: the
  narrow probe's kernel) for a CUDA tensor, its plain version for a CPU
  tensor; a refused launch raises (nothing falls back). ``ctas``, a
  list, receives the kernel's grid size. ``_old`` (a chunked body or a
  shift chain on ``strip_cluster``; private: tests and chip_smoke.py): the
  old kernel, the first ``chain_chunk`` or the strip kernel, counted
  under 'probe_chain[old]'."""
  body = _body(body)
  _check_chain(x, body, n)
  if x.device.type == 'cpu':
    return chain_probe_plain(x, body, n)
  if x.device.type != 'cuda':
    raise utils.InputError('chain probe: a cpu or cuda tensor, got %s' %
                           x.device)
  key = ('probe_chain[old]' if _old else 'probe_chain', body.name)
  if _old and body.form not in ('shift', 'chunk'):
    raise utils.InputError('chain probe %s: no old form of a %s body' % (
        body.name, body.form))
  if body.form == 'shift':
    # the narrow probe's kernels (narrow imports this module)
    from soda_tpu_torch.experiments import narrow
    y = narrow.launch(narrow.EXP24_SHIFT[body.name], (x,), n, ctas,
                      _old=_old)
    LAUNCHES[key] += 1
    return y
  lib = _chain_lib()
  op = (lib['ops'][body.form].index(body.name)
        if body.form in lib['ops'] else 0)
  rows, lanes = body.chunk or (0, 0)
  y = torch.empty_like(x)
  grid = ctypes.c_int(0)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream().cuda_stream
    # (the chunk kernel holds the block on chip: no second buffer)
    tmp, g = ((None, None) if body.form == 'chunk' and not _old else
              (torch.empty_like(x), torch.empty_like(x)))
    status = lib['launch'](OLD_CHUNK_FORM if _old else FORMS[body.form], op,
                           rows, lanes, x.data_ptr(), y.data_ptr(),
                           tmp.data_ptr() if tmp is not None else None,
                           g.data_ptr() if g is not None else None, n,
                           stream, ctypes.byref(grid))
  if status:
    raise RuntimeError('chain probe kernel (%s) failed to launch: %s' % (
        body.name, lib['error'](status).decode()))
  LAUNCHES[key] += 1
  if ctas is not None:
    ctas.append(grid.value)
  return y


def chain_probe_plain(x: torch.Tensor, body, n: int) -> torch.Tensor:
  """The chain probe's function in plain PyTorch: ``body``'s steps, as
  the JAX script writes them, ``n`` times."""
  body = _body(body)
  _check_chain(x, body, n)
  v = x
  for _ in range(n):
    v = body.step(v)
  return v


def op_counts(name: str) -> Dict[str, float]:
  """Operations per cell and iteration of body ``name`` by unit ('int32',
  'fp32', 'sfu'): its ``ops``."""
  return dict(zip(('int32', 'fp32', 'sfu'), _body(name).ops))


def ops_bound_ms(counts: Dict[str, float], cells: int, sms: int,
                 clock_hz: float) -> Tuple[float, str]:
  """(least milliseconds for ``counts`` operations by unit on each of
  ``cells`` cells, on ``sms`` SMs at ``clock_hz``, the unit that bounds
  it): each unit's operations over its issue lanes (UNIT_LANES)."""
  per_unit = {u: counts[u] * cells / (UNIT_LANES[u] * sms * clock_hz) * 1e3
              for u in UNIT_LANES}
  unit = max(per_unit, key=per_unit.get)
  return per_unit[unit], unit


def chain_bound_ms(name: str, sms: int, clock_hz: float) -> Tuple[float, str]:
  """(least milliseconds per iteration of body ``name`` on ``sms`` SMs
  at ``clock_hz``, the unit that bounds it): ``ops_bound_ms``. The
  block's bytes (1 MiB in, 1 MiB out per launch) are not per iteration;
  operations bound every body."""
  return ops_bound_ms(op_counts(name), CELLS, sms, clock_hz)


def chain_check(x: torch.Tensor, body, iters=CHECK_ITERS,
                ctas: Optional[List[int]] = None) -> Tuple[float, float]:
  """(largest absolute, largest relative) difference of ``chain_probe``
  from ``chain_probe_plain`` over ``iters`` iterations each (``ctas``
  as ``chain_probe``'s)."""
  errs = [max_error(chain_probe(x, body, n, ctas),
                    chain_probe_plain(x, body, n)) for n in iters]
  return max(e[0] for e in errs), max(e[1] for e in errs)


def chain_ok(body, abs_err: float, rel_err: float) -> bool:
  """int32 bit for bit; float32 within CHAIN_RTOL relative."""
  body = _body(body)
  if body.dtype.is_floating_point:
    return rel_err <= CHAIN_RTOL
  return abs_err == 0


def warm_ms(fn: Callable[[], object], reps: int = 5, warmup: int = 1
            ) -> float:
  """Median device milliseconds of ``fn()``, CUDA events around each
  call, L2 left warm (the chain's block lives there by design)."""
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def slope_us(run: Callable[[int], object], n_small: int, n_big: int,
             reps: int = 5) -> float:
  """Device microseconds per iteration of ``run(n)``: (t(n_big) -
  t(n_small)) / (n_big - n_small), each t a warm median of ``reps``
  launches (the JAX scripts' slope, with CUDA events in place of the
  host clock)."""
  t_small = warm_ms(lambda: run(n_small), reps)
  t_big = warm_ms(lambda: run(n_big), reps)
  return (t_big - t_small) * 1e3 / (n_big - n_small)


def max_error(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
  """(largest absolute, largest relative) difference. Equal values,
  infinities included, and NaN against NaN differ by 0; any other
  difference with an infinity or a NaN is infinite (exp45's full2d
  bodies overflow to inf within two iterations and reach NaN in three,
  in the JAX script as here)."""
  g, w = got.to(torch.float64), want.to(torch.float64)
  same = (g == w) | (torch.isnan(g) & torch.isnan(w))
  diff = torch.where(same, 0.0, (g - w).abs())
  rel = torch.where(same, 0.0, diff / w.abs().clamp_min(1e-30))
  inf = float('inf')
  return (float(torch.nan_to_num(diff, nan=inf).max()),
          float(torch.nan_to_num(rel, nan=inf).max()))


def steps_per_cta(tiles: int, ctas: int, kind: str, depth: int) -> int:
  """Most tiles one CTA walks."""
  if kind == 'grid':
    return min(_stream_run(depth), tiles)
  return math.ceil(tiles / ctas)


# -- the experiment entry points' common part --------------------------------

def _device(device) -> torch.device:
  """``device`` checked: the CPU, or a CUDA card (no CPU fallback)."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise utils.InputError('device %s requested, but no CUDA device is '
                           'available (--device cpu runs the plain '
                           'versions)' % device)
  if device.type not in ('cpu', 'cuda'):
    raise utils.InputError('unsupported device %s (cpu or cuda)' % device)
  return device


def run_stream(cases, device='cuda', n: Optional[int] = None,
               log: Callable[[str], None] = print, reps: int = 20,
               calls: int = 200) -> List[Dict[str, object]]:
  """Each case of exp27 or exp30 on the JAX scripts' input at ``n`` (256
  on the card, 64 on the CPU, as the scripts' interpret runs): the
  result held against x + 1 bit for bit, and on the card its cold-L2
  median (``profiling.cuda_times_ms``), the bound and its share, device
  microseconds per step per CTA and per call back to back. One line
  per case; returns a row per case."""
  device = _device(device)
  n = n or (256 if device.type == 'cuda' else 64)
  x = stream_input(n, device)
  want = x + 1
  rows = []
  for case in cases:
    args = (case.kind, case.blk, case.split, case.depth)
    ok = torch.equal(stream_probe(x, *args), want)
    row = {'case': case.name, 'ok': ok, 'n': n}
    rows.append(row)
    if device.type == 'cpu':
      log('%-18s %s' % (case.name, 'OK' if ok else 'WRONG'))
      continue
    tiles = x.numel() // _tile_floats(case.blk)
    ctas = stream_ctas(case.kind, case.blk, case.split, case.depth, tiles,
                       device)
    steps = steps_per_cta(tiles, ctas, case.kind, case.depth)
    ms = statistics.median(profiling.cuda_times_ms(
        lambda: stream_probe(x, *args), reps=reps))
    _, b2b_us = profiling.back_to_back_us(lambda: stream_probe(x, *args),
                                          calls=calls)
    bound = stream_bound_ms(x)
    row.update(ms=ms, bound_ms=bound, ctas=ctas, steps=steps,
               step_us=ms * 1e3 / steps, b2b_us=b2b_us)
    log('>>> %-18s %.4f ms  share %.3f  per-step %.3f us (%d CTAs x %d '
        'steps)  back to back %.2f us  %s' % (
            case.name, ms, bound / ms, row['step_us'], ctas, steps, b2b_us,
            'OK' if ok else 'WRONG'))
  return rows


def run_chain(bodies, device='cuda', n_small: int = 64, n_big: int = 16384,
              log: Callable[[str], None] = print, reps: int = 5
              ) -> List[Dict[str, object]]:
  """Each body of exp24 or exp45 on the JAX scripts' block. On the card:
  the kernel against its plain version at CHECK_ITERS and ``n_small``
  iterations (``chain_check``), then device microseconds per iteration as the slope between ``n_small``
  and ``n_big`` (``slope_us``), ns per cell per step, grid
  barriers per iteration and the bound. On the CPU: the plain version
  at one iteration, finite and of the block's shape (exp45's full2d
  bodies overflow after it, in the JAX script too). One line per body;
  returns a row per body."""
  device = _device(device)
  rows = []
  if device.type == 'cuda':
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = profiling.max_sm_clock_hz()
  for body in bodies:
    x = chain_input(body.dtype, device)
    counts = op_counts(body.name)
    row = {'body': body.name, 'barriers': body.barriers, 'ops': counts,
           'cluster': body.barriers.cluster > 0}
    rows.append(row)
    if device.type == 'cpu':
      got = chain_probe(x, body, 1)
      ok = tuple(got.shape) == SHAPE and got.dtype == body.dtype and \
          bool(torch.isfinite(got.to(torch.float64)).all())
      row['ok'] = ok
      log('%-14s: plain %s (n=1); %d grid + %d cluster barriers/iter on the '
          'card; per cell and iteration fp32 %g, int32 %g, sfu %g ops' % (
              body.name, 'OK' if ok else 'WRONG', *body.barriers,
              counts['fp32'], counts['int32'], counts['sfu']))
      continue
    ctas: List[int] = []
    abs_err, rel_err = chain_check(x, body, CHECK_ITERS + (n_small,), ctas)
    us = slope_us(lambda n: chain_probe(x, body, n), n_small, n_big, reps)
    bound_ms, unit = chain_bound_ms(body.name, sms, clock_hz)
    row.update(us=us, ns_cell_step=us * 1e3 / CELLS / body.steps,
               bound_ms=bound_ms, bound_by=unit, abs_err=abs_err,
               rel_err=rel_err, ctas=ctas[0],
               ok=chain_ok(body, abs_err, rel_err))
    cluster = ('; on the cluster\'s %d SMs %.3f' % (
        ctas[0], bound_ms * 1e3 * sms / ctas[0] / us) if row['cluster']
               else '')
    log('%-14s: %9.3f us/iter  %7.4f ns/cell/step  %2d grid + %d cluster '
        'barriers/iter  bound %.3f us (%s, share %.3f%s)  %d CTAs%s  max err '
        '%.3g (rel %.3g)%s' % (
            body.name, us, row['ns_cell_step'], *body.barriers,
            bound_ms * 1e3, unit, bound_ms * 1e3 / us, cluster, ctas[0],
            ' (one cluster)' if row['cluster'] else '', abs_err, rel_err,
            '  [%s]' % body.note if body.note else ''))
  return rows


def parse_args(doc: str, argv, flags: Tuple[str, ...] = (),
               chain: bool = False, n_small: int = 64, n_big: int = 16384,
               groups: Tuple[str, ...] = (), grid_edge: bool = False):
  """The experiment entry points' command line: ``--device`` (default
  cuda), the JAX script's own ``flags`` and ``groups`` (positional; none
  given: all), for a chain experiment ``--n-small``/``--n-big``, and
  the streaming experiments' ``--n`` (``grid_edge``)."""
  import argparse
  parser = argparse.ArgumentParser(description=doc.splitlines()[0])
  parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                      help='cuda (default; fails without a card) or cpu '
                      '(the plain versions)')
  for flag in flags:
    parser.add_argument(flag, action='store_true')
  if groups:
    parser.add_argument('groups', nargs='*',
                        help='of %s (default: all)' % ', '.join(groups))
  if chain:
    parser.add_argument('--n-small', type=int, default=n_small)
    parser.add_argument('--n-big', type=int, default=n_big)
  if grid_edge:
    parser.add_argument('--n', type=int, default=None,
                        help='grid edge (default 256 on the card, 64 on '
                        'the CPU)')
  args = parser.parse_args(argv)
  if groups:
    unknown = sorted(set(args.groups) - set(groups))
    if unknown:
      parser.error('unknown groups %s (of %s)' % (unknown, ', '.join(groups)))
    args.groups = tuple(args.groups) or groups
  return args


def entry(run: Callable[[], List[Dict[str, object]]]) -> int:
  """Exit status of an experiment entry point: 1 without the device it
  asked for or when a case fails its check."""
  import sys
  try:
    rows = run()
  except utils.InputError as err:
    print('error: %s' % err, file=sys.stderr)
    return 1
  return 0 if all(row['ok'] for row in rows) else 1
