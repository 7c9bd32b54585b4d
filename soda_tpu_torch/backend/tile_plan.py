"""Tile geometry of the fused CUDA stencil kernel.

The TPU kernel (soda_tpu/backend/pallas_kernel.py) streams halo'd slabs
through VMEM and sizes its blocks against a 16 MB budget
(``estimate_vmem``/``choose_block_rows``, :150-218), reusing stage
slabs by liveness (``scratch_slots``, :104-147). On Hopper one CTA
computes one output tile on every axis with all stage buffers in shared
memory, which holds at most 227 KB per block. This module decides, in
pure Python and for both the generated kernel and its plain PyTorch
version:

- a deterministic stage order that keeps few buffers live (the fusion
  plan's own order depends on the hash seed, plan.py:256, :279-283;
  generated source must not);
- the extent every tensor must cover around one output tile: outputs
  cover the tile, a producer covers the union of its consumers' extents
  shifted by their load offsets;
- the shared-memory offset of every buffer, reused by liveness;
- the largest tile (powers of two, minor axis first, up to 128) whose
  buffers fit, and the legality gate when even a 1-cell tile does not
  (the counterpart of pallas_kernel.py:555-572).

All tuples here are in array-axis order (streaming axis first, DSL
dimension 0 last), like the executors' arrays.

Kernel modes (``KernelConfig``, the structural keys of the TPU kernel,
pallas_kernel.py:298-381): with ``stream_loop`` one CTA walks a run of
``steps`` consecutive axis-0 tiles of one tile column, and its input
windows live apart from the stage buffers, in ``slots`` copies each
(the ``prefetch`` ring); ``out_dma`` adds one tile-sized staging buffer
per output. The layout keys (``KernelConfig.layout``, layout.py) either
keep the stage buffers (``compute_chunk``) or, in value mode, replace
them by a warp window (``WarpPlan``): shared memory holds the input
windows and each warp's scratch, the stages live in registers. A plan
for the default config is laid out exactly as before.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from soda_tpu_torch import utils
from soda_tpu_torch.backend.layout import (LAYOUT_KEYS, LayoutConfig,
                                           layout_config, split_layout_keys)
from soda_tpu_torch.backend.plan import (FusionPlan, Stage, make_plan,
                                         materialized_margins, validate_grid)

# Shared memory a block may use on the H100 (dynamic, opt-in above 48 KB).
SMEM_LIMIT = 232_448
# Buffers start on 16-byte boundaries (vector-width aligned).
ALIGN = 16
# The minor (contiguous) axis of a tile grows first, up to this width.
MAX_MINOR = 128
# Output cells per tile. Measured on an H100 (python -m
# soda_tpu_torch.tile_sweep; PERF.md): without a cap, shared memory
# alone picks tiles that leave one CTA per SM, up to 67% slower than
# the best; half this cap wins in some cells and loses in others.
MAX_TILE_CELLS = 8192
# CTAs a streaming kernel keeps: two per SM of the H100's 132. A CTA's
# run of axis-0 tiles is the longest that still gives this many.
MIN_CTAS = 264

Span = Tuple[Tuple[int, ...], Tuple[int, ...]]  # (neg, pos) per axis

# the keys a caller may set on the fused kernel (FusedExecutor, the
# CLI's --kernel-opt); block_rows and mid_tile are the JAX names of the
# tile's axis-0 and axis-1 extents; the layout keys are layout.py's
CONFIG_KEYS = ('tile', 'block_rows', 'mid_tile', 'stream_loop', 'prefetch',
               'dma_split', 'out_dma') + LAYOUT_KEYS
# Warps per CTA (cuda_source.THREADS / 32): a value-mode CTA's warps
# share its warp blocks.
WARPS = 16
# Live register values per thread that a warp window should keep
# (launch bounds of 512 threads leave 128 registers a thread); the
# smallest window above it is taken when none is below, and spills.
REG_BUDGET = 64
# Live register values per thread beyond which a window is not held at
# all (4 KB of values a thread).
REG_LIMIT = 1024


@dataclasses.dataclass(frozen=True)
class KernelConfig:
  """The structural modes of the fused kernel (see kernel_config)."""
  stream_loop: object = False  # False, True or 'peel'
  prefetch: int = 2
  dma_split: int = 1
  out_dma: bool = False
  layout: Optional[LayoutConfig] = None  # None: the default stage form

  @property
  def is_default(self) -> bool:
    return self == KernelConfig()

  @property
  def one_tile(self) -> bool:
    """No structural mode: one CTA computes one tile, its input windows
    loaded by plain loads (the default kernel's frame)."""
    return dataclasses.replace(self, layout=None) == KernelConfig()


def kernel_config(dim: int, stream_loop=False, prefetch: int = 2,
                  dma_split: int = 1, out_dma: bool = False) -> KernelConfig:
  """Validate the structural keys with the JAX package's rules and
  exception types (pallas_kernel.py:356-381).

  ``prefetch`` > 2 needs ``stream_loop``: a CTA of the non-streaming
  kernel computes one tile, so it has no next step to fetch ahead.
  """
  if stream_loop not in (False, True, 'peel'):
    raise ValueError("stream_loop must be False|True|'peel'")
  if not 2 <= int(prefetch) <= 4:
    raise ValueError('prefetch must be in [2, 4]')
  if not 1 <= int(dma_split) <= 8:
    raise ValueError('dma_split must be in [1, 8]')
  if int(dma_split) > 1 and dim < 3:
    raise ValueError('dma_split requires a 3-D (or higher) grid')
  stream = 'peel' if stream_loop == 'peel' else bool(stream_loop)
  if int(prefetch) > 2 and not stream:
    raise utils.InputError(
        'prefetch %d needs stream_loop: a CTA of the non-streaming kernel '
        'computes one tile, so there is no next step to fetch ahead' %
        int(prefetch))
  config = KernelConfig(stream_loop=stream, prefetch=int(prefetch),
                        dma_split=int(dma_split), out_dma=bool(out_dma))
  if not config.is_default and dim < 2:
    raise utils.InputError('the kernel modes need a grid of at least 2-D')
  return config


def _pow2_ceil(n: int) -> int:
  p = 1
  while p < n:
    p *= 2
  return p


def _round_up(x: int, m: int) -> int:
  return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class TilePlan:
  """Geometry of one (stencil, shape, tile) kernel.

  Attributes:
    stencil: the core.Stencil.
    shape: full array shape.
    tile: output cells per CTA on each axis.
    stages: live stages (those some output depends on), in evaluation
      order.
    spans: tensor name -> (neg, pos): the tensor covers
      [origin - neg, origin + tile + pos) around a tile at ``origin``.
      Inputs and every stage in ``stages`` have one.
    offsets: tensor name -> byte offset of its shared-memory buffer.
      Inputs and stages that another stage reads have one; outputs
      nobody reads go straight to device memory.
    smem_bytes: shared memory one CTA needs.
    margins: tensor name -> (lo, hi) valid-region margins
      (plan.materialized_margins, here per array axis).
    config: the kernel's structural modes.
    steps: axis-0 tiles one CTA walks (1 without ``stream_loop``).
    slots: input windows per input (the ``prefetch`` ring; 1 without
      ``stream_loop``); a mode plan's input ``offsets`` name slot 0 and
      slot j lies ``slot_bytes[name] * j`` bytes further.
    rolling: consecutive windows of a run share their overlap rows,
      kept in shared memory; each step loads only the new rows.
    slot_bytes: input name -> bytes of one window slot (mode plans).
    staging: output name -> byte offset of its tile-sized staging
      buffer (``out_dma``).
    warp: a value-mode plan's warp window (WarpPlan); its stages live
      in registers, so ``offsets`` names the inputs only.
  """
  stencil: object
  shape: Tuple[int, ...]
  tile: Tuple[int, ...]
  stages: Tuple[Stage, ...]
  spans: Dict[str, Span]
  offsets: Dict[str, int]
  smem_bytes: int
  margins: Dict[str, Span]
  config: KernelConfig = KernelConfig()
  steps: int = 1
  slots: int = 1
  rolling: bool = False
  slot_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
  staging: Dict[str, int] = dataclasses.field(default_factory=dict)
  warp: Optional['WarpPlan'] = None

  @property
  def dim(self) -> int:
    return len(self.shape)

  @property
  def layout(self) -> Optional[LayoutConfig]:
    return self.config.layout

  @property
  def grid(self) -> Tuple[int, ...]:
    """Tiles per axis (the last tile on an axis may be ragged)."""
    return tuple(-(-s // t) for s, t in zip(self.shape, self.tile))

  @property
  def n_tiles(self) -> int:
    n = 1
    for g in self.grid:
      n *= g
    return n

  @property
  def n_chunks(self) -> int:
    """Runs of ``steps`` axis-0 tiles per tile column (the last may be
    shorter)."""
    return -(-self.grid[0] // self.steps)

  @property
  def n_ctas(self) -> int:
    return self.n_chunks * (self.n_tiles // self.grid[0])

  @property
  def peel(self) -> bool:
    """'peel' peels a run's first and last steps only when a run has at
    least 4 steps (pallas_kernel.py:1458)."""
    return self.config.stream_loop == 'peel' and self.steps >= 4

  @property
  def steady(self) -> Tuple[int, int]:
    """(first, last) axis-0 tile index whose every axis-0 bounds check
    holds for every cell: input windows inside the array, each stage's
    box inside its valid rows (empty when first > last)."""
    t0, s0 = self.tile[0], self.shape[0]
    k_lo, k_hi = 0, self.grid[0] - 1
    for name, (neg, pos) in self.spans.items():
      if name in self.stencil.input_names:
        if not self.buffered(name):
          continue
        lo = hi = 0
      else:
        lo, hi = self.margins[name][0][0], self.margins[name][1][0]
      k_lo = max(k_lo, -(-(neg[0] + lo) // t0))
      k_hi = min(k_hi, (s0 - hi - pos[0] - t0) // t0)
    return k_lo, k_hi

  def halo0(self, name: str) -> int:
    """Rows two consecutive axis-0 windows of ``name`` share."""
    neg, pos = self.spans[name]
    return neg[0] + pos[0]

  def fill_class(self, name: str, k: int, first: int) -> str:
    """How step ``k`` of a run starting at ``first`` fills ``name``'s
    window: 'full' (the whole window: a run's first step, or every step
    without rolling), 'mid' (the overlap kept, ``tile[0]`` new rows
    inside the array) or 'tail' (the new rows run past the array's end
    and are zero-filled). The JAX kernel's 'second' class comes from its
    first window being clamped to the array (pallas_kernel.py:863-866);
    here the first window is not clamped (rows above the array are
    zero-filled, as the default kernel does), so 'second' is 'mid'."""
    if k == first or not self.rolling:
      return 'full'
    end = (k + 1) * self.tile[0] + self.spans[name][1][0]
    return 'tail' if end > self.shape[0] else 'mid'

  def extent(self, name: str) -> Tuple[int, ...]:
    neg, pos = self.spans[name]
    return tuple(t + n + p for t, n, p in zip(self.tile, neg, pos))

  def buffered(self, name: str) -> bool:
    return name in self.offsets

  def dtype(self, name: str):
    return self.stencil.tensors[name].dtype


def _array_margins(stencil) -> Dict[str, Span]:
  """materialized_margins re-expressed per array axis."""
  out = {}
  for name, (lo, hi) in materialized_margins(stencil).items():
    out[name] = (tuple(reversed(lo)), tuple(reversed(hi)))
  return out


def _array_offsets(stage: Stage, parent: str) -> Tuple[Tuple[int, ...], ...]:
  """Load offsets of ``stage`` from ``parent``, per array axis."""
  return tuple(tuple(reversed(off)) for off in stage.load_offsets[parent])


def _live_stages(stencil, stages: Sequence[Stage]) -> List[Stage]:
  """Stages some output depends on, in chronological order."""
  by_name = {s.name: s for s in stages}
  needed = set()
  todo = [n for n in stencil.output_names if n in by_name]
  while todo:
    name = todo.pop()
    if name in needed:
      continue
    needed.add(name)
    todo.extend(p for p in by_name[name].load_offsets if p in by_name)
  order = {t.name: i for i, t in enumerate(stencil.chronological_tensors)}
  return sorted((s for s in stages if s.name in needed),
                key=lambda s: order[s.name])


def _spans(stencil, stages: Sequence[Stage]) -> Dict[str, Span]:
  """Extent of every tensor around one output tile (see TilePlan)."""
  dim = len(stencil.tile_size)
  spans: Dict[str, List[List[int]]] = {}
  for name in stencil.output_names:
    spans[name] = [[0] * dim, [0] * dim]
  for stage in reversed(stages):  # consumers before their producers
    neg, pos = spans[stage.name]
    for parent in sorted(stage.load_offsets):
      for off in _array_offsets(stage, parent):
        if parent not in spans:
          spans[parent] = [[n - d for n, d in zip(neg, off)],
                           [p + d for p, d in zip(pos, off)]]
          continue
        pn, pp = spans[parent]
        for a in range(dim):
          pn[a] = max(pn[a], neg[a] - off[a])
          pp[a] = max(pp[a], pos[a] + off[a])
  for name in stencil.input_names:  # an input no output reads
    spans.setdefault(name, [[0] * dim, [0] * dim])
  return {k: (tuple(v[0]), tuple(v[1])) for k, v in spans.items()}


def _dfs_order(stencil, stages: Sequence[Stage]) -> List[Stage]:
  """Post-order from the outputs, hungriest parent subtree first
  (Sethi-Ullman), ties broken by chronological position: completes
  each subtree before starting a sibling, so few values are live."""
  by_name = {s.name: s for s in stages}
  chrono = {s.name: i for i, s in enumerate(stages)}

  def parents(name):
    return sorted((p for p in by_name[name].load_offsets if p in by_name),
                  key=chrono.get)

  su: Dict[str, int] = {}
  for stage in stages:  # chronological: parents first
    ps = sorted((su[p] for p in parents(stage.name)), reverse=True)
    su[stage.name] = max((x + i for i, x in enumerate(ps)), default=1)

  order: List[Stage] = []
  done = set()
  for out in stencil.output_names:
    if out not in by_name:
      continue
    stack = [out]
    while stack:
      name = stack[-1]
      if name in done:
        stack.pop()
        continue
      pending = [p for p in parents(name) if p not in done]
      if pending:
        # pushed last = visited first: highest su, then earliest
        stack.extend(sorted(pending, key=lambda p: (su[p], -chrono[p])))
        continue
      stack.pop()
      done.add(name)
      order.append(by_name[name])
  return order


def last_readers(order: Sequence[Stage]) -> Dict[str, int]:
  """Tensor name -> index in ``order`` of the last stage that reads it."""
  readers: Dict[str, int] = {}
  for idx, stage in enumerate(order):
    for parent in stage.load_offsets:
      readers[parent] = idx
  return readers


def _allocate(stencil, order: Sequence[Stage], spans: Dict[str, Span],
              tile: Sequence[int], inputs: bool = True, stages: bool = True
              ) -> Tuple[Dict[str, int], int]:
  """First-fit shared-memory offsets with liveness reuse.

  Inputs are loaded before the first stage and live until their last
  reader. A stage buffer is allocated before the stage runs and freed
  after its last reader (never during its own reads: a barrier
  separates consecutive stages, so the next stage may reuse it).
  ``inputs=False`` places the stage buffers only (a mode plan keeps its
  input windows apart); ``stages=False`` the input windows only (a
  value-mode plan keeps its stages in registers).
  """
  readers = last_readers(order)

  def nbytes(name):
    neg, pos = spans[name]
    cells = 1
    for t, n, p in zip(tile, neg, pos):
      cells *= t + n + p
    itemsize = stencil.tensors[name].dtype.np_dtype.itemsize
    return _round_up(cells * itemsize, ALIGN)

  live: Dict[str, Tuple[int, int]] = {}
  offsets: Dict[str, int] = {}
  peak = 0

  def alloc(name):
    nonlocal peak
    size = nbytes(name)
    spans_ = sorted(live.values())
    start = 0
    for lo, hi in spans_:
      if start + size <= lo:
        break
      start = max(start, hi)
    live[name] = (start, start + size)
    offsets[name] = start
    peak = max(peak, start + size)

  for name in stencil.input_names:
    if name in readers and inputs:
      alloc(name)
  for idx, stage in enumerate(order):
    if stage.name in readers and stages:
      alloc(stage.name)
    for parent in sorted(stage.load_offsets):
      if readers.get(parent) == idx:
        live.pop(parent, None)
  return offsets, peak


def _plan_for_tile(stencil, shape, tile, order, spans, margins,
                   config: KernelConfig = KernelConfig()) -> TilePlan:
  if not config.one_tile:
    return _mode_plan(stencil, shape, tile, order, spans, margins, config)
  layout = config.layout
  if layout is not None and layout.value:
    offsets, peak = _allocate(stencil, order, spans, tile, stages=False)
    warp = _warp_plan(stencil, shape, tile, order, spans, layout, peak)
    return TilePlan(stencil=stencil, shape=tuple(shape), tile=tuple(tile),
                    stages=tuple(order), spans=spans, offsets=offsets,
                    smem_bytes=warp.smem_end, margins=margins, config=config,
                    warp=warp)
  offsets, peak = _allocate(stencil, order, spans, tile)
  return TilePlan(stencil=stencil, shape=tuple(shape), tile=tuple(tile),
                  stages=tuple(order), spans=spans, offsets=offsets,
                  smem_bytes=peak, margins=margins, config=config)


def steps_per_cta(grid: Sequence[int]) -> int:
  """The longest run of axis-0 tiles per CTA that still leaves MIN_CTAS
  CTAs (1 where the grid has fewer tiles than that): the most reuse of
  input rows between steps that keeps two CTAs per SM."""
  cols = 1
  for g in grid[1:]:
    cols *= g
  best = 1
  for steps in range(1, grid[0] + 1):
    if cols * -(-grid[0] // steps) >= MIN_CTAS:
      best = steps
  return best


def copy_width(stencil, name: str, shape: Sequence[int],
               tile: Sequence[int], spans: Dict[str, Span]
               ) -> Tuple[int, int]:
  """(bytes per asynchronous copy, element phase) of the mode kernels'
  window fill of input ``name``; (0, 0) where it is a plain element
  loop.

  cp.async copies 4, 8 or 16 bytes between addresses aligned to that
  size. A 4- or 8-byte element is one copy. 2-byte elements go as
  4-byte pairs when the array's rows, the tile and the window's rows
  all have an even length: a window row then starts at the same 4-byte
  phase in device memory on every row and in every CTA, and the window
  is placed ``phase`` elements into its slot so that its pairs align in
  shared memory too (the row's odd first or last element is copied on
  its own). Anything else (1-byte elements, odd lengths) is filled
  element by element with plain loads.
  """
  itemsize = stencil.tensors[name].dtype.np_dtype.itemsize
  if itemsize in (4, 8):
    return itemsize, 0
  neg, pos = spans[name]
  ext = tile[-1] + neg[-1] + pos[-1]
  if itemsize == 2 and shape[-1] % 2 == 0 and tile[-1] % 2 == 0 and \
      ext % 2 == 0:
    return 4, neg[-1] % 2
  return 0, 0


def _mode_plan(stencil, shape, tile, order, spans, margins,
               config: KernelConfig) -> TilePlan:
  """Stage buffers reused by liveness, then each input's window slots
  (each window ``copy_width``'s phase into its slot), then the output
  staging buffers."""
  value = config.layout is not None and config.layout.value
  offsets, peak = _allocate(stencil, order, spans, tile, inputs=False,
                            stages=not value)
  readers = last_readers(order)
  grid = [-(-s // t) for s, t in zip(shape, tile)]
  steps = steps_per_cta(grid) if config.stream_loop else 1
  slots = config.prefetch if config.stream_loop else 1
  buffered = [n for n in stencil.input_names if n in readers]
  halos = [spans[n][0][0] + spans[n][1][0] for n in buffered]
  # the JAX kernel's rule (pallas_kernel.py:871-873): depth 2, at least
  # 3 steps, an axis-0 halo shorter than the tile
  rolling = bool(config.stream_loop and config.prefetch == 2 and
                 steps >= 3 and halos and 0 < max(halos) < tile[0])
  base = _round_up(peak, ALIGN)
  slot_bytes = {}
  for name in buffered:
    itemsize = stencil.tensors[name].dtype.np_dtype.itemsize
    _, phase = copy_width(stencil, name, shape, tile, spans)
    cells = 1
    for t, n, p in zip(tile, *spans[name]):
      cells *= t + n + p
    offsets[name] = base + phase * itemsize
    slot_bytes[name] = _round_up((cells + phase) * itemsize, ALIGN)
    base += slot_bytes[name] * slots
  staging = {}
  if config.out_dma:
    cells = 1
    for t in tile:
      cells *= t
    for name in stencil.output_names:
      staging[name] = base
      base += _round_up(cells * stencil.tensors[name].dtype.np_dtype.itemsize,
                        ALIGN)
  warp = None
  if value:
    warp = _warp_plan(stencil, shape, tile, order, spans, config.layout, base)
    base = warp.smem_end
  return TilePlan(stencil=stencil, shape=tuple(shape), tile=tuple(tile),
                  stages=tuple(order), spans=spans, offsets=offsets,
                  smem_bytes=base, margins=margins, config=config,
                  steps=steps, slots=slots, rolling=rolling,
                  slot_bytes=slot_bytes, staging=staging, warp=warp)


@dataclasses.dataclass(frozen=True)
class WarpPlan:
  """The warp window of a value-mode plan (layout forms L1-L3).

  A CTA's tile is covered by warp blocks of ``block`` output cells
  (the last on each axis may reach past the tile: those cells are not
  stored); the CTA's warps take the blocks in turn. A warp evaluates
  every stage of its block in registers over a window whose frame is
  the block widened by ``frame_neg``/``frame_pos`` on each axis but the
  minor one, where the frame is ``width`` = 32 x ``cells`` columns:
  lane ``l`` holds columns ``l * cells .. l * cells + cells - 1``, and
  frame column ``frame_neg[-1]`` is the block's first. A tensor's
  registers cover ``rows[name]`` (start, count) on each axis but the
  minor one: the whole frame under roll, its own span under window.

  Attributes:
    cells: cells per lane along the minor axis.
    block: output cells per warp block, per axis.
    frame_neg, frame_pos: the frame around the block, per axis (the
      largest span of any tensor).
    rows: tensor name -> ((start, count), ...) on the non-minor axes.
    regs: estimated peak of live register values a thread holds (32-bit
      words), from stage liveness in the plan's order.
    word: bytes per cell in the per-warp scratch (4, or 8 where a tensor
      is 64-bit).
    pad: cells the slice exchange rows reach past the frame on each
      side.
    scratch: bytes of one warp's scratch (transposes, slice rows).
    scratch_offset: byte offset of warp 0's scratch.
  """
  cells: int
  block: Tuple[int, ...]
  frame_neg: Tuple[int, ...]
  frame_pos: Tuple[int, ...]
  rows: Dict[str, Tuple[Tuple[int, int], ...]]
  regs: int
  word: int
  pad: int
  scratch: int
  scratch_offset: int

  @property
  def width(self) -> int:
    return 32 * self.cells

  @property
  def window(self) -> Tuple[int, ...]:
    """The frame's extent on each axis (the minor one: ``width``)."""
    return tuple(b + n + p for b, n, p in zip(
        self.block[:-1], self.frame_neg[:-1], self.frame_pos[:-1])) + (
            self.width,)

  @property
  def lane_rows(self) -> int:
    """Frame rows one lane holds in transposed layout (2-D)."""
    return -(-self.window[0] // 32)

  @property
  def smem_end(self) -> int:
    return self.scratch_offset + WARPS * self.scratch

  def grid(self, tile: Sequence[int]) -> Tuple[int, ...]:
    """Warp blocks per axis of a tile."""
    return tuple(-(-t // b) for t, b in zip(tile, self.block))

  def n_blocks(self, tile: Sequence[int]) -> int:
    return _prod(self.grid(tile))

  def row_count(self, name: str) -> int:
    return _prod(c for _, c in self.rows[name])


def _window_values(stencil, order, spans, layout, cells, block, neg, pos,
                   word, pad):
  """(rows, regs, cost, scratch) of one warp window: each tensor's
  rows, the peak of live register values (inputs from their first to
  their last reader, a stage from itself to its last reader, a
  transposed region's entry and exit copies as extra values), the
  cells evaluated per output cell, and one warp's scratch bytes."""
  dim = len(block)
  width = 32 * cells
  window = [b + n + p for b, n, p in zip(block[:-1], neg[:-1], pos[:-1])]
  readers = last_readers(order)
  rows = {}
  for name, (n, p) in spans.items():
    if layout.roll:
      rows[name] = tuple((0, e) for e in window)
    else:
      rows[name] = tuple((neg[a] - n[a], block[a] + n[a] + p[a])
                         for a in range(dim - 1))
  lane_rows = -(-window[0] // 32)

  def words(name):
    return 2 if stencil.tensors[name].dtype.np_dtype.itemsize == 8 else 1

  def count(name):
    return _prod(c for _, c in rows[name])

  def size(name, form):
    if form == 'transposed':
      return width * lane_rows * words(name)
    if form == 'packed':
      return count(name) * cells // 2
    return count(name) * cells * words(name)

  index = {s.name: i for i, s in enumerate(order)}
  live = []  # (first, last, registers)
  for name in stencil.input_names:
    if name in readers:
      first = min(i for i, s in enumerate(order) if name in s.load_offsets)
      live.append((first, readers[name], size(name, 'cells')))
  for i, stage in enumerate(order):
    name = stage.name
    last = readers.get(name, i)
    if name in layout.transposed:
      live.append((i, last, size(name, 'transposed')))
      live.append((i, last, size(name, 'cells')))  # exit copy
      for parent in stage.load_offsets:
        if parent not in layout.transposed and parent in spans:
          live.append((i, readers[parent], size(parent, 'transposed')))
    else:
      form = 'packed' if name in layout.narrow16 else 'cells'
      live.append((i, last, size(name, form)))
  regs = max(sum(r for f, l, r in live if f <= k <= l)
             for k in range(len(order)))
  evaluated = sum(count(n) * width for n in spans if n in readers or
                  n in index)
  cost = evaluated / _prod(block)
  scratch = 0
  if layout.transposed:
    scratch = 32 * lane_rows * (width + 1) * word
  if not layout.rotate:
    for stage in order:
      if stage.name in layout.transposed:
        continue
      need = sum(count(p) * (width + 2 * pad) * word
                 for p, offs in stage.load_offsets.items()
                 if p in spans and any(off[0] for off in offs))
      scratch = max(scratch, need)
  return rows, regs, cost, _round_up(scratch, ALIGN)


def _warp_plan(stencil, shape, tile, order, spans, layout: LayoutConfig,
               base: int) -> WarpPlan:
  """Choose the warp window of a value-mode plan: among the lane widths
  (1-8 cells a lane; even under ``narrow``) and blocks (powers of two
  on the non-minor axes, the minor block as wide as the frame allows,
  up to the tile) whose scratch fits shared memory after ``base``
  bytes, the least evaluated cells per output cell whose live registers
  stay within REG_BUDGET; else the fewest live registers. Raises
  utils.InputError when even that window exceeds REG_LIMIT. A window
  whose scratch fits nowhere yields a plan past SMEM_LIMIT (the caller
  then takes a smaller tile)."""
  dim = len(shape)
  neg = tuple(max(n[a] for n, _ in spans.values()) for a in range(dim))
  pos = tuple(max(p[a] for _, p in spans.values()) for a in range(dim))
  halo = neg[-1] + pos[-1]
  word = 8 if any(stencil.tensors[n].dtype.np_dtype.itemsize == 8
                  for n in spans) else 4
  pad = max([abs(off[0]) for s in order for offs in s.load_offsets.values()
             for off in offs] or [0])

  def sizes(extent):
    out = []
    b = 1
    while b < extent:
      out.append(b)
      b *= 2
    return out + [extent]

  scratch_offset = _round_up(base, ALIGN)
  cands = []
  for cells in range(1, 9):
    width = 32 * cells
    if width <= halo or (layout.narrow16 and cells % 2):
      continue
    minor = min(width - halo, tile[-1])
    axes = [sizes(t) for t in tile[:-1]]
    if dim == 3:
      axes[1] = [b for b in axes[1] if b <= 4]
    for lead in ([()] if dim == 1 else [(b,) for b in axes[0]]):
      for mid in ([()] if dim < 3 else [(b,) for b in axes[1]]):
        block = lead + mid + (minor,)
        rows, regs, cost, scratch = _window_values(
            stencil, order, spans, layout, cells, block, neg, pos, word, pad)
        fits = scratch_offset + WARPS * scratch <= SMEM_LIMIT
        cands.append((fits, regs <= REG_BUDGET, cost, regs, cells, block,
                      rows, scratch))
    if width - halo >= tile[-1]:
      break  # a wider frame covers no more of the tile
  fitting = [c for c in cands if c[0]] or sorted(
      cands, key=lambda c: c[7])[:1]
  within = [c for c in fitting if c[1]]
  if within:
    pick = min(within, key=lambda c: (c[2], c[3]))
  else:
    pick = min(fitting, key=lambda c: (c[3], c[2]))
  _, _, _, regs, cells, block, rows, scratch = pick
  if regs > REG_LIMIT:
    raise utils.InputError(
        'the value-mode warp window needs %d live register values a thread '
        'even at its smallest (%s, %d cells a lane), more than %d; use '
        "stage_mode='vmem'" % (regs, block, cells, REG_LIMIT))
  return WarpPlan(cells=cells, block=block, frame_neg=neg, frame_pos=pos,
                  rows=rows, regs=regs, word=word, pad=pad, scratch=scratch,
                  scratch_offset=scratch_offset)


def candidate_tiles(shape: Sequence[int],
                    max_cells: int = MAX_TILE_CELLS
                    ) -> List[Tuple[int, ...]]:
  """Tiles in growing order: the minor axis doubles first (up to
  MAX_MINOR), then the other axes double in turn from the minor end,
  each up to its extent, while the tile stays within ``max_cells``."""
  dim = len(shape)
  caps = [_pow2_ceil(s) for s in shape]
  caps[-1] = min(caps[-1], MAX_MINOR)
  tile = [1] * dim
  out = [tuple(tile)]
  while tile[-1] < caps[-1]:
    tile[-1] *= 2
    out.append(tuple(tile))
  grew = True
  while grew:
    grew = False
    for a in range(dim - 2, -1, -1):
      cells = 1
      for t in tile:
        cells *= t
      if tile[a] < caps[a] and cells * 2 <= max_cells:
        tile[a] *= 2
        out.append(tuple(tile))
        grew = True
  return out


def _fixed_candidates(shape: Sequence[int], fixed: Dict[int, int]
                      ) -> List[Tuple[int, ...]]:
  """candidate_tiles with the ``fixed`` axes' extents imposed, in
  growing order, within MAX_TILE_CELLS where any is (else all)."""
  out: List[Tuple[int, ...]] = []
  for cand in candidate_tiles(shape):
    tile = tuple(fixed.get(a, t) for a, t in enumerate(cand))
    if tile not in out:
      out.append(tile)
  capped = [t for t in out if int(_prod(t)) <= MAX_TILE_CELLS]
  return capped or out[:1]


def _prod(values) -> int:
  n = 1
  for v in values:
    n *= v
  return n


def make_tile_plan(stencil, shape: Sequence[int],
                   tile: Optional[Sequence[int]] = None,
                   config: Optional[KernelConfig] = None,
                   block_rows: Optional[int] = None,
                   mid_tile: Optional[int] = None,
                   fusion: Optional[FusionPlan] = None) -> TilePlan:
  """Plan the fused kernel for ``shape``; ``tile=None`` picks the
  largest candidate tile whose buffers (with ``config``'s window slots
  and staging) fit SMEM_LIMIT. ``block_rows`` and ``mid_tile`` fix the
  tile's axis-0 and axis-1 extents (the JAX kernel's names). ``fusion``
  is the stencil's ``make_plan(stencil, 'full')``, built when None.

  Raises utils.InputError when the grid is too small for the stencil
  window, or when even a one-cell tile needs more shared memory than a
  block may have (the stage graph is then too wide for this kernel).
  """
  shape = tuple(int(s) for s in shape)
  validate_grid(stencil, shape)
  if len(shape) < 1:
    raise utils.InputError('the fused kernel needs a grid of at least 1-D')
  config = config or KernelConfig()
  stages = _live_stages(stencil, (fusion or make_plan(stencil,
                                                      'full')).stages)
  spans = _spans(stencil, stages)
  order = _dfs_order(stencil, stages)
  margins = _array_margins(stencil)
  fixed = {a: int(v) for a, v in ((0, block_rows), (1, mid_tile))
           if v is not None}
  if mid_tile is not None and len(shape) != 3:
    raise utils.InputError('mid tiling applies to 3-D grids only')
  if any(v < 1 for v in fixed.values()):
    raise utils.InputError('block_rows and mid_tile must be positive, got %s'
                           % fixed)
  if tile is not None:
    tile = tuple(int(t) for t in tile)
    if len(tile) != len(shape) or min(tile) < 1:
      raise utils.InputError('tile %s does not match the %d-D grid' %
                             (tile, len(shape)))
    if fixed:
      raise utils.InputError('give tile, or block_rows/mid_tile, not both')
    tp = _plan_for_tile(stencil, shape, tile, order, spans, margins, config)
    if not config.is_default and tp.smem_bytes > SMEM_LIMIT:
      raise utils.InputError(
          'tile %s with %s needs %d bytes of shared memory, more than the '
          '%d a block may use' % (tile, config, tp.smem_bytes, SMEM_LIMIT))
    return tp
  chosen = None
  cands = _fixed_candidates(shape, fixed) if fixed else candidate_tiles(shape)
  for cand in cands:
    tp = _plan_for_tile(stencil, shape, cand, order, spans, margins, config)
    if tp.smem_bytes > SMEM_LIMIT:
      break
    chosen = tp
  if chosen is None:
    raise utils.InputError(
        'the fused kernel needs %d bytes of shared memory even for a '
        'one-cell tile, more than the %d a block may use; split the '
        'pipeline (cluster: coarse), shorten its window, or run the '
        "whole-grid executor (backend 'xla')" %
        (tp.smem_bytes, SMEM_LIMIT))
  return chosen


def kernel_plan(stencil, shape: Sequence[int],
                tile: Optional[Sequence[int]] = None,
                block_rows: Optional[int] = None,
                mid_tile: Optional[int] = None, stream_loop=False,
                prefetch: int = 2, dma_split: int = 1, out_dma: bool = False,
                **layout) -> TilePlan:
  """The plan of the fused kernel that ``FusedExecutor(stencil, shape,
  **opts)`` builds: the structural keys validated (kernel_config), the
  layout keys checked and resolved with the JAX package's rules
  (layout.layout_config; none given: the default stage form),
  ``interpret`` an InputError, any other key a TypeError."""
  keys = split_layout_keys(layout)
  if layout:
    raise TypeError('unexpected kernel options: %s' %
                    ', '.join(sorted(layout)))
  config = kernel_config(len(shape), stream_loop, prefetch, dma_split,
                         out_dma)
  fusion = make_plan(stencil, 'full')
  if keys:
    config = dataclasses.replace(config, layout=layout_config(
        fusion, shape, mid_tile=mid_tile, **keys))
  return make_tile_plan(stencil, shape, tile, config, block_rows, mid_tile,
                        fusion)
