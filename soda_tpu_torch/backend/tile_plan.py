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
per output. A plan for the default config is laid out exactly as
before.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from soda_tpu_torch import utils
from soda_tpu_torch.backend.plan import (Stage, make_plan,
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

# the JAX kernel's VPU-layout keys (pallas_kernel.py:221-284, :321-340,
# :382-457): no Hopper form yet
LAYOUT_KEYS = ('lane_shift', 'shift_mode', 'transpose_lanes', 'narrow',
               'stage_mode', 'compute_chunk', 'interpret')
# the keys a caller may set on the fused kernel (FusedExecutor, the
# CLI's --kernel-opt); block_rows and mid_tile are the JAX names of the
# tile's axis-0 and axis-1 extents
CONFIG_KEYS = ('tile', 'block_rows', 'mid_tile', 'stream_loop', 'prefetch',
               'dma_split', 'out_dma')


@dataclasses.dataclass(frozen=True)
class KernelConfig:
  """The structural modes of the fused kernel (see kernel_config)."""
  stream_loop: object = False  # False, True or 'peel'
  prefetch: int = 2
  dma_split: int = 1
  out_dma: bool = False

  @property
  def is_default(self) -> bool:
    return self == KernelConfig()


def reject_layout_keys(keys) -> None:
  """Raise utils.InputError naming ROADMAP B item 9 if ``keys`` holds a
  VPU-layout key of the JAX kernel."""
  found = sorted(k for k in keys if k in LAYOUT_KEYS)
  if found:
    raise utils.InputError(
        '%s: VPU register-layout key%s of the TPU kernel, not ported to the '
        'H100 kernel (still to be ported: ROADMAP B item 9)' %
        (', '.join(found), 's' if len(found) > 1 else ''))


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

  @property
  def dim(self) -> int:
    return len(self.shape)

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
              tile: Sequence[int], inputs: bool = True
              ) -> Tuple[Dict[str, int], int]:
  """First-fit shared-memory offsets with liveness reuse.

  Inputs are loaded before the first stage and live until their last
  reader. A stage buffer is allocated before the stage runs and freed
  after its last reader (never during its own reads: a barrier
  separates consecutive stages, so the next stage may reuse it).
  ``inputs=False`` places the stage buffers only (a mode plan keeps its
  input windows apart).
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
    if stage.name in readers:
      alloc(stage.name)
    for parent in sorted(stage.load_offsets):
      if readers.get(parent) == idx:
        live.pop(parent, None)
  return offsets, peak


def _plan_for_tile(stencil, shape, tile, order, spans, margins,
                   config: KernelConfig = KernelConfig()) -> TilePlan:
  if not config.is_default:
    return _mode_plan(stencil, shape, tile, order, spans, margins, config)
  offsets, peak = _allocate(stencil, order, spans, tile)
  return TilePlan(stencil=stencil, shape=tuple(shape), tile=tuple(tile),
                  stages=tuple(order), spans=spans, offsets=offsets,
                  smem_bytes=peak, margins=margins)


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
  offsets, peak = _allocate(stencil, order, spans, tile, inputs=False)
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
  return TilePlan(stencil=stencil, shape=tuple(shape), tile=tuple(tile),
                  stages=tuple(order), spans=spans, offsets=offsets,
                  smem_bytes=base, margins=margins, config=config,
                  steps=steps, slots=slots, rolling=rolling,
                  slot_bytes=slot_bytes, staging=staging)


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
                   mid_tile: Optional[int] = None) -> TilePlan:
  """Plan the fused kernel for ``shape``; ``tile=None`` picks the
  largest candidate tile whose buffers (with ``config``'s window slots
  and staging) fit SMEM_LIMIT. ``block_rows`` and ``mid_tile`` fix the
  tile's axis-0 and axis-1 extents (the JAX kernel's names).

  Raises utils.InputError when the grid is too small for the stencil
  window, or when even a one-cell tile needs more shared memory than a
  block may have (the stage graph is then too wide for this kernel).
  """
  shape = tuple(int(s) for s in shape)
  validate_grid(stencil, shape)
  if len(shape) < 1:
    raise utils.InputError('the fused kernel needs a grid of at least 1-D')
  config = config or KernelConfig()
  plan = make_plan(stencil, 'full')
  stages = _live_stages(stencil, plan.stages)
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
  **opts)`` builds: the keys of ``CONFIG_KEYS`` validated
  (kernel_config), a VPU-layout key of the JAX kernel rejected, any
  other key a TypeError."""
  reject_layout_keys(layout)
  if layout:
    raise TypeError('unexpected kernel options: %s' %
                    ', '.join(sorted(layout)))
  config = kernel_config(len(shape), stream_loop, prefetch, dma_split,
                         out_dma)
  return make_tile_plan(stencil, shape, tile, config, block_rows, mid_tile)
