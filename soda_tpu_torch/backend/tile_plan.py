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
pallas_kernel.py:298-381) build the short form (``ShortForm``), as the
public ``tile``, ``block_rows`` and ``mid_tile`` do: ``stream_loop``
turns its walk on (one CTA walks a run of ``steps`` consecutive axis-0
tiles of one tile column, each buffer a ring of rows), ``prefetch`` is
the walk's depth, ``out_dma`` adds one tile-sized staging buffer per
output. The layout keys (``KernelConfig.layout``, layout.py) build the
short form too, with a layout element on it: in value mode a region
(``Region``: stages a CTA evaluates in registers, in strips of axis-0
rows and windows of lanes, minor-axis taps by lane rotates, 16-bit
stages packed under ``narrow``), ``compute_chunk`` the short form as it
is. With the private ``_short=()`` the same keys build the old plans:
the mode plans' input windows apart from the stage buffers, in
``slots`` copies each (the ``prefetch`` ring), and the staging buffers;
the layout plans' stage buffers (``compute_chunk``) or, in value mode,
a warp window (``WarpPlan``) whose shared memory holds the input
windows and each warp's scratch. A plan for the default config is laid
out exactly as before.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from soda_tpu_torch import utils
from soda_tpu_torch.ir import nodes as ir
from soda_tpu_torch.backend.layout import (LAYOUT_KEYS, LayoutConfig,
                                           layout_config, split_layout_keys)
from soda_tpu_torch.backend.plan import (FusionPlan, Stage, make_plan,
                                         materialized_margins, validate_grid)

# Shared memory a block may use on the H100 (dynamic, opt-in above 48 KB).
SMEM_LIMIT = 232_448
# Shared memory of one H100 SM, and what each resident CTA reserves of it
# besides its own buffers: k CTAs reside where k * (bytes + 1 KB) fit.
SM_SMEM = 233_472
CTA_SMEM_RESERVED = 1024
# Threads one SM holds at once.
SM_THREADS = 2048
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
# The many-stage form (DeepForm), element by element in the order they
# are measured: 'tile' picks the tile for resident CTAs (alone: the
# default form at that tile), 'cells' walks each stage's extent by a
# thread map fixed per extent, 'interior' drops the valid-region tests
# in CTAs that lie inside every stage's valid region, 'barriers' runs a
# barrier only where a stage reads fresh data or overwrites a slot read
# since the last one, 'intervals' reorders the stages into barrier
# intervals and places their buffers so that independent stages share
# one. DEEP_DEFAULT are the elements the default kernel takes: those
# whose step lowered the time back to back (PERF.md, the many-stage
# form's findings).
DEEP_ELEMENTS = ('tile', 'cells', 'interior', 'barriers', 'intervals')
DEEP_DEFAULT = DEEP_ELEMENTS
# Stages at which the default kernel takes the many-stage form. A stage
# of the default form is one pass of the CTA's threads over an extent
# of a few thousand cells (a few a thread) and then a barrier that
# drains the SM; with a handful of stages (the 11 other benchmark cells
# have 2-10) the input fill and the stores dominate, while contrast's
# 114 stages of 1-6 cells a thread ran at 0.4% of its bound (PERF.md's
# default kernel table). Any count between them separates the cells.
DEEP_MIN_STAGES = 32
# Barriers a tile the form's schedule may take, as a share of its
# stages. Swept on an H100 (python -m soda_tpu_torch.tile_sweep --deep;
# PERF.md): at each of contrast's tiles, its stages in shared barrier
# intervals (8-44 barriers for 114 stages) ran 0.75-0.89x the time of
# the default order with a barrier only where one is needed (79-90). A
# tile whose buffers leave no room to share intervals falls back towards
# that, and the next tile is taken.
DEEP_MAX_BARRIER_SHARE = 1 / 3
# The short form (ShortForm), the default kernel of stage graphs below
# DEEP_MIN_STAGES, element by element in the order they are measured:
# 'cells' walks each extent by the many-stage form's fixed thread maps
# (the form's base), 'interior' drops the bounds and valid-region tests
# in CTAs inside every stage's valid region, 'values' evaluates a stage
# that every reader reads only at offset zero over its own extent in
# each reader's registers (no buffer, no barrier), 'vector' gives a
# thread 16 bytes of consecutive minor-axis cells (16-byte cp.async
# fills, register rows of taps, 16-byte stores) where the grid's rows
# allow, 'walk' makes each CTA walk a run of axis-0 tiles of one tile
# column, keeping each buffer's rows that the next tile shares in a ring
# and filling the next tile's new input rows by cp.async while the
# current one computes, 'tile' takes _short_tile's tile in place of the
# default form's.
# short_default(dim) are the elements the default kernel takes: those
# whose step lowered the time back to back (PERF.md, the short form's
# findings).
SHORT_ELEMENTS = ('cells', 'interior', 'values', 'vector', 'walk', 'tile')
# 'walk' lowered the time in the 3-D cells only (jacobi3d 0.77x,
# jacobi3d_256 0.76x at their best tiles; 1.2-1.4x in erosion, xcorr and
# denoise2d, whose rings cost resident CTAs and registers): grids of
# fewer axes take the other elements.
WALK_MIN_DIM = 3
# Bytes of one fill copy (cp.async) and of the widest type's unit.
VECTOR_BYTES = 16
# SMs of the H100, and the waves of resident CTAs the walk's runs fill:
# each CTA walks the fewest axis-0 tiles that keep the grid within them.
SMS = 132
WALK_WAVES = 1


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
    steps: axis-0 tiles one CTA walks (1 without ``stream_loop`` or the
      short form's 'walk').
    slots: input windows per input (the ``prefetch`` ring; 1 without
      ``stream_loop``); an old mode plan's input ``offsets`` name slot 0
      and slot j lies ``slot_bytes[name] * j`` bytes further (the short
      form keeps rings of rows instead: ShortForm.rings, its depth).
    rolling: the old mode plans' rolling fill: consecutive windows of a
      run share their overlap rows, copied in shared memory; each step
      loads only the new rows (the short form's walk keeps them in
      rings, and its plans say False).
    slot_bytes: input name -> bytes of one window slot (old mode plans).
    staging: output name -> byte offset of its tile-sized staging
      buffer (``out_dma``).
    warp: a value-mode plan's warp window (WarpPlan); its stages live
      in registers, so ``offsets`` names the inputs only.
    deep: the many-stage form's schedule (DeepForm), or None.
    short: the short form's geometry (ShortForm), or None.
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
  deep: Optional['DeepForm'] = None
  short: Optional['ShortForm'] = None

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


def _buffer_bytes(stencil, spans: Dict[str, Span], tile: Sequence[int],
                  name: str) -> int:
  """Bytes of ``name``'s shared-memory buffer (its extent, aligned)."""
  neg, pos = spans[name]
  cells = 1
  for t, n, p in zip(tile, neg, pos):
    cells *= t + n + p
  itemsize = stencil.tensors[name].dtype.np_dtype.itemsize
  return _round_up(cells * itemsize, ALIGN)


def _allocate(stencil, order: Sequence[Stage], spans: Dict[str, Span],
              tile: Sequence[int], inputs: bool = True, stages: bool = True,
              sizes: Optional[Dict[str, int]] = None, reads=None
              ) -> Tuple[Dict[str, int], int]:
  """First-fit shared-memory offsets with liveness reuse.

  Inputs are loaded before the first stage and live until their last
  reader. A stage buffer is allocated before the stage runs and freed
  after its last reader (never during its own reads: a barrier
  separates consecutive stages, so the next stage may reuse it).
  ``inputs=False`` places the stage buffers only (a mode plan keeps its
  input windows apart); ``stages=False`` the input windows only (a
  value-mode plan keeps its stages in registers). ``sizes`` gives each
  buffer's bytes (else its extent's), ``reads(stage)`` the buffers a
  stage reads (else its parents; the short form's stages read through
  their register stages).
  """
  reads = reads or (lambda stage: stage.load_offsets)
  readers: Dict[str, int] = {}
  for idx, stage in enumerate(order):
    for parent in reads(stage):
      readers[parent] = idx
  live: Dict[str, Tuple[int, int]] = {}
  offsets: Dict[str, int] = {}
  peak = 0

  def alloc(name):
    nonlocal peak
    size = (sizes[name] if sizes is not None else
            _buffer_bytes(stencil, spans, tile, name))
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
    for parent in sorted(reads(stage)):
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


# -- the many-stage form -------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeepForm:
  """The many-stage form of the default kernel (DEEP_ELEMENTS).

  Attributes:
    elements: the elements on, in DEEP_ELEMENTS order.
    barriers: indices into the plan's stages before which every thread
      of the CTA waits at a barrier; 0 is the one after the input fill.
      Without 'barriers' every stage has one (the default form's
      schedule).
    ctas: resident CTAs an SM that the plan's shared memory leaves.
    evaluations: stage cells a CTA evaluates per output cell.
    interior: per axis, the (first, last) tile origin of a CTA whose
      every stage extent lies inside that stage's valid region and whose
      input windows lie inside the array (first > last: no such CTA).
  """
  elements: Tuple[str, ...]
  barriers: Tuple[int, ...]
  ctas: int
  evaluations: float
  interior: Tuple[Tuple[int, int], ...]

  def has(self, element: str) -> bool:
    return element in self.elements


def resident_ctas(smem_bytes: int) -> int:
  """CTAs of the kernel's 512 threads that one SM holds at once, as its
  threads and its shared memory allow (registers aside)."""
  return min(SM_THREADS // (32 * WARPS),
             SM_SMEM // (smem_bytes + CTA_SMEM_RESERVED))


def stage_evaluations(spans: Dict[str, Span], tile: Sequence[int],
                      order: Sequence[Stage]) -> float:
  """Stage cells one CTA evaluates per output cell of its tile."""
  cells = sum(_prod(t + n + p for t, n, p in zip(tile, *spans[s.name]))
              for s in order)
  return cells / _prod(tile)


def _deep_intervals(stencil, order: Sequence[Stage], spans: Dict[str, Span],
                    tile: Sequence[int], budget: int
                    ) -> Optional[List[List[Stage]]]:
  """Stages in barrier intervals: no stage reads a buffer written in its
  own interval, and a buffer's bytes are free again only in the interval
  after its last reader's. Each interval takes, in ``order``'s priority,
  every stage whose parents are done whose buffer keeps the bytes live
  in the interval within ``budget``, and that leaves the remaining
  stages, one an interval in ``order``, within it too (so the schedule
  always completes). Bytes are counted as a sum; the first-fit
  allocation after it may need more (see _deep_schedule). None when not
  even one stage an interval fits."""
  readers: Dict[str, int] = {}
  for stage in order:
    for parent in stage.load_offsets:
      readers[parent] = readers.get(parent, 0) + 1
  size = {n: _buffer_bytes(stencil, spans, tile, n) if n in readers else 0
          for n in spans}

  def freed(stages, unread):
    return sum(size[p] for p in {p for s in stages for p in s.load_offsets}
               if unread[p] == 0)

  def completes(rest, live, unread):
    unread = dict(unread)
    for stage in rest:
      live += size[stage.name]
      if live > budget:
        return False
      for parent in stage.load_offsets:
        unread[parent] -= 1
        if unread[parent] == 0:
          live -= size[parent]
    return True

  done = set(stencil.input_names)
  unread = dict(readers)
  live = sum(size[n] for n in stencil.input_names if n in size)
  remaining = list(order)
  intervals = []
  if not completes(remaining, live, unread):
    return None
  while remaining:
    cur: List[Stage] = []
    cur_live = live
    for stage in remaining:
      if any(p not in done for p in stage.load_offsets):
        continue
      if cur_live + size[stage.name] > budget:
        continue
      after = dict(unread)
      for parent in stage.load_offsets:
        after[parent] -= 1
      taken = cur + [stage]
      rest = [s for s in remaining if s not in taken]
      if not completes(rest, cur_live + size[stage.name] - freed(taken, after),
                       after):
        continue
      cur, cur_live, unread = taken, cur_live + size[stage.name], after
    intervals.append(cur)
    done.update(s.name for s in cur)
    live = cur_live - freed(cur, unread)
    remaining = [s for s in remaining if s not in cur]
  return intervals


def _allocate_intervals(stencil, intervals: Sequence[Sequence[Stage]],
                        spans: Dict[str, Span], tile: Sequence[int]
                        ) -> Tuple[Dict[str, int], int]:
  """First-fit shared-memory offsets for a schedule of barrier
  intervals: a buffer's bytes are taken from its stage's interval (an
  input's from the fill) to its last reader's, and free from the next
  interval on, so no slot is rewritten before a barrier that follows its
  old occupant's last read."""
  last: Dict[str, int] = {}
  for j, interval in enumerate(intervals):
    for stage in interval:
      for parent in stage.load_offsets:
        last[parent] = j
  live: Dict[str, Tuple[int, int]] = {}
  offsets: Dict[str, int] = {}
  peak = 0

  def alloc(name):
    nonlocal peak
    size = _buffer_bytes(stencil, spans, tile, name)
    start = 0
    for lo, hi in sorted(live.values()):
      if start + size <= lo:
        break
      start = max(start, hi)
    live[name] = (start, start + size)
    offsets[name] = start
    peak = max(peak, start + size)

  for name in stencil.input_names:
    if name in last:
      alloc(name)
  for j, interval in enumerate(intervals):
    for stage in interval:
      if stage.name in last:
        alloc(stage.name)
    for name in [n for n in live if last[n] == j]:
      del live[name]
  return offsets, peak


def hazard_barriers(stencil, stages: Sequence[Stage], offsets: Dict[str, int],
                    spans: Dict[str, Span], tile: Sequence[int],
                    ranges: Optional[Dict[str, Tuple[int, int]]] = None,
                    reads=None, filled: bool = True) -> Tuple[int, ...]:
  """Indices into ``stages`` before which a barrier must run: the stage
  reads bytes written since the last barrier (the input fill writes the
  inputs' buffers), or writes bytes read or written since it. Placing
  each barrier as late as that allows gives the fewest, and each one
  separates a hazard no other separates. ``ranges`` gives each buffer's
  bytes (else from its offset over its extent), ``reads`` as
  ``_allocate``'s; ``filled=False``: a barrier already separates the
  input fill from the first stage (the short form's walk)."""
  def extent(name):
    if ranges is not None:
      return ranges[name]
    start = offsets[name]
    return start, start + _buffer_bytes(stencil, spans, tile, name)

  def meets(a, ranges_):
    return any(a[0] < hi and lo < a[1] for lo, hi in ranges_)

  reads = reads or (lambda stage: stage.load_offsets)
  written = [extent(n) for n in stencil.input_names
             if n in offsets and filled]
  read: List[Tuple[int, int]] = []
  out = []
  for k, stage in enumerate(stages):
    got = [extent(p) for p in sorted(reads(stage)) if p in offsets]
    writes = [extent(stage.name)] if stage.name in offsets else []
    if (any(meets(r, written) for r in got) or
        any(meets(w, written + read) for w in writes)):
      out.append(k)
      written, read = [], []
    read += got
    written += writes
  return tuple(out)


def _deep_schedule(stencil, order: Sequence[Stage], spans: Dict[str, Span],
                   tile: Sequence[int], budget: int
                   ) -> Tuple[List[Stage], Dict[str, int], int]:
  """(stages, offsets, shared-memory bytes) of the barrier-interval
  schedule within ``budget`` bytes: each interval's stages grouped by
  extent (so a thread's cell map serves a run of them), then by
  ``order``. Where first-fit fragments past the budget, the schedule is
  redone under a budget lowered by the excess; one stage an interval in
  ``order`` (the default form's peak) always fits."""
  index = {s.name: i for i, s in enumerate(order)}
  cap = budget
  while True:
    intervals = _deep_intervals(stencil, order, spans, tile, cap)
    if intervals is None:
      intervals = [[s] for s in order]
    intervals = [sorted(iv, key=lambda s: (
        tuple(t + n + p for t, n, p in zip(tile, *spans[s.name])),
        index[s.name])) for iv in intervals]
    offsets, peak = _allocate_intervals(stencil, intervals, spans, tile)
    if peak <= budget or all(len(iv) == 1 for iv in intervals):
      return [s for iv in intervals for s in iv], offsets, peak
    cap -= peak - budget


def _interior_box(stencil, shape, tile, spans, margins, offsets
                  ) -> Tuple[Tuple[int, int], ...]:
  """DeepForm.interior: per axis, the tile origins whose every stage
  extent lies in that stage's valid region and whose buffered input
  windows lie in the array."""
  box = []
  for a in range(len(shape)):
    first, last = 0, shape[a] - 1
    for name, (neg, pos) in sorted(spans.items()):
      if name in stencil.input_names:
        if name not in offsets:
          continue
        lo = hi = 0
      else:
        lo, hi = margins[name][0][a], margins[name][1][a]
      first = max(first, lo + neg[a])
      last = min(last, shape[a] - hi - pos[a] - tile[a])
    box.append((first, last))
  return tuple(box)


def ctas_budget(ctas: int) -> int:
  """Shared memory a CTA may use where ``ctas`` reside on an SM."""
  return min(SMEM_LIMIT, SM_SMEM // ctas - CTA_SMEM_RESERVED)


def _tile_schedule(stencil, order, spans, tile):
  """(stages, offsets, bytes, barriers) of the interval schedule at
  ``tile``: under the budget of the most resident CTAs whose schedule
  stays within DEEP_MAX_BARRIER_SHARE of the stages as barriers, else
  the fewest barriers found; None where not even the default form's
  buffers leave a resident CTA."""
  most = resident_ctas(_allocate(stencil, order, spans, tile)[1])
  best = None
  for ctas in range(most, 0, -1):
    stages, offsets, peak = _deep_schedule(stencil, order, spans, tile,
                                           ctas_budget(ctas))
    got = (stages, offsets, peak,
           hazard_barriers(stencil, stages, offsets, spans, tile))
    if len(got[3]) <= DEEP_MAX_BARRIER_SHARE * len(order):
      return got
    if best is None or len(got[3]) < len(best[3]):
      best = got
  return best


def _deep_tile(stencil, shape, order, spans):
  """(tile, schedule) of the many-stage form: tiles of powers of two on
  every axis (the minor one up to MAX_MINOR) within MAX_TILE_CELLS whose
  default-form buffers (one stage a barrier interval: the least shared
  memory a schedule can take) leave a resident CTA, in order of stage
  evaluations an output; the first whose schedule (_tile_schedule)
  keeps within DEEP_MAX_BARRIER_SHARE, else the one with the fewest
  barriers. The fewest evaluations beat resident CTAs in the sweep
  (PERF.md): at contrast's (32768, 512) the 1-CTA tiles (16, 64), 147.3
  evaluations an output, and (32, 32), 152.0, ran 3% faster back to
  back than (8, 32) at 2 CTAs, 186.2, and 8-11% faster than (16, 16)
  at 3, 195.7; this picks (16, 64). None fit: the smallest tile (the
  caller refuses it)."""
  caps = [_pow2_ceil(s) for s in shape]
  caps[-1] = min(caps[-1], MAX_MINOR)
  axes = []
  for cap in caps:
    sizes, b = [], 1
    while b <= cap:
      sizes.append(b)
      b *= 2
    axes.append(sizes)
  cands = []
  for tile in itertools.product(*axes):
    if _prod(tile) > MAX_TILE_CELLS:
      continue
    if resident_ctas(_allocate(stencil, order, spans, tile)[1]):
      cands.append((stage_evaluations(spans, tile, order), tile))
  best = None
  for _, tile in sorted(cands):
    got = _tile_schedule(stencil, order, spans, tile)
    if len(got[3]) <= DEEP_MAX_BARRIER_SHARE * len(order):
      return tile, got
    if best is None or len(got[3]) < len(best[1][3]):
      best = tile, got
  return best or (tuple(1 for _ in shape), None)


def _deep_plan(stencil, shape, order, spans, margins, elements,
               tile=None) -> TilePlan:
  """The many-stage form's plan (DeepForm) with ``elements`` on, at
  ``tile`` or the one _deep_tile picks."""
  sched = None
  if tile is None:
    tile, sched = _deep_tile(stencil, shape, order, spans)
  stages, (offsets, peak) = list(order), _allocate(stencil, order, spans,
                                                   tile)
  barriers = tuple(range(len(stages)))
  if 'intervals' in elements:
    sched = sched or _tile_schedule(stencil, order, spans, tile)
    if sched is not None:
      stages, offsets, peak, barriers = sched
  elif 'barriers' in elements:
    barriers = hazard_barriers(stencil, stages, offsets, spans, tile)
  deep = DeepForm(elements=tuple(elements), barriers=barriers,
                  ctas=resident_ctas(peak),
                  evaluations=stage_evaluations(spans, tile, order),
                  interior=_interior_box(stencil, shape, tile, spans,
                                         margins, offsets))
  return TilePlan(stencil=stencil, shape=tuple(shape), tile=tuple(tile),
                  stages=tuple(stages), spans=spans, offsets=offsets,
                  smem_bytes=peak, margins=margins, deep=deep)


def deep_elements(elements) -> Tuple[str, ...]:
  """Validate a private ``_deep`` argument: DEEP_ELEMENTS names with
  'tile' among them ('intervals' with 'barriers'), in DEEP_ELEMENTS
  order."""
  names = set(elements)
  if not names <= set(DEEP_ELEMENTS) or 'tile' not in names or (
      'intervals' in names and 'barriers' not in names):
    raise ValueError('the many-stage form takes %s, with tile (and barriers '
                     'for intervals); got %s' % (DEEP_ELEMENTS, sorted(names)))
  return tuple(e for e in DEEP_ELEMENTS if e in names)


# -- the short form -------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShortForm:
  """The short form of the default kernel (SHORT_ELEMENTS).

  A tensor's buffer holds, on every axis but the minor one, its extent's
  rows; on the minor axis its frame, columns [-A, B) around the tile
  origin (``frames``: (A, B), multiples of ``vec``, and of 16 bytes for
  an input where ``vec`` > 1, so that its fill is 16-byte copies). A
  thread owns ``vec`` consecutive cells of a frame row, a unit; it loads
  the cells each tap needs as register rows (``register_rows``), whole
  units of the parent where ``vec`` > 1, which may reach past a frame
  row's ends: into the neighbouring row, or, before the first row and
  after the last, into the buffer's ``slack`` (cells). The frame's cells
  outside the extent are evaluated too and read by no cell of the
  extent.

  Attributes:
    elements: the elements on, in SHORT_ELEMENTS order.
    vec: cells a thread owns on the minor axis (1: the element path).
    values: the stages kept in registers: every reader reads them only
      at offset zero over its own extent, and evaluates them at its own
      cell, parents first ('values').
    frames: tensor name -> (A, B), for the inputs and the stages a
      kernel stage runs (those not in ``values``).
    slack: buffered tensor name -> (cells before, cells after).
    barriers: indices into the plan's stages before which every thread
      of the CTA waits at a barrier; the first is the one after the
      input fill. Only where a stage reads a buffer written since the
      last one or writes bytes read since it (hazard_barriers).
    ctas: resident CTAs an SM that the plan's shared memory leaves (the
      launch bounds ask registers for as many).
    evaluations: stage cells a CTA evaluates per output cell (a
      register stage's at each cell of its readers).
    fills: input cells a CTA fills per output cell.
    interior: as DeepForm's, with each input's frame inside the array.
    rings: buffered tensor name -> the axis-0 rows its buffer holds:
      its extent's, and under 'walk' an input's also the new rows of the
      ``depth - 1`` tiles after it (row r of a run's extent lies in ring
      row (r + phase) mod rings[name], the phase advancing by tile[0] a
      step).
    depth: under 'walk', the tiles whose input rows a CTA holds at once:
      the current one's and those of the ``depth - 1`` after it, in
      flight while it computes (``prefetch``; 2 by default).
    off: element -> why it cannot serve the plan's tile, so that the
      kernel runs without it: 'vector' where a row or the tile's minor
      extent is not whole 16-byte units, 'walk' on a 1-D grid or where
      its rings would not fit shared memory at an explicit tile;
      'region' where no stage fits a warp's registers, 'packed' where a
      lane's columns do not pair up or no narrow stage is a register row.
    layout: the layout elements the plan's layout keys ask for
      (``KernelConfig.layout``): 'region' (``stage_mode='value'``, with
      ``shift_mode``, ``lane_shift`` and ``transpose_lanes``), 'packed'
      (``narrow='on'``), 'chunk' (``compute_chunk``: the short form's
      stage loops as they are, one kernel with the same structural keys).
    region: the value-mode region (Region), or None.
  """
  elements: Tuple[str, ...]
  vec: int
  values: Tuple[str, ...]
  frames: Dict[str, Tuple[int, int]]
  slack: Dict[str, Tuple[int, int]]
  barriers: Tuple[int, ...]
  ctas: int
  evaluations: float
  fills: float
  interior: Tuple[Tuple[int, int], ...]
  rings: Dict[str, int]
  depth: int = 2
  off: Dict[str, str] = dataclasses.field(default_factory=dict)
  layout: Tuple[str, ...] = ()
  region: Optional['Region'] = None

  def has(self, element: str) -> bool:
    return element in self.elements and element not in self.off

  @property
  def on(self) -> Tuple[str, ...]:
    """The elements the kernel runs with."""
    return tuple(e for e in self.elements if e not in self.off)

  def pitch(self, name: str) -> int:
    a, b = self.frames[name]
    return a + b

  def fill_chunk(self, itemsize: int) -> int:
    """Cells of one fill copy of an input: 16 bytes (1 on the element
    path)."""
    return VECTOR_BYTES // itemsize if self.vec > 1 else 1


def value_stages(stencil, order: Sequence[Stage], spans: Dict[str, Span]
                 ) -> Tuple[str, ...]:
  """The stages 'values' keeps in registers: not an output, read by
  some stage, and every reader reads it only at offset zero and has its
  extent."""
  readers: Dict[str, List[Stage]] = {}
  for stage in order:
    for parent in stage.load_offsets:
      readers.setdefault(parent, []).append(stage)
  outputs = set(stencil.output_names)
  out = []
  for stage in order:
    got = readers.get(stage.name)
    if stage.name in outputs or not got:
      continue
    if all(spans[r.name] == spans[stage.name] and
           not any(any(off) for off in r.load_offsets[stage.name])
           for r in got):
      out.append(stage.name)
  return tuple(out)


def value_closure(stage: Stage, by_name: Dict[str, Stage],
                  values: Sequence[str]) -> List[Stage]:
  """The register stages ``stage``'s cell evaluates, in the order of
  ``by_name`` (the plan's stage order: parents first)."""
  out: List[Stage] = []

  def visit(s):
    for parent in sorted(s.load_offsets):
      if parent in values and by_name[parent] not in out:
        visit(by_name[parent])
        out.append(by_name[parent])

  visit(stage)
  order = list(by_name)
  return sorted(out, key=lambda s: order.index(s.name))


def buffer_reads(stage: Stage, by_name: Dict[str, Stage],
                 values: Sequence[str]) -> List[str]:
  """The buffers a kernel stage's cell reads: its parents' and its
  register stages' parents that are not register stages."""
  names = set()
  for s in value_closure(stage, by_name, values) + [stage]:
    names.update(p for p in s.load_offsets if p not in values)
  return sorted(names)


def register_rows(stencil, stage: Stage, by_name: Dict[str, Stage],
                  values: Sequence[str], vec: int, skip: Sequence[str] = ()
                  ) -> Dict[Tuple[str, Tuple[int, ...]], Tuple[int, int]]:
  """(parent, offsets on every axis but the minor one) -> (lo, hi): the
  columns [x0 + lo, x0 + hi) of the parent's row that a thread loads for
  its cells x0 .. x0 + vec - 1 of ``stage`` and its register stages
  (which lie at the stage's own cells), as whole units of ``vec``
  cells; parents in ``skip`` are not loaded (a region's register
  rows)."""
  rows: Dict[Tuple[str, Tuple[int, ...]], Tuple[int, int]] = {}
  for s in value_closure(stage, by_name, values) + [stage]:
    for parent in sorted(s.load_offsets):
      if parent in values or parent in skip:
        continue
      for off in _array_offsets(s, parent):
        key = (parent, off[:-1])
        lo, hi = rows.get(key, (off[-1], off[-1]))
        rows[key] = (min(lo, off[-1]), max(hi, off[-1]))
  out = {}
  for (parent, group), (lo, hi) in sorted(rows.items()):
    out[(parent, group)] = (lo // vec * vec, -(-(vec + hi) // vec) * vec)
  return out


def vector_width(stencil, shape: Sequence[int], tile: Sequence[int],
                 names: Sequence[str]) -> int:
  """'vector''s cells a thread owns on the minor axis: 16 bytes of the
  widest type among ``names``, where every input's and output's rows are
  whole 16-byte units and the tile's minor extent holds whole 16-byte
  units of every type; else 1, the element path (a row of another
  length would start off a 16-byte boundary on some rows, which a
  16-byte copy cannot address), and where a narrower type's unit would
  be 2 bytes (1-byte cells beside 8-byte ones: a register row is loaded
  4, 8 or 16 bytes at a time). A narrower type's unit is 4 or 8 bytes:
  a unit of 16 bytes of it would put a wider type's units 32 bytes
  apart, and a warp's 16-byte shared-memory loads at that stride take
  twice the wavefronts (on an H100, 8 int32 cells a thread ran erosion
  at 1.247x and xcorr at 1.192x the element path; PERF.md)."""
  def size(name):
    return stencil.tensors[name].dtype.np_dtype.itemsize

  vec = VECTOR_BYTES // max(size(n) for n in names)
  edges = list(stencil.input_names) + list(stencil.output_names)
  narrow = min(size(n) for n in names)
  if any(shape[-1] * size(n) % VECTOR_BYTES for n in edges) or \
      tile[-1] % (VECTOR_BYTES // narrow) or vec * narrow < 4:
    return 1
  return vec


# -- the layout element of the short form (value mode: L1-L3) ----------------
# Live 32-bit register words a thread's region may hold at once (its
# register rows, the shifted views it reads and an entry's row), and the
# words a thread needs besides them (addresses, coordinates, loop state):
# the launch bounds ask registers for the resident CTAs that leave
# REGION_BUDGET + REGION_OVERHEAD words a thread at most.
REGION_BUDGET = 80
REGION_OVERHEAD = 40
# Axis-0 rows of the exits one work item computes (its strip), largest
# first: the largest whose register words fit REGION_BUDGET is taken.
REGION_STRIPS = (8, 4, 2, 1)
# Operations an array member may recompute per strip row for its halo
# rows (halo rows / strip x its operations and its inline members', a
# division or a call counted as REGION_SLOW_OP): above it the member is
# a shared-memory stage. On an H100 (chip_smoke.py phase 27) denoise2d's
# g (a square root and a division over four inline differences) at 3
# rows per output row ran 4.2x its default kernel and 1.7x with g in
# shared memory; xcorr's one-add stages at 2.5 rows a row ran 0.92x the
# default kernel, and 1.34x in shared memory.
REGION_RECOMPUTE = 4
REGION_SLOW_OP = 4
# 32-bit registers of one SM (the launch bounds divide them).
SM_REGISTERS = 65536


@dataclasses.dataclass(frozen=True)
class Region:
  """The short form's layout element for ``stage_mode='value'`` (the
  layout forms L1-L3 on Hopper): a set of stages a CTA evaluates in
  registers, after the shared-memory stages they read (its entries) and
  before those that read it.

  A work item is a strip of ``strip`` axis-0 rows of the region's exits,
  one row of every axis between the first and the minor one, and a
  window of ``lanes`` x ``cells`` frame columns; ``lanes`` consecutive
  lanes of a warp take one window, each lane ``cells`` consecutive
  columns (the short form's 16-byte unit). A member in ``arrays`` is a
  register array of its rows (``halo[name]``: rows above and below the
  strip, so an axis-0 tap is a register index and its axis-0 halo is
  computed once a strip) by ``cells`` columns (packed 16-bit pairs for
  ``packed``); a minor-axis tap of another member is a lane rotate
  (``__shfl_sync``), and the window's first and last ``edge`` columns,
  which a rotate fills from a lane outside the window, are evaluated
  and never stored. ``inline`` members are evaluated at each reader's
  cell. Entries are read from shared memory as the short form's register
  rows. ``exits`` (outputs, and members a stage outside the region
  reads) are stored once, by the window that owns the column.

  Attributes:
    members: the region's stages, in the plan's order.
    inline: members every reader (a member) reads only at offset zero.
    arrays: the other members, held as register rows.
    exits: members stored to device memory or to their buffer.
    packed: arrays of narrow16 stages held as packed 16-bit pairs
      (``narrow='on'``; ``soda_pstage_<k>``).
    halo: member -> (rows above, rows below) its strip rows.
    reach: member -> (left, right) columns of a window a rotate fills
      from outside it.
    strip: axis-0 rows of the exits a work item computes.
    lanes: lanes of one window (a power of two).
    cells: columns of a lane.
    edge: (left, right) columns of a window that no exit stores (whole
      units).
    start: the first window's first column, relative to the tile origin.
    stride: columns between two windows' firsts.
    windows: windows a row.
    regs: estimated peak of live register words a thread (entry rows,
      register rows, views).
    off: stage -> why it is not a member (a shared-memory stage).
  """
  members: Tuple[str, ...]
  inline: Tuple[str, ...]
  arrays: Tuple[str, ...]
  exits: Tuple[str, ...]
  packed: Tuple[str, ...]
  halo: Dict[str, Tuple[int, int]]
  reach: Dict[str, Tuple[int, int]]
  strip: int
  lanes: int
  cells: int
  edge: Tuple[int, int]
  start: int
  stride: int
  windows: int
  regs: int
  off: Dict[str, str] = dataclasses.field(default_factory=dict)

  def rows(self, name: str) -> int:
    """Register rows of an array."""
    up, down = self.halo[name]
    return self.strip + up + down


def _region_sides(order: Sequence[Stage], members: set):
  """(stages that depend on a member, stages a member depends on)."""
  by_name = {s.name: s for s in order}
  kids: Dict[str, set] = {s.name: set() for s in order}
  for s in order:
    for p in s.load_offsets:
      if p in kids:
        kids[p].add(s.name)
  after, todo = set(), [k for m in members for k in kids[m]]
  while todo:
    name = todo.pop()
    if name not in after:
      after.add(name)
      todo.extend(kids[name])
  before, todo = set(), [p for m in members for p in by_name[m].load_offsets
                         if p in by_name]
  while todo:
    name = todo.pop()
    if name not in before:
      before.add(name)
      todo.extend(p for p in by_name[name].load_offsets if p in by_name)
  return after, before


def _region_order(order: Sequence[Stage], members: set
                  ) -> Optional[List[Stage]]:
  """``order`` with the members in one run: the stages they depend on
  first, those that depend on them after; None where a stage outside
  the region both depends on a member and feeds one."""
  after, before = _region_sides(order, members)
  if (after & before) - members:
    return None
  return ([s for s in order if s.name not in members and s.name not in after]
          + [s for s in order if s.name in members] +
          [s for s in order if s.name not in members and s.name in after])


def _stage_ops(stage: Stage) -> int:
  """Operations one evaluation of a stage applies (its lets too), a
  division, modulo or call counted as REGION_SLOW_OP."""
  count = [0]

  def visit(node, _):
    if isinstance(node, ir.CHAIN_CLASSES):
      count[0] += sum(REGION_SLOW_OP if op in ('/', '%') else 1
                      for op in node.operator)
    elif isinstance(node, ir.Unary):
      count[0] += sum(op != '+' for op in node.operator)
    elif isinstance(node, ir.Call):
      count[0] += (max(len(node.operand) - 1, 1) if node.name in (
          'min', 'max', 'select', 'abs') else REGION_SLOW_OP)
    return node

  stage.tensor.expr.visit(visit)
  for let in stage.tensor.lets:
    let.expr.visit(visit)
  return count[0]


def _region_regs(stencil, by_name, arrays, inline, packed, members, halo,
                 vec, strip) -> int:
  """Region.regs at a strip of ``strip`` rows: the peak, over the arrays
  in order, of the live arrays' words, the array's own, the shifted
  views it reads and its entries' register rows."""
  def words(name, cells):
    size = stencil.tensors[name].dtype.np_dtype.itemsize
    return cells * (2 if size == 8 else 1)

  def rows(name):
    return strip + sum(halo[name])

  last: Dict[str, str] = {}
  for m in arrays:
    for s in value_closure(by_name[m], by_name, inline) + [by_name[m]]:
      for p in s.load_offsets:
        if p in arrays:
          last[p] = m
  live: Dict[str, int] = {}
  peak = 0
  for m in arrays:
    own = words(m, rows(m) * (vec // 2 if m in packed else vec))
    views = 0
    reads: Dict[str, List[Tuple[int, ...]]] = {}
    for s in value_closure(by_name[m], by_name, inline) + [by_name[m]]:
      for p in s.load_offsets:
        if p in arrays:
          reads.setdefault(p, []).extend(_array_offsets(s, p))
    for p, offs in reads.items():
      d0 = [o[0] for o in offs]
      dl = [o[-1] for o in offs]
      views += words(p, (rows(m) + max(d0) - min(d0)) *
                     (vec + max(dl) - min(dl)))
    # the entries' register rows of every row of the array: the rows'
    # loop is unrolled, and its loads are issued ahead of their use
    entry = rows(m) * sum(words(p, hi - lo) for (p, _), (lo, hi) in
                          register_rows(stencil, by_name[m], by_name, inline,
                                        vec, skip=members).items())
    peak = max(peak, sum(live.values()) + own + views + entry)
    live[m] = own
    for p in [p for p, who in last.items() if who == m]:
      live.pop(p, None)
    if m not in last:
      live.pop(m, None)
  return peak


def _region_geometry(stencil, order, spans, tile, members: set, vec: int,
                     packable: set, strict: bool = True):
  """(Region, None) for ``members``, or (None, (stage, why)): the member
  that keeps them from a warp's registers or a window, or recomputes
  its halo rows too often (``strict=False``: a strip of one row over the
  budget)."""
  last = len(tile) - 1
  run = _region_order(order, members)
  if run is None:  # drop the last member that feeds a stage closing a cycle
    after, before = _region_sides(order, members)
    closing = (after & before) - members
    ancestors = set(closing)
    for s in reversed(order):  # consumers before their producers
      if s.name in ancestors:
        ancestors.update(s.load_offsets)
    victim = [s.name for s in order if s.name in members and
              s.name in ancestors][-1]
    return None, (victim, 'the region would both feed and follow a '
                  'shared-memory stage')
  by_name = {s.name: s for s in run}
  mem = [s for s in run if s.name in members]
  outputs = set(stencil.output_names)
  mreaders: Dict[str, List[Stage]] = {s.name: [] for s in mem}
  wider = set()
  for s in run:
    for p in s.load_offsets:
      if p in members:
        if s.name in members:
          mreaders[p].append(s)
        else:
          wider.add(p)
  exits = [m.name for m in mem if m.name in outputs or m.name in wider]
  packed = [m.name for m in mem if m.name in packable]
  inline = [m.name for m in mem if m.name not in exits and
            m.name not in packed and
            not any(any(any(o) for o in _array_offsets(r, m.name))
                    for r in mreaders[m.name])]
  packed = [p for p in packed if not value_closure(by_name[p], by_name,
                                                    inline)]
  arrays = [m.name for m in mem if m.name not in inline]
  halo: Dict[str, Tuple[int, int]] = {}
  for m in reversed(mem):
    up = down = None
    if m.name in exits:
      up = down = 0
    for r in mreaders[m.name]:
      ru, rd = halo[r.name]
      for o in _array_offsets(r, m.name):
        up = ru - o[0] if up is None else max(up, ru - o[0])
        down = rd + o[0] if down is None else max(down, rd + o[0])
    halo[m.name] = (up, down)
  reach: Dict[str, Tuple[int, int]] = {}
  for m in mem:
    left = right = 0
    for p in m.load_offsets:
      if p in members:
        pl, pr = reach[p]
        for o in _array_offsets(m, p):
          left, right = max(left, pl - o[last]), max(right, pr + o[last])
    reach[m.name] = (left, right)
  lo = min(-_round_up(spans[e][0][last], vec) for e in exits)
  hi = max(_round_up(tile[last] + spans[e][1][last], vec) for e in exits)
  edge = (_round_up(max(reach[e][0] for e in exits), vec),
          _round_up(max(reach[e][1] for e in exits), vec))
  lanes = 32
  for g in (1, 2, 4, 8, 16, 32):
    if g * vec - sum(edge) >= hi - lo:
      lanes = g
      break
  stride = lanes * vec - sum(edge)
  if stride < vec:
    worst = max(arrays, key=lambda n: (sum(reach[n]), arrays.index(n)))
    return None, (worst, 'its minor-axis reach (%d, %d cells) leaves a warp '
                  'no column to store' % reach[worst])
  rows0 = max(tile[0] + spans[e][0][0] + spans[e][1][0] for e in exits)
  strips = [s for s in REGION_STRIPS if s <= max(rows0, 1) and (
      strict or s == 1)] or [1]
  for strip in strips:
    regs = _region_regs(stencil, by_name, arrays, inline, packed, members,
                        halo, vec, strip)
    if regs <= REGION_BUDGET or not strict:
      break
  else:
    worst = max(arrays, key=lambda n: (sum(halo[n]), arrays.index(n)))
    return None, (worst, 'its %d halo rows keep the region over %d register '
                  'words a thread (%d)' % (sum(halo[worst]), REGION_BUDGET,
                                           regs))

  def recompute(name):
    ops = sum(_stage_ops(s) for s in value_closure(by_name[name], by_name,
                                                   inline) + [by_name[name]])
    return sum(halo[name]) / strip * ops

  worst = max(arrays, key=lambda n: (recompute(n), arrays.index(n)))
  if strict and recompute(worst) > REGION_RECOMPUTE:
    return None, (worst, 'its %d halo rows at a strip of %d rows recompute '
                  '%g operations a row, more than %d' % (
                      sum(halo[worst]), strip, recompute(worst),
                      REGION_RECOMPUTE))
  return Region(
      members=tuple(m.name for m in mem), inline=tuple(inline),
      arrays=tuple(arrays), exits=tuple(exits), packed=tuple(packed),
      halo=halo, reach=reach, strip=strip, lanes=lanes, cells=vec,
      edge=edge, start=lo - edge[0], stride=stride,
      windows=-(-(hi - lo) // stride), regs=regs), None


def region_plan(stencil, order: Sequence[Stage], spans: Dict[str, Span],
                tile: Sequence[int], layout: LayoutConfig, vec: int
                ) -> Tuple[Optional[Region], Dict[str, str]]:
  """The value-mode region at ``tile`` (Region), and stage -> why it is
  not a member. A stage is a candidate unless a stage reads it at
  offsets on an axis between the first and the minor one (3-D: it stays
  a shared-memory stage under hazard_barriers), or at minor-axis offsets
  under ``lane_shift='slice'`` (a read of the shared frame) where the
  two are not both in a transposed lane region (L2, whose minor-axis
  taps are register indices). Members then leave, one at a time, while
  the region would close a cycle through a shared-memory stage, leave a
  window no column, hold more than REGION_BUDGET register words a
  thread at a strip of one row (but its last member), or recompute more
  than REGION_RECOMPUTE operations a row for a member's halo rows.
  ``narrow16`` stages are packed where a lane's columns pair up (``vec``
  even)."""
  last = len(tile) - 1
  off: Dict[str, str] = {}
  cand = set()
  for s in order:
    for r in order:
      for o in (_array_offsets(r, s.name) if s.name in r.load_offsets
                else ()):
        if any(o[1:last]):
          off[s.name] = 'read at offsets on an axis between the first and ' \
                        'the minor one (a shared-memory stage)'
        elif o[last] and not layout.rotate and not (
            s.name in layout.transposed and r.name in layout.transposed):
          off.setdefault(s.name, "read at minor-axis offsets under lane_shift"
                         "='slice' (a read of the shared frame)")
    if s.name not in off:
      cand.add(s.name)
  packable = set(layout.narrow16) if vec % 2 == 0 else set()
  while cand:
    region, victim = _region_geometry(stencil, order, spans, tile, cand, vec,
                                      packable)
    if region is not None:
      return dataclasses.replace(region, off=off), off
    if len(cand) == 1 and 'shared-memory stage' not in victim[1]:
      # the last member stays: at a strip of one row, over the budget
      region, _ = _region_geometry(stencil, order, spans, tile, cand, vec,
                                   packable, strict=False)
      return dataclasses.replace(region, off=off), off
    off[victim[0]] = victim[1]
    cand.discard(victim[0])
  return None, off


class _Step:
  """A region's place in the short form's stage sequence for liveness and
  barriers: each buffered exit's write (``reads`` empty), then one read
  of every entry."""

  def __init__(self, name: str, reads: Sequence[str] = ()):
    self.name = name
    self.reads = tuple(reads)


def _short_plan(stencil, shape, order, spans, margins, elements,
                tile, config: KernelConfig = KernelConfig(),
                drop: Optional[Dict[str, str]] = None) -> TilePlan:
  """The short form's plan (ShortForm) with ``elements`` on but those
  ``drop`` turns off (element -> why), at ``tile``, carrying
  ``config``'s modes: under ``stream_loop`` (which turns 'walk' on) a
  CTA walks ``steps_per_cta`` tiles, ``prefetch`` is the walk's depth,
  and ``out_dma`` adds one tile-sized staging buffer per output after
  the others (``dma_split`` changes the fill's code only). A layout in
  value mode adds its region (region_plan; ``narrow='on'`` its packed
  pairs), whose members leave the stage sequence for one run at the
  region's place; ``compute_chunk`` changes nothing (the short form's
  stage loops already give each thread fixed cells of every chunk)."""
  off = dict(drop or {})
  if len(shape) < 2 and 'walk' in elements:
    off['walk'] = 'a 1-D grid has no axis-0 tiles to walk'
  asked = elements
  elements = tuple(e for e in elements if e not in off)
  last = len(shape) - 1
  layout = config.layout
  region, members, asks = None, (), ()
  if layout is not None and layout.value:
    asks = ('region',) + (('packed',) if layout.narrow16 else ())
    vec = (vector_width(stencil, shape, tile, list(spans))
           if 'vector' in elements else 1)
    region, _ = region_plan(stencil, order, spans, tile, layout, vec)
    if region is None:
      off['region'] = 'no stage fits a warp\'s registers at this tile'
    else:
      members = region.members
      order = _region_order(order, set(members))
    if layout.narrow16 and not (region and region.packed):
      off['packed'] = ('a lane holds an odd number of columns' if vec % 2
                       else 'no narrow stage is a register row of the region')
  elif layout is not None:
    asks = ('chunk',)
  by_name = {s.name: s for s in order}
  values = (value_stages(stencil, order, spans) if 'values' in elements
            else ())
  if members:  # a register stage of the shared stages only
    values = tuple(v for v in values if v not in members and not any(
        v in by_name[m].load_offsets for m in members))
  kernel = [s for s in order if s.name not in values and
            s.name not in members]
  names = [n for n in spans if n not in values]
  if region is None:
    vec = (vector_width(stencil, shape, tile, names) if 'vector' in elements
           else 1)

  def itemsize(name):
    return stencil.tensors[name].dtype.np_dtype.itemsize

  def align(name):  # an input's fill copies 16 bytes
    return (VECTOR_BYTES // itemsize(name) if vec > 1 and
            name in stencil.input_names else vec)

  frames = {n: (_round_up(spans[n][0][last], align(n)),
                _round_up(tile[last] + spans[n][1][last], align(n)))
            for n in names}
  # the sequences liveness and barriers see: the kernel stages, and at
  # the region's place its buffered exits' writes and its entries' read
  # (for liveness the writes first, so that no exit takes an entry's
  # bytes; for barriers the read first: the region reads and writes in
  # one barrier interval)
  index = {s.name: k for k, s in enumerate(order)}
  sequence: List[object] = list(kernel)
  hazards: List[object] = list(kernel)
  places = [index[s.name] for s in kernel]
  if members:
    wider = {p for s in kernel for p in s.load_offsets if p in members}
    entries = sorted({p for m in members for p in by_name[m].load_offsets
                      if p not in members})
    first = index[members[0]]
    place = sum(1 for k in places if k < first)
    writes = [_Step(e) for e in region.exits if e in wider]
    sequence[place:place] = writes + [_Step('<region>', entries)]
    hazards[place:place] = [_Step('<region>', entries)] + writes
    places[place:place] = [first] * (len(writes) + 1)

  def reads(stage):
    if isinstance(stage, _Step):
      return stage.reads
    return buffer_reads(stage, by_name, values)

  readers = {p for s in sequence for p in reads(s)}
  slack = {n: [0, 0] for n in names if n in readers}
  for stage in kernel:
    a, b = frames[stage.name]
    for (parent, _), (lo, hi) in register_rows(stencil, stage, by_name,
                                               values, vec).items():
      pa, pb = frames[parent]
      slack[parent][0] = max(slack[parent][0],
                             _round_up(a - lo - pa, align(parent)))
      slack[parent][1] = max(slack[parent][1], b - vec + hi - pb)
  walk = 'walk' in elements and len(shape) >= 2
  depth = config.prefetch if walk else 2
  # axis-0 rows of each extent (a 1-D grid's one row is its frame)
  tile0 = tile[0] if last else 1
  ext0 = {n: tile[0] + spans[n][0][0] + spans[n][1][0] if last else 1
          for n in names}
  rings = {n: ext0[n] + ((depth - 1) * min(tile0, ext0[n]) if walk and
                         n in stencil.input_names else 0) for n in slack}

  def cross(name):  # cells of one axis-0 row of the frame
    return _prod(t + n + p for t, n, p in zip(tile[1:-1], *(
        x[1:-1] for x in spans[name]))) * sum(frames[name])

  sizes = {}
  for name, (before, after) in slack.items():
    sizes[name] = _round_up((before + rings[name] * cross(name) + after) *
                            itemsize(name), ALIGN)
  if walk:  # every ring lives for the whole run
    starts, peak = {}, 0
    for name in [n for n in stencil.input_names if n in sizes] + [
        s.name for s in sequence if s.name in sizes]:
      starts[name], peak = peak, peak + sizes[name]
  else:
    starts, peak = _allocate(stencil, sequence, spans, tile, sizes=sizes,
                             reads=reads)
  offsets = {n: at + slack[n][0] * itemsize(n) for n, at in starts.items()}
  ranges = {n: (at, at + sizes[n]) for n, at in starts.items()}
  barriers = tuple(sorted({places[k] for k in hazard_barriers(
      stencil, hazards, offsets, spans, tile, ranges, reads, not walk)}))
  staging = {}
  if config.out_dma:
    peak = _round_up(peak, ALIGN)
    for name in stencil.output_names:
      staging[name] = peak
      peak += _round_up(_prod(tile) * itemsize(name), ALIGN)
  ctas = resident_ctas(peak)
  if region is not None:  # registers for the region's words a thread
    ctas = min(ctas, max(1, SM_REGISTERS // (32 * WARPS) // (
        region.regs + REGION_OVERHEAD)))
  grid = [-(-x // t) for x, t in zip(shape, tile)]
  steps = 1
  if walk and config.stream_loop:
    steps = steps_per_cta(grid)
  elif walk:
    waves = SMS * WALK_WAVES * max(ctas, 1)
    steps = min(grid[0], max(1, -(-_prod(grid) // waves)))
  tile_cells = _prod(tile)

  def rows(name):  # axis-0 rows a step computes or fills, over a run
    fresh = walk_rows(stencil, name, tile0, spans) if walk else ext0[name]
    return (ext0[name] + (steps - 1) * fresh) / steps

  evaluations = sum(rows(s.name) * cross(s.name) *
                    (1 + len(value_closure(s, by_name, values)))
                    for s in kernel) / tile_cells
  if region is not None:  # each array at its rows, in every window
    strips = max(rows(e) for e in region.exits) / region.strip
    mids = _prod(max(t + spans[e][0][a] + spans[e][1][a]
                     for e in region.exits)
                 for a, t in enumerate(tile[1:-1], 1))
    width = region.windows * region.lanes * region.cells
    evaluations += strips * mids * width * sum(
        region.rows(m) * (1 + len(value_closure(by_name[m], by_name,
                                                region.inline)))
        for m in region.arrays) / tile_cells
  fills = sum(rows(n) * cross(n) for n in stencil.input_names
              if n in offsets) / tile_cells
  box_spans = dict(spans)
  for name in stencil.input_names:
    if name in frames:
      neg, pos = spans[name]
      a, b = frames[name]
      box_spans[name] = (neg[:-1] + (a,), pos[:-1] + (b - tile[last],))
  if 'vector' in elements and vec == 1:
    off['vector'] = ('a row or the tile\'s minor extent is not whole 16-byte '
                     'units')
  short = ShortForm(
      elements=tuple(asked), vec=vec, values=values, frames=frames,
      slack={n: tuple(v) for n, v in slack.items()}, barriers=barriers,
      ctas=ctas, evaluations=evaluations, fills=fills,
      interior=_interior_box(stencil, shape, tile, box_spans, margins,
                             offsets), rings=rings, depth=depth, off=off,
      layout=asks, region=region)
  return TilePlan(stencil=stencil, shape=tuple(shape), tile=tuple(tile),
                  stages=tuple(order), spans=spans, offsets=offsets,
                  smem_bytes=peak, margins=margins, config=config,
                  steps=steps, slots=depth if config.stream_loop else 1,
                  staging=staging, short=short)


def walk_rows(stencil, name: str, tile0: int, spans: Dict[str, Span]) -> int:
  """Axis-0 rows of ``name``'s extent that a step of the walk after a
  run's first computes or fills: those it does not share with the step
  before (the last ``tile0``), and for an output also its tile's rows
  that the step before computed but did not own (an output another
  stage reads below its own row: each step stores its whole tile)."""
  neg, pos = spans[name][0][0], spans[name][1][0]
  ext0 = tile0 + neg + pos
  if name in stencil.output_names:
    return ext0 - neg
  return min(tile0, ext0)


def _short_tile(stencil, shape, order, spans, margins, elements,
                config: KernelConfig = KernelConfig(),
                fixed: Optional[Dict[int, int]] = None) -> TilePlan:
  """The short form's plan at its tile (``fixed`` axes imposed: the
  public ``block_rows`` and ``mid_tile``). With 'tile': among
  ``short_tiles`` that keep the fixed extents and whose plan fits, the
  fewest stage evaluations and input cells filled an output, with at
  least 2 resident CTAs (1 under 'walk', whose next tile's fill overlaps
  a tile's stages as a second CTA's would), ties to more CTAs, then the
  narrower cross-section. Swept on an H100 (python -m
  soda_tpu_torch.tile_sweep --short; PERF.md): within 0-10% of each
  cell's fastest tile (sobel2d 9.6%, the others 0-6%). Without 'tile',
  or where no such tile fits: the default form's tile (the largest
  candidate, fixed axes imposed, whose default-form buffers fit;
  utils.InputError where none does), or the next smaller candidate where
  the form's frames, slack, rings and staging push it past SMEM_LIMIT;
  utils.InputError where no candidate fits."""
  fixed = fixed or {}
  if 'tile' in elements:
    ranked = _short_ranked(stencil, shape, order, spans, margins, elements,
                           config, fixed)
    if ranked:
      return ranked[0]
  base = _default_plan(stencil, shape, order, spans, margins, KernelConfig(),
                       fixed).tile
  cands = [t for t in (_fixed_candidates(shape, fixed) if fixed else
                       candidate_tiles(shape)) if _prod(t) <= _prod(base)]
  for tile in [base] + cands[::-1]:
    tp = _short_plan(stencil, shape, order, spans, margins, elements, tile,
                     config)
    if tp.smem_bytes <= SMEM_LIMIT:
      return tp
  raise utils.InputError(
      'the short form needs %d bytes of shared memory even at tile %s, '
      'more than the %d a block may use' % (tp.smem_bytes, tp.tile,
                                            SMEM_LIMIT))


def _short_ranked(stencil, shape, order, spans, margins, elements,
                  config: KernelConfig, fixed: Dict[int, int]
                  ) -> List[TilePlan]:
  """The plans at ``short_tiles`` that keep the ``fixed`` extents, fit
  and leave the resident CTAs _short_tile asks, best first by its key."""
  walk = 'walk' in elements and len(shape) >= 2
  ranked = []
  for tile in short_tiles(shape, walk):
    if any(tile[a] != v for a, v in fixed.items()):
      continue
    tp = _short_plan(stencil, shape, order, spans, margins, elements, tile,
                     config)
    if tp.smem_bytes > SMEM_LIMIT or tp.short.ctas < (1 if walk else 2):
      continue
    ranked.append(((tp.short.evaluations + tp.short.fills, -tp.short.ctas,
                    _prod(tile[1:])), tp))
  return [tp for _, tp in sorted(ranked, key=lambda kv: kv[0])]


def short_tile_order(stencil, shape: Sequence[int]) -> List[Tuple[int, ...]]:
  """The tiles of ``short_tiles`` at which the short form of the grid's
  default elements fits, best first by _short_tile's key (the first is
  the tile its rule picks): the tuner's next tiles."""
  _, spans, order, margins = _geometry(stencil)
  return [tp.tile for tp in _short_ranked(
      stencil, tuple(shape), order, spans, margins,
      short_default(len(shape)), KernelConfig(), {})]


def short_default(dim: int) -> Tuple[str, ...]:
  """The short form's elements in a ``dim``-D grid's default kernel."""
  return tuple(e for e in SHORT_ELEMENTS
               if e != 'walk' or dim >= WALK_MIN_DIM)


def short_tiles(shape: Sequence[int], walk: bool) -> List[Tuple[int, ...]]:
  """The tiles the short form's tile rule (and ``tile_sweep --short``)
  weighs: without 'walk' powers of two of 2,048 to 16,384 output cells,
  64 to 256 wide (2-D: 4 to 256 rows; 3-D: 4 to 32 rows of the middle
  axis, the minor axis 128 or 256); with it steps of 4 to 32 rows, 128
  or 256 wide (2-D), or of 1 to 4 planes over cross-sections of 8 to 32
  rows, 128 or 256 wide (3-D); each within the grid."""
  caps = [_pow2_ceil(s) for s in shape]
  if len(shape) == 2:
    out = ([(t0, m) for m in (128, 256) for t0 in (4, 8, 16, 32)] if walk
           else [(t0, m) for m in (64, 128, 256)
                 for t0 in (4, 8, 16, 32, 64, 128, 256)
                 if 2048 <= t0 * m <= 16384])
  elif len(shape) == 3:
    out = ([(t0, mid, m) for m in (128, 256) for mid in (8, 16, 32)
            for t0 in (1, 2, 4)] if walk else
           [(t0, mid, m) for m in (128, 256) for mid in (4, 8, 16, 32)
            for t0 in (1, 2, 4, 8, 16) if 2048 <= t0 * mid * m <= 16384])
  else:
    out = []
  return [t for t in out if all(x <= c for x, c in zip(t, caps))]


def short_elements(elements) -> Tuple[str, ...]:
  """Validate a private ``_short`` argument: SHORT_ELEMENTS names with
  'cells' among them, in SHORT_ELEMENTS order."""
  names = set(elements)
  if not names <= set(SHORT_ELEMENTS) or 'cells' not in names:
    raise ValueError('the short form takes %s, with cells; got %s' % (
        SHORT_ELEMENTS, sorted(names)))
  return tuple(e for e in SHORT_ELEMENTS if e in names)


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


def _default_plan(stencil, shape, order, spans, margins, config, fixed
                  ) -> TilePlan:
  """The largest candidate tile (``fixed`` axes imposed) whose buffers
  fit SMEM_LIMIT; raises utils.InputError where not even a one-cell tile
  does."""
  chosen = tp = None
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


def _geometry(stencil, fusion: Optional[FusionPlan] = None):
  """(live stages, spans, stage order, margins) of a stencil's plans."""
  stages = _live_stages(stencil, (fusion or make_plan(stencil,
                                                      'full')).stages)
  return (stages, _spans(stencil, stages), _dfs_order(stencil, stages),
          _array_margins(stencil))


def make_tile_plan(stencil, shape: Sequence[int],
                   tile: Optional[Sequence[int]] = None,
                   config: Optional[KernelConfig] = None,
                   block_rows: Optional[int] = None,
                   mid_tile: Optional[int] = None,
                   fusion: Optional[FusionPlan] = None,
                   _deep: Optional[Sequence[str]] = None,
                   _short: Optional[Sequence[str]] = None) -> TilePlan:
  """Plan the fused kernel for ``shape``; ``tile=None`` picks the tile.
  ``block_rows`` and ``mid_tile`` fix the tile's axis-0 and axis-1
  extents (the JAX kernel's names). ``fusion`` is the stencil's
  ``make_plan(stencil, 'full')``, built when None.

  With no tile, block_rows, mid_tile, mode or layout key, a stage graph
  of DEEP_MIN_STAGES or more takes the many-stage form (DeepForm, the
  elements of DEEP_DEFAULT), a smaller one the short form (ShortForm,
  the elements of short_default). Any graph given a tile, block_rows,
  mid_tile, mode or layout key takes the short form with short_default's
  elements: at ``tile``, or at the tile its rule picks among those
  keeping the fixed extents, with the modes as _short_plan carries them
  ('walk' on under ``stream_loop``) and a layout key's element on it
  (ShortForm.layout: the value-mode region, region_plan; where the
  rule's tile holds none, utils.InputError naming the keys).

  ``_deep`` and ``_short`` are private, for the tests and chip_smoke.py
  that measure the forms element by element and against the form they
  replaced: ``_short=()``, and ``_deep=()`` at a many-stage graph or
  with a key, keep the default form (with the same keys: the kernels
  the public keys built before the short form took them), a set of
  DEEP_ELEMENTS (deep_elements) or SHORT_ELEMENTS (short_elements)
  forces that form with those on, at ``tile`` where one is given (the
  short form without 'tile': else at the default form's tile).

  Raises utils.InputError when the grid is too small for the stencil
  window, or when even a one-cell tile needs more shared memory than a
  block may have (the stage graph is then too wide for this kernel).
  """
  shape = tuple(int(s) for s in shape)
  validate_grid(stencil, shape)
  if len(shape) < 1:
    raise utils.InputError('the fused kernel needs a grid of at least 1-D')
  config = config or KernelConfig()
  stages, spans, order, margins = _geometry(stencil, fusion)
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
  default = tile is None and not fixed and config.is_default
  # an explicit ``_deep=()`` keeps the form the same keys built before the
  # short form took the public keys: the default form at a many-stage
  # graph, and at any graph given a key
  kept = _deep is not None and not _deep
  if _deep is None:
    _deep = DEEP_DEFAULT if (default and not _short and
                             len(stages) >= DEEP_MIN_STAGES) else ()
  if _short is None:
    _short = short_default(len(shape)) if (
        not _deep and not (kept and (
            not default or len(stages) >= DEEP_MIN_STAGES))) else ()
  if _deep and _short:
    raise ValueError('a plan takes the many-stage or the short form, not '
                     'both')
  if _deep and (fixed or not config.is_default):
    raise utils.InputError('the many-stage form takes no block_rows, '
                           'mid_tile, mode or layout key')
  if _deep:
    elements = deep_elements(_deep)
    tp = _deep_plan(stencil, shape, order, spans, margins, elements, tile)
    if tp.smem_bytes > SMEM_LIMIT:
      raise utils.InputError(
          'the many-stage form needs %d bytes of shared memory at tile %s, '
          'more than the %d a block may use' % (tp.smem_bytes, tp.tile,
                                                SMEM_LIMIT))
    return tp
  if _short:
    elements = short_elements(tuple(_short) + (
        ('walk',) if config.stream_loop else ()))
    if tile is not None:
      tp = _short_plan(stencil, shape, order, spans, margins, elements, tile,
                       config)
      # past shared memory, the elements the keys do not ask for go off
      # in turn: the default's walk (its rings), then 16-byte units (their
      # frames and slack)
      drop: Dict[str, str] = {}
      for element in ('walk', 'vector'):
        if tp.smem_bytes <= SMEM_LIMIT or not tp.short.has(element) or (
            element == 'walk' and config.stream_loop):
          continue
        drop[element] = ('the plan needs %d bytes of shared memory at this '
                         'tile with it' % tp.smem_bytes)
        tp = _short_plan(stencil, shape, order, spans, margins, elements,
                         tile, config, drop)
      if tp.smem_bytes > SMEM_LIMIT:
        raise utils.InputError(
            'the short form needs %d bytes of shared memory at tile %s, '
            'more than the %d a block may use' % (tp.smem_bytes, tile,
                                                  SMEM_LIMIT))
      return tp
    tp = _short_tile(stencil, shape, order, spans, margins, elements,
                     config, fixed)
    if 'region' in tp.short.off:
      raise utils.InputError(
          'the layout keys %s: no short-form tile holds a value-mode region '
          '(%s)' % (config.layout.name, '; '.join(
              '%s: %s' % kv for kv in sorted(
                  region_plan(stencil, order, spans, tp.tile, config.layout,
                              tp.short.vec)[1].items()))))
    return tp
  if tile is not None:
    tp = _plan_for_tile(stencil, shape, tile, order, spans, margins, config)
    if not config.is_default and tp.smem_bytes > SMEM_LIMIT:
      raise utils.InputError(
          'tile %s with %s needs %d bytes of shared memory, more than the '
          '%d a block may use' % (tile, config, tp.smem_bytes, SMEM_LIMIT))
    return tp
  return _default_plan(stencil, shape, order, spans, margins, config, fixed)


def kernel_plan(stencil, shape: Sequence[int],
                tile: Optional[Sequence[int]] = None,
                block_rows: Optional[int] = None,
                mid_tile: Optional[int] = None, stream_loop=False,
                prefetch: int = 2, dma_split: int = 1, out_dma: bool = False,
                _deep: Optional[Sequence[str]] = None,
                _short: Optional[Sequence[str]] = None, **layout) -> TilePlan:
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
                        fusion, _deep, _short)
