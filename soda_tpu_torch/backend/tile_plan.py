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

Span = Tuple[Tuple[int, ...], Tuple[int, ...]]  # (neg, pos) per axis


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
  """
  stencil: object
  shape: Tuple[int, ...]
  tile: Tuple[int, ...]
  stages: Tuple[Stage, ...]
  spans: Dict[str, Span]
  offsets: Dict[str, int]
  smem_bytes: int
  margins: Dict[str, Span]

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
              tile: Sequence[int]) -> Tuple[Dict[str, int], int]:
  """First-fit shared-memory offsets with liveness reuse.

  Inputs are loaded before the first stage and live until their last
  reader. A stage buffer is allocated before the stage runs and freed
  after its last reader (never during its own reads: a barrier
  separates consecutive stages, so the next stage may reuse it).
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
    if name in readers:
      alloc(name)
  for idx, stage in enumerate(order):
    if stage.name in readers:
      alloc(stage.name)
    for parent in sorted(stage.load_offsets):
      if readers.get(parent) == idx:
        live.pop(parent, None)
  return offsets, peak


def _plan_for_tile(stencil, shape, tile, order, spans, margins
                   ) -> TilePlan:
  offsets, peak = _allocate(stencil, order, spans, tile)
  return TilePlan(stencil=stencil, shape=tuple(shape), tile=tuple(tile),
                  stages=tuple(order), spans=spans, offsets=offsets,
                  smem_bytes=peak, margins=margins)


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


def make_tile_plan(stencil, shape: Sequence[int],
                   tile: Optional[Sequence[int]] = None) -> TilePlan:
  """Plan the fused kernel for ``shape``; ``tile=None`` picks the
  largest candidate tile whose buffers fit SMEM_LIMIT.

  Raises utils.InputError when the grid is too small for the stencil
  window, or when even a one-cell tile needs more shared memory than a
  block may have (the stage graph is then too wide for this kernel).
  """
  shape = tuple(int(s) for s in shape)
  validate_grid(stencil, shape)
  if len(shape) < 1:
    raise utils.InputError('the fused kernel needs a grid of at least 1-D')
  plan = make_plan(stencil, 'full')
  stages = _live_stages(stencil, plan.stages)
  spans = _spans(stencil, stages)
  order = _dfs_order(stencil, stages)
  margins = _array_margins(stencil)
  if tile is not None:
    tile = tuple(int(t) for t in tile)
    if len(tile) != len(shape) or min(tile) < 1:
      raise utils.InputError('tile %s does not match the %d-D grid' %
                             (tile, len(shape)))
    return _plan_for_tile(stencil, shape, tile, order, spans, margins)
  chosen = None
  for cand in candidate_tiles(shape):
    tp = _plan_for_tile(stencil, shape, cand, order, spans, margins)
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
