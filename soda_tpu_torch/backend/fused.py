"""The fused stencil executor: one generated CUDA kernel per stencil.

The counterpart of ``PallasExecutor`` (soda_tpu/backend/pallas_kernel.py
:287-1603) and ``_prepare_args`` (:1652-1674). Same contract: arrays in
reversed DSL-dimension order (streaming axis first), outputs defined on
each output's valid region (cells outside it are unspecified),
``border: preserve`` applied afterwards.

``fused_stencil_plain`` is the kernel's plain PyTorch version. It walks
the kernel's tiles (or, with ``tile=None``, treats the whole grid as one
tile), evaluates each stage with the torch Evaluator over shifted
slices in the kernel's stage order, and stores the same valid regions.
``streamed_stencil_plain`` is the mode kernels' (the streaming walk),
``layout_stencil_plain`` the layout forms' (warp windows, rolls,
transposes, narrow stages, chunks). ``FusedExecutor`` takes them only
for tensors on the CPU; on a CUDA device it launches the kernel or
raises. The default and streamed walks build every window, stage value
and output out of place, so they compose with ``torch.func.vmap`` (the
whole-grid executor runs ``fused_stencil_plain``).

With ``replicas=R`` the executor runs R independent grids per call,
stacked on a leading axis, in one launch (the kernel's second grid
axis); the plain version is ``fused_stencil_plain`` mapped over them.
Params are shared by all replicas.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.backend import c_semantics as oracle
from soda_tpu_torch.ir import nodes as ir

from soda_tpu_torch.backend import cuda_source, semantics
from soda_tpu_torch.backend.border import preserve_border_fixup
from soda_tpu_torch.core.stencil import Stencil
from soda_tpu_torch.backend.tile_plan import (TilePlan, kernel_plan,
                                               last_readers, make_tile_plan)


def _box(plan: TilePlan, name: str, origin: Sequence[int]
         ) -> Optional[Tuple[slice, ...]]:
  """Local slices of ``name``'s buffer around the tile at ``origin``
  where its cells are valid, or None when no cell is."""
  ext = plan.extent(name)
  neg = plan.spans[name][0]
  lo, hi = plan.margins[name]
  box = []
  for a in range(plan.dim):
    base = origin[a] - neg[a]
    start = max(lo[a] - base, 0)
    stop = min(plan.shape[a] - hi[a] - base, ext[a])
    if start >= stop:
      return None
    box.append(slice(start, stop))
  return tuple(box)


def _pad(value: torch.Tensor, pads: Sequence[Tuple[int, int]]
         ) -> torch.Tensor:
  """``value`` with ``pads[a]`` zero cells before and after it on each
  axis ``a``: a new tensor, built out of place (composes with
  ``torch.func.vmap``)."""
  return torch.constant_pad_nd(
      value, [n for before_after in reversed(pads) for n in before_after])


def _window(plan: TilePlan, name: str, origin: Sequence[int],
            inputs: Dict[str, torch.Tensor],
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
  """Rows ``rows`` (axis-0 window rows; default all) of ``name``'s
  window around the tile at ``origin``, zero outside the array."""
  ext = list(plan.extent(name))
  neg = plan.spans[name][0]
  first = 0
  if rows is not None:
    first, ext[0] = rows[0], rows[1] - rows[0]
  src, pads = [], []
  for a in range(plan.dim):
    base = origin[a] - neg[a] + (first if a == 0 else 0)
    g0 = max(base, 0)
    g1 = max(g0, min(base + ext[a], plan.shape[a]))
    before = min(g0 - base, ext[a])
    src.append(slice(g0, g1))
    pads.append((before, ext[a] - before - (g1 - g0)))
  return _pad(inputs[name][tuple(src)], pads)


def _chunks(box: Tuple[slice, ...], chunk: Optional[int]
            ) -> List[Tuple[slice, ...]]:
  """``box`` cut on axis 0 at the multiples of ``chunk`` (the layout
  form L4's stage loops), or ``[box]``."""
  if chunk is None:
    return [box]
  out = []
  for z in range(box[0].start - box[0].start % chunk, box[0].stop, chunk):
    rows = slice(max(z, box[0].start), min(z + chunk, box[0].stop))
    out.append((rows,) + tuple(box[1:]))
  return out


def _run_tile(plan: TilePlan, origin: Sequence[int],
              inputs: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
              readers: Dict[str, int], device: torch.device,
              windows: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
  """Evaluate every stage over the tile at ``origin``; returns each
  output's block: the tile's cells inside the array, zero outside the
  output's valid region. Input windows are loaded here unless
  ``windows`` gives them. Under ``compute_chunk`` each stage is
  evaluated chunk by chunk, as the kernel's stage loops walk it. Every
  value is built out of place (``_pad``, ``torch.cat``)."""
  chunk = plan.layout.compute_chunk if plan.layout is not None else None
  stencil = plan.stencil
  dim = plan.dim
  tile_ext = [min(t, n - o) for t, n, o in zip(plan.tile, plan.shape, origin)]

  bufs: Dict[str, torch.Tensor] = {}
  for name in stencil.input_names:
    if name in readers:
      bufs[name] = (windows[name] if windows is not None else
                    _window(plan, name, origin, inputs))

  blocks: Dict[str, torch.Tensor] = {}
  for idx, stage in enumerate(plan.stages):
    name = stage.name
    neg = plan.spans[name][0]
    ext = plan.extent(name)
    dtype = semantics.repr_dtype(stage.dtype)
    box = _box(plan, name, origin)
    parts = []
    for part in (_chunks(box, chunk) if box is not None else ()):
      st_idx = stage.tensor.st_idx

      def load(ref: ir.Ref, _box=part, _neg=neg, _st=st_idx):
        if ref.name in stencil.param_names:
          return params[ref.name][tuple(ref.idx)]
        pneg = plan.spans[ref.name][0]
        delta = tuple(reversed([i - s for i, s in zip(ref.idx, _st)]))
        shift = [delta[a] + pneg[a] - _neg[a] for a in range(dim)]
        return bufs[ref.name][tuple(
            slice(_box[a].start + shift[a], _box[a].stop + shift[a])
            for a in range(dim))]

      def param(pname, pidx):
        return params[pname][pidx]

      ev = semantics.Evaluator(load, param=param, device=device)
      v, vt = ev.eval_stmt(stage.tensor)
      v = semantics.wrap(v, stage.dtype, vt, device).to(dtype)
      shape = [s.stop - s.start for s in part]
      parts.append(v if list(v.shape) == shape else v.expand(shape))
    if box is None:
      value = torch.zeros(ext, dtype=dtype, device=device)
    else:
      value = parts[0] if len(parts) == 1 else torch.cat(parts)
      pads = [(s.start, e - s.stop) for s, e in zip(box, ext)]
      if any(n for before_after in pads for n in before_after):
        value = _pad(value, pads)
    if name in readers:
      bufs[name] = value
    if name in stencil.output_names:
      blocks[name] = value[tuple(slice(n, n + t)
                                 for n, t in zip(neg, tile_ext))]
    for parent in stage.load_offsets:
      if readers.get(parent) == idx:
        bufs.pop(parent, None)
  return blocks


def _join(plan: TilePlan, tiles: Dict[Tuple[int, ...], Dict[str, torch.Tensor]],
          name: str, prefix: Tuple[int, ...] = ()) -> torch.Tensor:
  """Output ``name`` over the tiles whose grid index starts with
  ``prefix``: their blocks concatenated along the next axis."""
  axis = len(prefix)
  return torch.cat([tiles[prefix + (i,)][name] if axis == plan.dim - 1
                    else _join(plan, tiles, name, prefix + (i,))
                    for i in range(plan.grid[axis])], dim=axis)


def _assemble(plan: TilePlan, tiles: Dict[Tuple[int, ...],
                                          Dict[str, torch.Tensor]]
              ) -> Dict[str, torch.Tensor]:
  """Each output over the whole grid from its tiles' blocks (``tiles``
  maps a tile's grid index to ``_run_tile``'s result): a ``torch.cat``
  of the blocks along each axis, or a contiguous copy of a lone tile's
  block; a new tensor either way. (No nested function: a recursive
  closure is a reference cycle that would hold every block until the
  garbage collector runs.)"""
  outs = {}
  for name in plan.stencil.output_names:
    if len(tiles) == 1:
      (blocks,) = tiles.values()
      whole = blocks[name].clone(memory_format=torch.contiguous_format)
    else:
      whole = _join(plan, tiles, name)
    outs[name] = whole.to(semantics.repr_dtype(plan.stencil.symbol_table[name]))
  return outs


def fused_stencil_plain(stencil, inputs: Sequence[torch.Tensor],
                        params: Sequence[torch.Tensor] = (),
                        tile: Optional[TilePlan] = None
                        ) -> Tuple[torch.Tensor, ...]:
  """The fused kernel's function in plain PyTorch.

  Args:
    stencil: the core.Stencil.
    inputs: storage tensors, in ``stencil.input_names`` order.
    params: storage tensors, in ``stencil.param_names`` order.
    tile: a TilePlan to walk tile by tile (the kernel's geometry), or
      None to treat the whole grid as one tile.

  Returns the outputs (storage tensors), zero outside each valid region.
  """
  shape = tuple(inputs[0].shape)
  plan = tile if tile is not None else make_tile_plan(stencil, shape, shape)
  device = inputs[0].device
  ins, pars = _repr_args(stencil, inputs, params)
  readers = last_readers(plan.stages)
  tiles = {}
  for index in np.ndindex(*plan.grid):
    origin = tuple(int(i) * t for i, t in zip(index, plan.tile))
    tiles[index] = _run_tile(plan, origin, ins, pars, readers, device)
  outs = _assemble(plan, tiles)
  return tuple(semantics.to_storage(outs[n], stencil.symbol_table[n])
               for n in stencil.output_names)


def _check_steady(plan: TilePlan, origin: Sequence[int]) -> None:
  """A step of the steady range runs without axis-0 bounds checks on
  the card: every window row must lie in the array and every stage box
  must cover its whole extent on axis 0."""
  for name in plan.stencil.input_names:
    if plan.buffered(name):
      top = origin[0] - plan.spans[name][0][0]
      if top < 0 or top + plan.extent(name)[0] > plan.shape[0]:
        raise utils.InternalError('steady step at %s reads %s outside the '
                                  'array' % (origin, name))
  for stage in plan.stages:
    base = origin[0] - plan.spans[stage.name][0][0]
    lo, hi = plan.margins[stage.name]
    if lo[0] > base or base + plan.extent(stage.name)[0] > plan.shape[0] - hi[0]:
      raise utils.InternalError('steady step at %s clips stage %s on axis 0'
                                % (origin, stage.name))


def _stream_walk(plan: TilePlan, ins: Dict[str, torch.Tensor]
                 ) -> Iterator[Tuple[Tuple[int, ...], Dict[str, torch.Tensor]]]:
  """(origin, input windows) of every step of the mode kernels' walk:
  per CTA (a tile column on the axes after the first, and a run of
  ``plan.steps`` consecutive axis-0 tiles), one input window per input
  kept from step to step. With ``plan.rolling`` a run's first step
  loads the whole window ('full') and every later step keeps the
  ``halo0`` rows it shares with the previous window and loads only the
  ``tile[0]`` new rows ('mid', or 'tail' where they run past the
  array's end: TilePlan.fill_class). Under 'peel' the steps the kernel
  runs without axis-0 bounds checks are checked here to need none."""
  readers = last_readers(plan.stages)
  buffered = [n for n in plan.stencil.input_names if n in readers]
  t0 = plan.tile[0]
  k_lo, k_hi = plan.steady
  for column in np.ndindex(*plan.grid[1:]):
    rest = tuple(int(i) * t for i, t in zip(column, plan.tile[1:]))
    for chunk in range(plan.n_chunks):
      first = chunk * plan.steps
      last = min(first + plan.steps, plan.grid[0])
      windows: Dict[str, torch.Tensor] = {}
      for k in range(first, last):
        origin = (k * t0,) + rest
        for name in buffered:
          if plan.fill_class(name, k, first) == 'full':
            windows[name] = _window(plan, name, origin, ins)
            continue
          halo = plan.halo0(name)
          new = _window(plan, name, origin, ins,
                        rows=(halo, plan.extent(name)[0]))
          windows[name] = torch.cat([windows[name][t0:t0 + halo], new])
        if plan.peel and first < k < last - 1 and k_lo <= k <= k_hi:
          _check_steady(plan, origin)
        yield origin, windows


def _grid_index(plan: TilePlan, origin: Sequence[int]) -> Tuple[int, ...]:
  return tuple(o // t for o, t in zip(origin, plan.tile))


def _repr_args(stencil, inputs, params):
  ins = {name: semantics.to_repr(t, stencil.symbol_table[name])
         for name, t in zip(stencil.input_names, inputs)}
  pars = {stmt.name: semantics.to_repr(t, stmt.dtype)
          for stmt, t in zip(stencil.param_stmts, params)}
  return ins, pars


def _zero_outputs(stencil, shape, device) -> Dict[str, torch.Tensor]:
  return {name: torch.zeros(shape, device=device, dtype=semantics.repr_dtype(
      stencil.symbol_table[name])) for name in stencil.output_names}


def streamed_stencil_plain(stencil, inputs: Sequence[torch.Tensor],
                           params: Sequence[torch.Tensor] = (),
                           tile: Optional[TilePlan] = None
                           ) -> Tuple[torch.Tensor, ...]:
  """The mode kernels' function in plain PyTorch, walked as they walk
  it (``_stream_walk``: runs of axis-0 tiles per CTA, rolling windows,
  the steady steps checked).

  Args and result as fused_stencil_plain's; ``tile`` is a mode plan
  (make_tile_plan with a KernelConfig).
  """
  plan = tile
  if plan is None:
    raise ValueError('streamed_stencil_plain walks a tile plan; pass one')
  device = inputs[0].device
  ins, pars = _repr_args(stencil, inputs, params)
  readers = last_readers(plan.stages)
  tiles = {_grid_index(plan, origin): _run_tile(plan, origin, ins, pars,
                                                readers, device, windows)
           for origin, windows in _stream_walk(plan, ins)}
  outs = _assemble(plan, tiles)
  return tuple(semantics.to_storage(outs[n], stencil.symbol_table[n])
               for n in stencil.output_names)


# warp-window cells a batch of the value forms' plain version holds per
# tensor (bounds its memory at the benchmark shapes)
_BATCH_CELLS = 1 << 24


def _tile_windows(plan: TilePlan, ins: Dict[str, torch.Tensor]
                  ) -> Iterator[Tuple[Tuple[int, ...], Dict[str, torch.Tensor]]]:
  """(origin, input windows) of every tile as the kernel fills it: the
  mode kernels' walk under ``stream_loop``, else one window per tile."""
  if plan.config.stream_loop:
    for origin, windows in _stream_walk(plan, ins):
      yield origin, dict(windows)
    return
  readers = last_readers(plan.stages)
  for index in np.ndindex(*plan.grid):
    origin = tuple(int(i) * t for i, t in zip(index, plan.tile))
    yield origin, {name: _window(plan, name, origin, ins)
                   for name in plan.stencil.input_names if name in readers}


def _frame_index(plan: TilePlan, name: str, device: torch.device):
  """Per axis, the local index into ``name``'s tile window of each warp
  block's register cells (blocks x cells), and whether it lies inside
  the window (the kernel loads 0 elsewhere)."""
  warp = plan.warp
  ext = plan.extent(name)
  neg = plan.spans[name][0]
  out = []
  for a in range(plan.dim):
    blocks = torch.arange(warp.grid(plan.tile)[a], device=device)
    if a < plan.dim - 1:
      start, count = warp.rows[name][a]
    else:
      start, count = 0, warp.width
    cells = torch.arange(start, start + count, device=device)
    idx = (blocks[:, None] * warp.block[a] - warp.frame_neg[a] + neg[a] +
           cells[None, :])
    out.append((idx.clamp(0, ext[a] - 1), (idx >= 0) & (idx < ext[a])))
  return out


def _gather_blocks(plan: TilePlan, name: str, windows: torch.Tensor):
  """Stacked tile windows ``[T, *ext]`` -> the warp blocks' register
  windows ``[T * blocks, *rows, width]`` (zero outside the window)."""
  dim = plan.dim
  index = _frame_index(plan, name, windows.device)
  idx, ok = [], None
  for a, (ia, va) in enumerate(index):
    shape = [1] * (2 * dim)
    shape[2 * a], shape[2 * a + 1] = ia.shape
    idx.append(ia.reshape(shape))
    va = va.reshape(shape)
    ok = va if ok is None else ok & va
  got = windows[(slice(None),) + tuple(idx)]
  got = got * ok.to(got.dtype)
  # [T, G0, R0, G1, R1, ...] -> [T, G0, G1, ..., R0, R1, ...]
  perm = [0] + [1 + 2 * a for a in range(dim)] + [2 + 2 * a
                                                  for a in range(dim)]
  got = got.permute(perm)
  return got.reshape((-1,) + tuple(got.shape[1 + dim:]))


def _shift(value: torch.Tensor, axis: int, delta: int, wrap: bool):
  """value[.., i, ..] = src[.., i + delta, ..] along ``axis``: a roll
  (wrap-around) or a slice with zeros past the end."""
  if delta == 0:
    return value
  if wrap:
    return torch.roll(value, -delta, dims=axis)
  out = torch.zeros_like(value)
  n = value.shape[axis]
  if abs(delta) < n:
    src = value.narrow(axis, max(delta, 0), n - abs(delta))
    out.narrow(axis, max(-delta, 0), n - abs(delta)).copy_(src)
  return out


def _warp_stages(plan: TilePlan, nb: int, blocks: Dict[str, torch.Tensor],
                 pars: Dict[str, torch.Tensor], device: torch.device
                 ) -> Dict[str, torch.Tensor]:
  """Every stage over a batch of warp windows, as the value form
  evaluates it: a tensor's registers are ``[blocks, *rows, width]``
  (rows per ``warp.rows``); an axis-0 (or axis-1) tap is a slice of the
  parent's rows (window) or a roll of the full frame (roll); a minor
  tap a roll of the width (rotate) or a slice with the frame's far side
  past its end (slice). A transposed region's stages hold
  ``[blocks, width, 32 x lane_rows]`` (entries transposed in, members'
  minor taps rolls of the register axis, exits transposed back); narrow
  stages are evaluated at 16-bit width. ``nb`` is the batch's number of
  warp windows. Returns the outputs' blocks."""
  stencil, warp, layout = plan.stencil, plan.warp, plan.layout
  dim = plan.dim
  readers = last_readers(plan.stages)
  cells: Dict[str, torch.Tensor] = dict(blocks)  # cells layout
  trans: Dict[str, torch.Tensor] = {}  # transposed layout
  lane_rows = 32 * warp.lane_rows if layout.transposed else 0

  def transpose_in(name):
    if name not in trans:
      start, count = warp.rows[name][0]
      value = cells[name]
      frame = torch.zeros((value.shape[0], lane_rows, value.shape[-1]),
                          dtype=value.dtype, device=device)
      frame[:, start:start + count] = value
      trans[name] = frame.transpose(1, 2)
    return trans[name]

  for idx, stage in enumerate(plan.stages):
    name = stage.name
    st_idx = stage.tensor.st_idx
    member = name in layout.transposed

    def load(ref: ir.Ref, _name=name, _st=st_idx, _member=member):
      if ref.name in stencil.param_names:
        return pars[ref.name][tuple(ref.idx)]
      delta = tuple(reversed([i - s for i, s in zip(ref.idx, _st)]))
      if _member:
        return _shift(transpose_in(ref.name), 1, delta[-1], True)
      value = cells[ref.name]
      for a in range(dim - 1):
        if layout.roll:
          value = _shift(value, 1 + a, delta[a], True)
        else:
          k = delta[a] + warp.rows[_name][a][0] - warp.rows[ref.name][a][0]
          value = value.narrow(1 + a, k, warp.rows[_name][a][1])
      return _shift(value, dim, delta[-1], layout.rotate)

    def param(pname, pidx):
      return pars[pname][pidx]

    ev = semantics.Evaluator(load, param=param, device=device,
                             narrow=name in layout.narrow16)
    v, vt = ev.eval_stmt(stage.tensor)
    v = semantics.wrap(v, stage.dtype, vt, device)
    if v.dim() == 0:  # a constant stage: the same value in every cell
      shape = ((nb, warp.width, lane_rows) if member else
               (nb,) + tuple(c for _, c in warp.rows[name]) + (warp.width,))
      v = v.expand(shape).clone()
    if member:
      trans[name] = v
      start, count = warp.rows[name][0]
      cells[name] = v.transpose(1, 2)[:, start:start + count].contiguous()
    else:
      cells[name] = v
    for parent in stage.load_offsets:
      if readers.get(parent) == idx and parent not in stencil.output_names:
        cells.pop(parent, None)
        trans.pop(parent, None)
  return {n: cells[n] for n in stencil.output_names}


def _store_blocks(plan: TilePlan, origins: Sequence[Tuple[int, ...]],
                  values: Dict[str, torch.Tensor],
                  outs: Dict[str, torch.Tensor]) -> None:
  """Each warp block's own cells of every output, clipped to the tile,
  the array and the output's valid region, into ``outs``."""
  warp = plan.warp
  dim = plan.dim
  device = next(iter(outs.values())).device
  grid = warp.grid(plan.tile)
  for name, value in values.items():
    lo, hi = plan.margins[name]
    sel = [slice(None)]
    for a in range(dim - 1):
      start = warp.frame_neg[a] - warp.rows[name][a][0]
      sel.append(slice(start, start + warp.block[a]))
    sel.append(slice(warp.frame_neg[-1], warp.frame_neg[-1] + warp.block[-1]))
    own = value[tuple(sel)].reshape((len(origins),) + tuple(grid) +
                                    tuple(warp.block))
    coords, ok = [], None
    for a in range(dim):
      tile_local = (torch.arange(grid[a], device=device)[:, None] *
                    warp.block[a] +
                    torch.arange(warp.block[a], device=device)[None, :])
      origin = torch.tensor([o[a] for o in origins], device=device)
      g = origin[:, None, None] + tile_local[None]
      good = (tile_local[None] < plan.tile[a]) & (g >= lo[a]) & \
          (g < plan.shape[a] - hi[a])
      shape = [len(origins)] + [1] * (2 * dim)
      shape[1 + a], shape[1 + dim + a] = grid[a], warp.block[a]
      coords.append(g.reshape(shape))
      good = good.reshape(shape)
      ok = good if ok is None else ok & good
    flat = coords[0]
    for a in range(1, dim):
      flat = flat * plan.shape[a] + coords[a]
    flat = flat.expand(own.shape)
    ok = ok.expand(own.shape)
    outs[name].view(-1)[flat[ok]] = own[ok].to(outs[name].dtype)


def layout_stencil_plain(stencil, inputs: Sequence[torch.Tensor],
                         params: Sequence[torch.Tensor] = (),
                         tile: Optional[TilePlan] = None
                         ) -> Tuple[torch.Tensor, ...]:
  """The layout forms' function in plain PyTorch, walked as they are.

  Value forms (L1-L3, ``tile.warp``): every tile's input windows (the
  mode kernels' walk under ``stream_loop``), cut into the warp blocks'
  register windows, every stage evaluated per window as the kernel
  does (``_warp_stages``: rolls under roll, transposed regions through
  ``.transpose``, narrow stages at 16-bit width), each block's own
  cells stored. Chunked (L4): the tiles' stages evaluated chunk by
  chunk (``_run_tile``). A margin that is one cell short lets a roll's
  wrap-around reach a stored cell, which the tests see.

  Args and result as fused_stencil_plain's; ``tile`` is a plan with a
  layout (kernel_plan with layout keys).
  """
  plan = tile
  if plan is None or plan.layout is None:
    raise ValueError('layout_stencil_plain walks a layout plan; pass one')
  device = inputs[0].device
  ins, pars = _repr_args(stencil, inputs, params)
  readers = last_readers(plan.stages)
  if plan.warp is None:
    outs = _assemble(plan, {
        _grid_index(plan, origin): _run_tile(plan, origin, ins, pars, readers,
                                             device, windows)
        for origin, windows in _tile_windows(plan, ins)})
  else:
    outs = _zero_outputs(stencil, plan.shape, device)
    per_tile = plan.warp.n_blocks(plan.tile) * _prod_rows(plan)
    batch = max(1, _BATCH_CELLS // per_tile)
    origins, stacks = [], {}

    def flush():
      blocks = {name: _gather_blocks(plan, name, torch.stack(ws))
                for name, ws in stacks.items()}
      nb = len(origins) * plan.warp.n_blocks(plan.tile)
      _store_blocks(plan, origins,
                    _warp_stages(plan, nb, blocks, pars, device), outs)
      del origins[:]
      stacks.clear()

    for origin, windows in _tile_windows(plan, ins):
      origins.append(origin)
      for name, w in windows.items():
        stacks.setdefault(name, []).append(w)
      if len(origins) == batch:
        flush()
    if origins:
      flush()
  return tuple(semantics.to_storage(outs[n], stencil.symbol_table[n])
               for n in stencil.output_names)


def _prod_rows(plan: TilePlan) -> int:
  """Register cells of the largest tensor of one warp window."""
  n = plan.warp.width
  for e in plan.warp.window[:-1]:
    n *= e
  return n


def plain_version(plan: Optional[TilePlan]):
  """The plain version of ``plan``'s kernel: ``layout_stencil_plain``
  for a layout form, ``streamed_stencil_plain`` for a mode kernel,
  ``fused_stencil_plain`` for the default kernel."""
  if plan is not None and plan.layout is not None:
    return layout_stencil_plain
  if plan is not None and plan.config.stream_loop:
    return streamed_stencil_plain
  return fused_stencil_plain


def replicated_stencil_plain(stencil, inputs: Sequence[torch.Tensor],
                             params: Sequence[torch.Tensor] = (),
                             tile: Optional[TilePlan] = None
                             ) -> Tuple[torch.Tensor, ...]:
  """The replicated kernel's function in plain PyTorch:
  ``fused_stencil_plain`` mapped over the leading replica axis of
  ``inputs``; params are shared by all replicas."""
  plain = plain_version(tile)
  per = [plain(stencil, [a[r] for a in inputs], params, tile)
         for r in range(inputs[0].shape[0])]
  return tuple(torch.stack(outs) for outs in zip(*per))


def check_stencil(stencil) -> None:
  """Raise TypeError unless ``stencil`` comes from this package's own
  front half: a stencil built by another package (the JAX package's
  ``build_stencil``) is made of other IR classes, which the port's
  printer and evaluator do not recognise."""
  if not isinstance(stencil, Stencil):
    raise TypeError(
        'expected a soda_tpu_torch.core.Stencil, got %s.%s; build it with '
        'soda_tpu_torch.build_stencil (another package\'s stencil has '
        'other IR classes)' % (type(stencil).__module__,
                               type(stencil).__qualname__))


def resolve_device(device) -> torch.device:
  """``device`` checked for the kernel, with the current CUDA index made
  explicit. Raises utils.InputError for 'cuda' without a usable GPU."""
  device = torch.device(device)
  semantics.require_device_support(device)
  if device.type == 'cuda' and device.index is None:
    device = torch.device('cuda', torch.cuda.current_device())
  return device


def prepare_args(stencil, shape: Tuple[int, ...], device: torch.device,
                 inputs: Mapping[str, np.ndarray],
                 params: Optional[Mapping[str, np.ndarray]] = None
                 ) -> Tuple[torch.Tensor, ...]:
  """numpy inputs (each of ``shape``) and params -> storage tensors on
  ``device``, wrapped to the declared types, in ``fn``'s positional
  order."""
  args = []
  for name in stencil.input_names:
    if name not in inputs:
      raise utils.InputError('missing input: %s' % name)
    arr = np.asarray(inputs[name])
    if arr.shape != shape:
      raise utils.InputError('input %s shape %s != compiled shape %s' %
                             (name, arr.shape, shape))
    arr = oracle.wrap(np, arr, stencil.symbol_table[name])
    args.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device))
  params = dict(params or {})
  for stmt in stencil.param_stmts:
    if stmt.name not in params:
      raise utils.InputError('missing param: %s' % stmt.name)
    arr = np.asarray(params[stmt.name])
    if arr.shape != tuple(stmt.size):
      raise utils.InputError('param %s shape %s != declared %s' %
                             (stmt.name, arr.shape, tuple(stmt.size)))
    arr = oracle.wrap(np, arr, stmt.dtype)
    args.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device))
  return tuple(args)


def check_args(stencil, shape: Tuple[int, ...], device: torch.device,
               args: Sequence[torch.Tensor]) -> None:
  """Raise utils.InputError unless ``args`` are ``fn``'s positional
  arguments: contiguous storage tensors on ``device``, inputs of
  ``shape``, params of their declared sizes."""
  n_in, n_par = len(stencil.input_names), len(stencil.param_names)
  if len(args) != n_in + n_par:
    raise utils.InputError('expected %d inputs and %d params, got %d '
                           'arguments' % (n_in, n_par, len(args)))
  types = [stencil.symbol_table[n] for n in stencil.input_names]
  shapes = [shape] * n_in
  for stmt in stencil.param_stmts:
    types.append(stmt.dtype)
    shapes.append(tuple(stmt.size))
  for arg, t, want in zip(args, types, shapes):
    if arg.device != device:
      raise utils.InputError('argument on %s, executor on %s' %
                             (arg.device, device))
    if arg.dtype != semantics.storage_dtype(t):
      raise utils.InputError('argument dtype %s, expected %s' %
                             (arg.dtype, semantics.storage_dtype(t)))
    if tuple(arg.shape) != want or not arg.is_contiguous():
      raise utils.InputError('argument of shape %s (contiguous: %s), '
                             'expected contiguous %s' %
                             (tuple(arg.shape), arg.is_contiguous(), want))


def fix_border(stencil, shape: Tuple[int, ...], args: Sequence[torch.Tensor],
               outs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
  """``border: preserve`` on ``fn``'s outputs (of ``shape``, or a batch
  of grids of ``shape``), from its positional inputs."""
  ins = dict(zip(stencil.input_names, args))
  fixed = preserve_border_fixup(stencil, shape, ins.__getitem__,
                                dict(zip(stencil.output_names, outs)))
  return tuple(fixed[n] for n in stencil.output_names)


class FusedExecutor:
  """Run a stencil as one fused CUDA kernel (or, on the CPU, its plain
  version with the same tile geometry).

  Args:
    stencil: a core.Stencil of this package.
    shape: full array shape (streaming axis first).
    device: 'cuda' (default; raises without a usable GPU) or 'cpu'.
    tile: output tile per CTA (default: the largest that fits shared
      memory, see tile_plan.make_tile_plan).
    replicas: None for one grid of ``shape`` per call, or R (1 to
      cuda_source.MAX_REPLICAS) for a batch of R independent grids,
      inputs and outputs of shape ``(R, *shape)``, in one launch.
    apply_preserve_border: apply ``border: preserve`` after the kernel
      (default). The sharded executor passes False: it crops each
      shard and redoes the border against the global grid.
    stream_loop: False (one CTA per tile), True (one CTA walks a run of
      consecutive axis-0 tiles of one tile column, keeping its input
      windows in shared memory; tile_plan.steps_per_cta sizes the run)
      or 'peel' (the same, with a run's first and last steps bounds
      checked on axis 0 and the steady steps not; at least 4 steps).
    prefetch: input windows in flight, 2-4 (the cp.async ring's depth;
      > 2 needs ``stream_loop``: a CTA without it computes one tile, so
      there is no next step to fetch). Depth 2 with at least 3 steps
      and an axis-0 halo shorter than the tile loads only the new rows
      of each window (the rolling fill).
    dma_split: 1-8, 3-D grids only: each window fill issued as that
      many cp.async commit groups over plane sub-ranges.
    out_dma: stage each output tile in shared memory and store it after
      a barrier with a cooperative, row-contiguous store.
    block_rows, mid_tile: the tile's axis-0 and axis-1 extents, by the
      JAX kernel's names (instead of ``tile``).

  The JAX kernel's layout keys (``stage_mode``, ``shift_mode``,
  ``lane_shift``, ``transpose_lanes``, ``narrow``, ``compute_chunk``)
  select the kernel's layout forms (backend/layout.py), checked and
  resolved by the JAX rules; with none of them the kernel is the
  default one. ``interpret`` raises utils.InputError (``device='cpu'``
  is its counterpart). On the CPU the executor runs
  ``layout_stencil_plain`` whenever a layout key is set,
  ``streamed_stencil_plain`` whenever ``stream_loop`` is, else
  ``fused_stencil_plain`` over the plan's tiles.

  ``launches`` counts kernel launches made by ``fn``.
  """

  def __init__(self, stencil, shape: Sequence[int], device='cuda',
               tile: Optional[Sequence[int]] = None,
               replicas: Optional[int] = None,
               apply_preserve_border: bool = True, **opts):
    check_stencil(stencil)
    self.stencil = stencil
    self.apply_preserve_border = apply_preserve_border
    self.shape = tuple(int(s) for s in shape)
    if replicas is not None and not 1 <= replicas <= cuda_source.MAX_REPLICAS:
      raise utils.InputError('replicas must lie in 1..%d (one launch), got %r'
                             % (cuda_source.MAX_REPLICAS, replicas))
    self.replicas = replicas
    self.batch_shape = self.shape if replicas is None else \
        (replicas,) + self.shape
    self.device = resolve_device(device)
    self.plan = kernel_plan(stencil, self.shape, tile, **opts)
    self.config = self.plan.config
    self.launches = 0
    self.kernel = None
    if self.device.type == 'cuda':
      from soda_tpu_torch.backend.build import CompiledKernel
      n_ptr = (len(stencil.input_names) + len(stencil.param_names) +
               len(stencil.output_names))
      self.kernel = CompiledKernel(cuda_source.generate(self.plan), n_ptr)

  def prepare(self, inputs: Mapping[str, np.ndarray],
              params: Optional[Mapping[str, np.ndarray]] = None
              ) -> Tuple[torch.Tensor, ...]:
    """numpy inputs (of ``batch_shape``) and params -> storage tensors on
    the device, wrapped to the declared types, in ``fn``'s positional
    order."""
    return prepare_args(self.stencil, self.batch_shape, self.device, inputs,
                        params)

  def fn(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Positional ``fn(*inputs, *params) -> (outputs...)`` on prepared
    tensors; asynchronous on CUDA like any torch operation."""
    stencil = self.stencil
    check_args(stencil, self.batch_shape, self.device, args)
    n_in = len(stencil.input_names)
    ins, pars = args[:n_in], args[n_in:]
    if self.device.type == 'cpu':
      plain = (replicated_stencil_plain if self.replicas is not None else
               plain_version(self.plan))
      outs = plain(stencil, ins, pars, tile=self.plan)
    else:
      outs = tuple(
          torch.empty(self.batch_shape, device=self.device,
                      dtype=semantics.storage_dtype(stencil.symbol_table[n]))
          for n in stencil.output_names)
      pointers = [t.data_ptr() for t in (*args, *outs)]
      with torch.cuda.device(self.device):  # restores the caller's device
        stream = torch.cuda.current_stream().cuda_stream
        self.kernel.launch(pointers, self.replicas or 1, stream)
      self.launches += 1
    if stencil.preserve_border and self.apply_preserve_border:
      outs = fix_border(stencil, self.shape, ins, outs)
    return outs

  def __call__(self, inputs: Mapping[str, np.ndarray],
               params: Optional[Mapping[str, np.ndarray]] = None
               ) -> Dict[str, torch.Tensor]:
    outs = self.fn(*self.prepare(inputs, params))
    return dict(zip(self.stencil.output_names, outs))
