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
``FusedExecutor`` takes it only for tensors on the CPU; on a CUDA
device it launches the kernel or raises.

With ``replicas=R`` the executor runs R independent grids per call,
stacked on a leading axis, in one launch (the kernel's second grid
axis); the plain version is ``fused_stencil_plain`` mapped over them.
Params are shared by all replicas.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.backend import c_semantics as oracle
from soda_tpu_torch.ir import nodes as ir

from soda_tpu_torch.backend import cuda_source, semantics
from soda_tpu_torch.backend.border import preserve_border_fixup
from soda_tpu_torch.core.stencil import Stencil
from soda_tpu_torch.backend.tile_plan import (TilePlan, last_readers,
                                               make_tile_plan)


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


def _run_tile(plan: TilePlan, origin: Sequence[int],
              inputs: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
              outs: Dict[str, torch.Tensor], readers: Dict[str, int],
              device: torch.device) -> None:
  stencil = plan.stencil
  dim = plan.dim

  bufs: Dict[str, torch.Tensor] = {}
  for name in stencil.input_names:
    if name not in readers:
      continue
    ext = plan.extent(name)
    neg = plan.spans[name][0]
    buf = torch.zeros(ext, dtype=inputs[name].dtype, device=device)
    src, dst = [], []
    for a in range(dim):
      base = origin[a] - neg[a]
      g0, g1 = max(base, 0), min(base + ext[a], plan.shape[a])
      src.append(slice(g0, max(g0, g1)))
      dst.append(slice(g0 - base, max(g0, g1) - base))
    buf[tuple(dst)] = inputs[name][tuple(src)]
    bufs[name] = buf

  for idx, stage in enumerate(plan.stages):
    name = stage.name
    neg = plan.spans[name][0]
    box = _box(plan, name, origin)
    value = torch.zeros(plan.extent(name),
                        dtype=semantics.repr_dtype(stage.dtype),
                        device=device)
    if box is not None:
      st_idx = stage.tensor.st_idx

      def load(ref: ir.Ref, _box=box, _neg=neg, _st=st_idx):
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
      v = semantics.wrap(v, stage.dtype, vt, device)
      value[box] = v
    if name in readers:
      bufs[name] = value
    if name in outs and box is not None:
      tile_box = []
      for a in range(dim):
        start = max(box[a].start, neg[a])
        stop = min(box[a].stop, neg[a] + plan.tile[a])
        tile_box.append(slice(start, stop))
      if all(s.start < s.stop for s in tile_box):
        glob = tuple(slice(origin[a] - neg[a] + s.start,
                           origin[a] - neg[a] + s.stop)
                     for a, s in enumerate(tile_box))
        outs[name][glob] = value[tuple(tile_box)]
    for parent in stage.load_offsets:
      if readers.get(parent) == idx:
        bufs.pop(parent, None)


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
  ins = {name: semantics.to_repr(t, stencil.symbol_table[name])
         for name, t in zip(stencil.input_names, inputs)}
  pars = {stmt.name: semantics.to_repr(t, stmt.dtype)
          for stmt, t in zip(stencil.param_stmts, params)}
  outs = {name: torch.zeros(shape, device=device, dtype=semantics.repr_dtype(
      stencil.symbol_table[name])) for name in stencil.output_names}
  readers = last_readers(plan.stages)
  for index in np.ndindex(*plan.grid):
    origin = tuple(int(i) * t for i, t in zip(index, plan.tile))
    _run_tile(plan, origin, ins, pars, outs, readers, device)
  return tuple(semantics.to_storage(outs[n], stencil.symbol_table[n])
               for n in stencil.output_names)


def replicated_stencil_plain(stencil, inputs: Sequence[torch.Tensor],
                             params: Sequence[torch.Tensor] = (),
                             tile: Optional[TilePlan] = None
                             ) -> Tuple[torch.Tensor, ...]:
  """The replicated kernel's function in plain PyTorch:
  ``fused_stencil_plain`` mapped over the leading replica axis of
  ``inputs``; params are shared by all replicas."""
  per = [fused_stencil_plain(stencil, [a[r] for a in inputs], params, tile)
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

  ``launches`` counts kernel launches made by ``fn``.
  """

  def __init__(self, stencil, shape: Sequence[int], device='cuda',
               tile: Optional[Sequence[int]] = None,
               replicas: Optional[int] = None,
               apply_preserve_border: bool = True):
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
    self.plan = make_tile_plan(stencil, self.shape, tile)
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
      plain = (fused_stencil_plain if self.replicas is None else
               replicated_stencil_plain)
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
