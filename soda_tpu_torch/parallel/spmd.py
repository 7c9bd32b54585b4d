"""Sharded stencil execution: a device mesh and a halo exchange.

The counterpart of soda_tpu/parallel/spmd.py (``ShardedExecutor``,
:74-427). The grid is split over a 1-D or 2-D device mesh (the streaming
axis, and optionally the next array axis); every call extends each
shard with its neighbours' halo slabs and runs the stencil on the
extended shard. The halo width is the stencil's overall reach (the
plan's ``halo_lo``/``halo_hi``), so a multi-stage or ``iterate > 1``
pipeline exchanges once per input per axis per call, not once per
stage. The exchange is two-phase (axis 0, then axis 1 over the already
extended shard), which carries the corner halos that diagonal taps
read.

The JAX package runs one program per device (``shard_map``) and moves
slabs with ``lax.ppermute``. Here one process holds the mesh and a local
tensor per shard (``mesh.Shards``), and a slab moves as a copy to the
receiving shard's device (``_permute``): a peer copy over NVLink between
two cards, none at all between two shards of one card. Shards at the
global boundary receive zeros there, as ``ppermute``'s non-participating
edge does; those cells lie outside the global valid region.

The inner computation per shard, one executor per distinct device at
the extended shape:

- 'fused' (default; the JAX package's 'pallas', and 'auto' since the
  fused kernel's tile plan decides before any build): the fused CUDA
  kernel, one launch per shard per call. Where the plan does not fit
  shared memory it raises, as ``get_executor`` does;
- 'grouped': one fused kernel per stage group;
- 'xla': the whole-grid executor (backend/whole_grid.py), plain
  PyTorch.

The JAX package's default inner is 'xla', a compiled XLA program on the
TPU; here that is eager plain PyTorch, so the default is the kernel.

Extents that do not divide are padded to a shard multiple and cropped
back. ``border: preserve`` is applied after the crop against the global
boundary, from each shard's mesh position. ``overlap='on'`` is accepted
where the JAX package accepts it and runs the same exchange as 'off'
(the outputs are the same): on a mesh that repeats one card there is
nothing to overlap, and distinct cards are not measured yet.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.backend import c_semantics as oracle
from soda_tpu_torch.backend import semantics
from soda_tpu_torch.backend.border import border_base, paired_input
from soda_tpu_torch.backend.fused import (FusedExecutor, check_stencil,
                                          resolve_device)
from soda_tpu_torch.backend.grouped import GroupedExecutor
from soda_tpu_torch.backend.plan import make_plan
from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
from soda_tpu_torch.parallel.mesh import (Mesh, Replicated, Shards,
                                          axis_groups, bits, device_array,
                                          shard_devices, visible_devices)

# What the per-shard kernels replace, for the run's report.
REPLACES = 'soda_tpu/parallel/spmd.py:191-227'
INNERS = {'fused': FusedExecutor, 'grouped': GroupedExecutor,
          'xla': WholeGridExecutor}
# the JAX package's names for the fused inner
ALIASES = {'pallas': 'fused', 'auto': 'fused'}


def _map(fn, *arrays: np.ndarray) -> np.ndarray:
  """``fn(pos, *elements)`` over object ndarrays of one shape."""
  out = np.empty(arrays[0].shape, dtype=object)
  for pos in np.ndindex(*out.shape):
    out[pos] = fn(pos, *(a[pos] for a in arrays))
  return out


def _permute(slabs: np.ndarray, devices: np.ndarray, axis: int, shift: int
             ) -> np.ndarray:
  """``lax.ppermute`` along one axis of the shard grid: shard ``p``
  receives shard ``p - shift``'s slab on its own device, or zeros where
  no such shard exists."""
  n = slabs.shape[axis]

  def receive(pos, slab, device):
    src = list(pos)
    src[axis] -= shift
    if 0 <= src[axis] < n:
      return slabs[tuple(src)].to(device, non_blocking=True)
    return torch.zeros(slab.shape, dtype=bits(slab).dtype,
                       device=device).view(slab.dtype)

  return _map(receive, slabs, devices)


def _cat(parts: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
  return torch.cat([bits(p) for p in parts], dim=axis).view(parts[0].dtype)


def geometry(stencil, global_shape: Sequence[int], mesh: Mesh, dim_axes=None):
  """(sharded axis groups, padded global shape, local shape, per sharded
  axis (halo lo, halo hi), extended shard shape) of ``stencil`` over
  ``global_shape`` on ``mesh``; raises utils.InputError where it cannot
  be sharded so (spmd.py:143-181)."""
  plan = make_plan(stencil, 'full')
  dim = plan.dim
  shape = tuple(int(s) for s in global_shape)
  if len(shape) != dim:
    raise utils.InputError('expected %d-D grid, got %d-D' % (dim, len(shape)))
  axes = axis_groups(mesh, dim_axes)
  if not 1 <= len(axes) <= 2:
    raise utils.InputError('ShardedExecutor shards 1 or 2 array axes')
  if len(axes) > dim:
    raise utils.InputError(
        '%d sharded axes need a grid with at least as many dimensions' %
        len(axes))
  padded, halos = list(shape), []
  for a, group in enumerate(axes):
    n_dev = int(np.prod([mesh.shape[name] for name in group]))
    padded[a] += (-shape[a]) % n_dev
  local = list(padded)
  for a, group in enumerate(axes):
    local[a] = padded[a] // int(np.prod([mesh.shape[n] for n in group]))
    d = dim - 1 - a
    lo, hi = plan.halo_lo[d], plan.halo_hi[d]
    if (lo or hi) and (lo >= local[a] or hi >= local[a]):
      raise utils.InputError('halo (%d, %d) exceeds local extent %d on '
                             'axis %d' % (lo, hi, local[a], a))
    halos.append((lo, hi))
  ext = tuple(local[a] + (sum(halos[a]) if a < len(axes) else 0)
              for a in range(dim))
  return axes, tuple(padded), tuple(local), tuple(halos), ext


class ShardedExecutor:
  """Run a stencil over a device mesh.

  Args:
    stencil: a core.Stencil of this package.
    global_shape: full grid shape (streaming axis first).
    mesh: a ``mesh.Mesh``; mesh axis k shards array axis k (1 or 2
      sharded array axes). Default: the visible devices of ``device``
      on one axis 'x', as many as the DSL's ``dram`` banks where it
      declares more than one (capped at what exists).
    inner: 'fused' (default; 'pallas' and 'auto' are accepted as the
      JAX package's names for it), 'grouped' or 'xla'; see the module
      docstring.
    device: the default mesh's kind of device: 'cuda' (default; raises
      without a usable GPU) or 'cpu'. An explicit ``mesh`` wins.
    dim_axes: optional array-axis -> mesh-axes mapping; an entry may be
      a tuple of names sharding one array axis over their flattened
      ring, outer axis major (``mesh.axis_groups``).
    inner_opts: keyword arguments of the inner executor (the fused
      kernel's ``tile=``, modes and layout keys, as the JAX package's
      per-shard Pallas options); ``apply_preserve_border`` belongs to
      this layer and is dropped.
    overlap: 'off' (default) or 'on' (single sharded axis, 'xla' inner,
      as the JAX package checks; the same exchange as 'off').

  ``prepare`` splits numpy inputs into ``Shards`` and params into
  ``Replicated`` copies; ``fn`` takes and returns those (outputs in the
  padded global shape), so ``chained`` feeds outputs back as inputs;
  ``__call__`` gathers each output onto the mesh's first device and
  crops it. ``launches`` is the sum over the inner executors (one per
  distinct device).
  """

  def __init__(self, stencil, global_shape: Sequence[int], mesh=None,
               inner: str = 'fused', device='cuda', dim_axes=None,
               inner_opts: Optional[Mapping] = None, overlap: str = 'off'):
    check_stencil(stencil)
    self.stencil = stencil
    self.shape = tuple(int(s) for s in global_shape)
    self.plan = make_plan(stencil, 'full')
    if mesh is None:
      devices = visible_devices(device)
      n_banks = max((len(getattr(stmt, 'dram', ()) or ())
                     for stmt in stencil.input_stmts + stencil.output_stmts),
                    default=1)
      if n_banks > 1:
        devices = devices[:n_banks]
      mesh = Mesh(device_array(devices, (len(devices),)), ('x',))
    self.mesh = mesh
    (self._axes, self.padded_shape, self.local_shape, self._halos,
     self.ext_shape) = geometry(stencil, self.shape, mesh, dim_axes)
    resolved = {d: resolve_device(d) for d in set(mesh.devices.flat)}
    self.devices = _map(lambda _, d: resolved[d],
                        shard_devices(mesh, self._axes))
    self.distinct = list(dict.fromkeys(self.devices.flat))
    self.device = self.distinct[0]

    inner = ALIASES.get(inner, inner)
    if inner not in INNERS:
      raise ValueError('unknown inner %r (one of %s)' %
                       (inner, ', '.join(list(INNERS) + list(ALIASES))))
    opts = dict(inner_opts or {})
    opts.pop('apply_preserve_border', None)
    if inner == 'xla' and opts:
      raise utils.InputError('the xla inner takes no inner_opts, got %s'
                             % sorted(opts))
    if overlap not in ('off', 'on'):
      raise utils.InputError("overlap must be 'off' or 'on'")
    if overlap == 'on' and (len(self._axes) != 1 or inner != 'xla'):
      raise utils.InputError(
          'overlap applies to single-axis sharding with the xla inner '
          '(edge bands are narrow shapes the fused kernel is not built '
          'for)')
    if overlap == 'on' and sum(self._halos[0]) > self.local_shape[0]:
      raise utils.InputError(
          'overlap needs local extent %d > total halo %d (edge bands '
          'would cover the whole shard); use overlap=off' %
          (self.local_shape[0], sum(self._halos[0])))
    self.inner = inner
    self.overlap = overlap
    # one executor per distinct device: one card builds once
    self._inner = {d: INNERS[inner](stencil, self.ext_shape, device=d,
                                    apply_preserve_border=False, **opts)
                   for d in self.distinct}

  @property
  def n_shards(self) -> int:
    return int(self.devices.size)

  @property
  def launches(self) -> int:
    return sum(ex.launches for ex in self._inner.values())

  @launches.setter
  def launches(self, value: int) -> None:
    """Reset every inner executor's count (only 0 is meaningful)."""
    if value != 0:
      raise ValueError('launches can only be reset to 0')
    for ex in self._inner.values():
      ex.launches = 0

  # -- the exchange and the border ------------------------------------------

  def _exchange(self, local: np.ndarray, axis: int) -> np.ndarray:
    """Extend every shard along ``axis`` with its neighbours' halos."""
    lo, hi = self._halos[axis]
    if not (lo or hi):
      return local
    parts = []
    if lo:
      n = local.flat[0].shape[axis]
      parts.append(_permute(_map(lambda _, t: t.narrow(axis, n - lo, lo),
                                 local), self.devices, axis, 1))
    parts.append(local)
    if hi:
      parts.append(_permute(_map(lambda _, t: t.narrow(axis, 0, hi), local),
                            self.devices, axis, -1))
    return _map(lambda _, *ts: _cat(ts, axis), *parts)

  def _valid_box(self, name: str, pos: Tuple[int, ...]) -> Tuple[slice, ...]:
    """Local slices of shard ``pos`` inside output ``name``'s global
    valid region (a box: the product of one interval per axis)."""
    dim = len(self.shape)
    stage = self.plan.stage(name)
    box = []
    for a in range(dim):
      lo, hi = stage.lo[dim - 1 - a], stage.hi[dim - 1 - a]
      base = pos[a] * self.local_shape[a] if a < len(self._axes) else 0
      start = min(max(lo - base, 0), self.local_shape[a])
      stop = max(min(self.shape[a] - hi - base, self.local_shape[a]), start)
      box.append(slice(start, stop))
    return tuple(box)

  def _preserve(self, pos, name: str, out: torch.Tensor,
                local_in: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``border: preserve`` with the global boundary: cells of shard
    ``pos`` outside the global valid region take the paired input,
    wrapped to the output type (spmd.py:355-372)."""
    base = border_base(self.stencil, name,
                       local_in[paired_input(self.stencil, name)])
    box = self._valid_box(name, pos)
    base[box] = out[box]
    return base

  # -- the executor contract -----------------------------------------------

  def _check(self, args) -> Tuple[Dict[str, np.ndarray],
                                  Dict[torch.device, List[torch.Tensor]]]:
    stencil = self.stencil
    n_in, n_par = len(stencil.input_names), len(stencil.param_names)
    if len(args) != n_in + n_par:
      raise utils.InputError('expected %d inputs and %d params, got %d '
                             'arguments' % (n_in, n_par, len(args)))
    ins = {}
    for name, arg in zip(stencil.input_names, args[:n_in]):
      want = semantics.storage_dtype(stencil.symbol_table[name])
      if (not isinstance(arg, Shards) or arg.shape != self.padded_shape or
          arg.grid != self.devices.shape or any(
              t.device != d or t.dtype != want or
              tuple(t.shape) != self.local_shape
              for t, d in zip(arg.tensors.flat, self.devices.flat))):
        raise utils.InputError(
            'input %s: expected Shards of %s over a %s shard grid (%s '
            'local tensors on the mesh devices); prepare it with '
            'ShardedExecutor.prepare' % (name, self.padded_shape,
                                         self.devices.shape, want))
      ins[name] = arg.tensors
    for name, arg in zip(stencil.param_names, args[n_in:]):
      if not isinstance(arg, Replicated) or not set(self.distinct) <= set(
          arg.copies):
        raise utils.InputError('param %s: expected a Replicated tensor on '
                               'every mesh device' % name)
    params = {d: [arg.on(d) for arg in args[n_in:]] for d in self.distinct}
    return ins, params

  def fn(self, *args) -> Tuple[Shards, ...]:
    """Positional ``fn(*inputs, *params) -> (outputs...)``: inputs and
    outputs are ``Shards`` of the padded global shape, params
    ``Replicated``."""
    stencil = self.stencil
    ins, params = self._check(args)
    ext = {}
    for name, arr in ins.items():
      for axis in range(len(self._axes)):
        arr = self._exchange(arr, axis)
      ext[name] = arr
    crops = tuple(slice(self._halos[a][0], self._halos[a][0] +
                        self.local_shape[a]) for a in range(len(self._axes)))
    outs = {name: np.empty(self.devices.shape, dtype=object)
            for name in stencil.output_names}
    for pos in np.ndindex(*self.devices.shape):
      device = self.devices[pos]
      got = self._inner[device].fn(*[ext[n][pos] for n in stencil.input_names],
                                   *params[device])
      for name, out in zip(stencil.output_names, got):
        outs[name][pos] = out[crops].contiguous()
    results = []
    for name in stencil.output_names:
      arr = outs[name]
      if stencil.preserve_border:
        arr = _map(lambda pos, out: self._preserve(
            pos, name, out, {n: a[pos] for n, a in ins.items()}), arr)
      results.append(Shards(arr, self.padded_shape))
    return tuple(results)

  def shard(self, array: np.ndarray) -> Shards:
    """A numpy array of the padded global shape -> ``Shards`` on the
    mesh devices."""
    def piece(pos, device):
      sl = tuple(slice(p * n, (p + 1) * n)
                 for p, n in zip(pos, self.local_shape))
      return torch.from_numpy(np.ascontiguousarray(array[sl])).to(device)

    return Shards(_map(piece, self.devices), self.padded_shape)

  def prepare(self, inputs: Mapping[str, np.ndarray],
              params: Optional[Mapping[str, np.ndarray]] = None
              ) -> Tuple[object, ...]:
    """numpy inputs of the global shape -> ``Shards`` (wrapped to the
    declared types, padded to the shard grid), params -> ``Replicated``
    on every distinct mesh device; in ``fn``'s positional order."""
    stencil = self.stencil
    pads = tuple((0, p - r) for p, r in zip(self.padded_shape, self.shape))
    args: List[object] = []
    for name in stencil.input_names:
      if name not in inputs:
        raise utils.InputError('missing input: %s' % name)
      arr = np.asarray(inputs[name])
      if arr.shape != self.shape:
        raise utils.InputError('input %s shape %s != global shape %s' %
                               (name, arr.shape, self.shape))
      if self.padded_shape != self.shape:
        arr = np.pad(arr, pads)
      args.append(self.shard(oracle.wrap(np, arr,
                                         stencil.symbol_table[name])))
    params = dict(params or {})
    for stmt in stencil.param_stmts:
      if stmt.name not in params:
        raise utils.InputError('missing param: %s' % stmt.name)
      arr = np.asarray(params[stmt.name])
      if arr.shape != tuple(stmt.size):
        raise utils.InputError('param %s shape %s != declared %s' %
                               (stmt.name, arr.shape, tuple(stmt.size)))
      arr = np.ascontiguousarray(oracle.wrap(np, arr, stmt.dtype))
      args.append(Replicated(torch.from_numpy(arr), self.distinct))
    return tuple(args)

  def __call__(self, inputs: Mapping[str, np.ndarray],
               params: Optional[Mapping[str, np.ndarray]] = None
               ) -> Dict[str, torch.Tensor]:
    outs = self.fn(*self.prepare(inputs, params))
    crop = tuple(slice(0, r) for r in self.shape)
    return {name: out.gather(self.device)[crop]
            for name, out in zip(self.stencil.output_names, outs)}
