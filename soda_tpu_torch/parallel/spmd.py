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
nothing to overlap. The real overlap (the interior computing while the
halos fly) and distinct cards live in the rank form,
parallel/distributed.py: one process per shard over
``torch.distributed``, as the JAX package runs one program per device.
This form is the one for a mesh that repeats one card, where it replays
a graph and no process waits on another. A mesh of distinct cards (the
default mesh on a host with several) still runs here, one process
enqueuing every card's work through ``fn_eager``'s peer copies, for a
caller with no process group; it is kept correct and not tuned: work on
distinct cards goes to the rank form.

The JAX package's sharded call is one jitted ``shard_map``, one
dispatch. Here, on a mesh that repeats one card with a kernel inner, a
call after the first replays a CUDA graph of the exchange and the
per-shard launches (``fn``); ``fn_eager`` enqueues them from Python.
The 'xla' inner (and so ``overlap='on'``) is not recorded.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.backend import c_semantics as oracle
from soda_tpu_torch.backend import graphs, semantics
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


def inner_options(inner: str, inner_opts: Optional[Mapping]
                  ) -> Tuple[str, Dict]:
  """The inner's name ('pallas' and 'auto' resolved to 'fused') and its
  executor's keyword arguments, ``apply_preserve_border`` dropped (it
  belongs to the sharded layer); raises on an unknown inner and on
  options given to the 'xla' inner."""
  inner = ALIASES.get(inner, inner)
  if inner not in INNERS:
    raise ValueError('unknown inner %r (one of %s)' %
                     (inner, ', '.join(list(INNERS) + list(ALIASES))))
  opts = dict(inner_opts or {})
  opts.pop('apply_preserve_border', None)
  if inner == 'xla' and opts:
    raise utils.InputError('the xla inner takes no inner_opts, got %s'
                           % sorted(opts))
  return inner, opts


def check_overlap(overlap: str, n_axes: int, inner: str,
                  halos: Sequence[Tuple[int, int]],
                  local_shape: Sequence[int]) -> None:
  """Raise utils.InputError where ``overlap`` does not apply, by the JAX
  package's conditions (spmd.py:290-301): one sharded axis, the 'xla'
  inner, and a local extent no smaller than the total halo."""
  if overlap not in ('off', 'on'):
    raise utils.InputError("overlap must be 'off' or 'on'")
  if overlap == 'on' and (n_axes != 1 or inner != 'xla'):
    raise utils.InputError(
        'overlap applies to single-axis sharding with the xla inner '
        '(edge bands are narrow shapes the fused kernel is not built '
        'for)')
  if overlap == 'on' and sum(halos[0]) > local_shape[0]:
    raise utils.InputError(
        'overlap needs local extent %d > total halo %d (edge bands '
        'would cover the whole shard); use overlap=off' %
        (local_shape[0], sum(halos[0])))


def valid_box(plan, shape: Sequence[int], local_shape: Sequence[int],
              n_axes: int, name: str, pos: Sequence[int]
              ) -> Tuple[slice, ...]:
  """Local slices of the shard at ``pos`` (on ``n_axes`` sharded axes)
  inside output ``name``'s global valid region over ``shape`` (a box:
  the product of one interval per axis)."""
  dim = len(shape)
  stage = plan.stage(name)
  box = []
  for a in range(dim):
    lo, hi = stage.lo[dim - 1 - a], stage.hi[dim - 1 - a]
    base = pos[a] * local_shape[a] if a < n_axes else 0
    start = min(max(lo - base, 0), local_shape[a])
    stop = max(min(shape[a] - hi - base, local_shape[a]), start)
    box.append(slice(start, stop))
  return tuple(box)


def preserve(stencil, box: Tuple[slice, ...], name: str, out: torch.Tensor,
             local_in: Mapping[str, torch.Tensor]) -> torch.Tensor:
  """``border: preserve`` with the global boundary: a shard's cells
  outside ``box`` (its ``valid_box``) take the paired input, wrapped to
  the output type (spmd.py:355-372)."""
  base = border_base(stencil, name, local_in[paired_input(stencil, name)])
  base[box] = out[box]
  return base


def global_inputs(stencil, shape: Tuple[int, ...],
                  padded_shape: Tuple[int, ...],
                  inputs: Mapping[str, np.ndarray]) -> List[np.ndarray]:
  """numpy inputs of the global ``shape``, in input order, wrapped to
  the declared types and zero-padded to ``padded_shape``."""
  pads = tuple((0, p - r) for p, r in zip(padded_shape, shape))
  out = []
  for name in stencil.input_names:
    if name not in inputs:
      raise utils.InputError('missing input: %s' % name)
    arr = np.asarray(inputs[name])
    if arr.shape != shape:
      raise utils.InputError('input %s shape %s != global shape %s' %
                             (name, arr.shape, shape))
    if padded_shape != shape:
      arr = np.pad(arr, pads)
    out.append(oracle.wrap(np, arr, stencil.symbol_table[name]))
  return out


def param_arrays(stencil, params: Optional[Mapping[str, np.ndarray]]
                 ) -> List[np.ndarray]:
  """numpy params, in param order, checked against their declared sizes
  and wrapped to their types (contiguous)."""
  params = dict(params or {})
  out = []
  for stmt in stencil.param_stmts:
    if stmt.name not in params:
      raise utils.InputError('missing param: %s' % stmt.name)
    arr = np.asarray(params[stmt.name])
    if arr.shape != tuple(stmt.size):
      raise utils.InputError('param %s shape %s != declared %s' %
                             (stmt.name, arr.shape, tuple(stmt.size)))
    out.append(np.ascontiguousarray(oracle.wrap(np, arr, stmt.dtype)))
  return out


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
      as the JAX package checks; here the same exchange as 'off', the
      overlapped step is the rank form's, parallel/distributed.py).

  ``prepare`` splits numpy inputs into ``Shards`` and params into
  ``Replicated`` copies; ``fn`` takes and returns those (outputs in the
  padded global shape), so ``chained`` feeds outputs back as inputs;
  ``__call__`` gathers each output onto the mesh's first device and
  crops it. ``launches`` is the sum over the inner executors (one per
  distinct device); ``replays`` counts the calls ``fn`` made as one
  replay of its recorded graph; ``recordable`` says whether it records
  one (see ``fn``).
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

    inner, opts = inner_options(inner, inner_opts)
    check_overlap(overlap, len(self._axes), inner, self._halos,
                  self.local_shape)
    self.inner = inner
    self.overlap = overlap
    # one executor per distinct device: one card builds once
    self._inner = {d: INNERS[inner](stencil, self.ext_shape, device=d,
                                    apply_preserve_border=False, **opts)
                   for d in self.distinct}
    # whether fn (and a chained run over it) records its work in a CUDA
    # graph: kernels on one card
    self.recordable = (inner != 'xla' and len(self.distinct) == 1 and
                       self.device.type == 'cuda')
    self._graph: Optional[graphs.Captured] = None
    self.replays = 0

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

  # -- the exchange ---------------------------------------------------------

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
    ``Replicated``.

    On a mesh that repeats one card, with the 'fused' or 'grouped'
    inner, the first call runs ``fn_eager``'s path and records its halo
    exchange and per-shard launches in a CUDA graph
    (backend/graphs.py); a later call copies each argument shard into
    the interior of its halo-extended buffer, replays the graph (one
    dispatch; ``replays`` counts them), then crops each shard's outputs
    into fresh tensors and applies ``border: preserve``. The crop stays
    outside the graph because it is what makes outputs that no later
    call overwrites: inside, it would need a copy after it, one more
    pass over memory. (Along axis 0 alone the eager crop is a view, so
    there the recorded call copies the outputs once more than
    ``fn_eager``; its copy into the buffers replaces the eager path's
    concatenation.) The 'xla' inner (plain PyTorch, which waits on the
    host at times), distinct cards (the rank form,
    parallel/distributed.py, runs those one process a card), arguments
    that require grad and a call inside another recording take
    ``fn_eager``'s path."""
    ins, params = self._check(args)
    if not (self.recordable and graphs.capturable(args)):
      return self._eager(ins, params)
    if self._graph is None:
      outs = self._eager(ins, params)
      self._graph = self._record(ins, params)
      return outs
    got = self._graph.replay(self._sources(ins, params))
    self.replays += 1
    return self._finish(got, ins, copy=True)

  def fn_eager(self, *args) -> Tuple[Shards, ...]:
    """``fn`` with every copy, launch and crop enqueued from Python (the
    work a recording holds, and what ``fn`` does where it records
    nothing)."""
    return self._eager(*self._check(args))

  def _crops(self) -> Tuple[slice, ...]:
    return tuple(slice(self._halos[a][0], self._halos[a][0] +
                       self.local_shape[a]) for a in range(len(self._axes)))

  def _eager(self, ins, params) -> Tuple[Shards, ...]:
    ext = {}
    for name, arr in ins.items():
      for axis in range(len(self._axes)):
        arr = self._exchange(arr, axis)
      ext[name] = arr
    return self._finish(self._launch(ext, params), ins)

  def _launch(self, ext: Mapping[str, np.ndarray], params
              ) -> Dict[str, np.ndarray]:
    """The inner executor on every halo-extended shard: output name ->
    the shards' uncropped outputs."""
    stencil = self.stencil
    outs = {name: np.empty(self.devices.shape, dtype=object)
            for name in stencil.output_names}
    for pos in np.ndindex(*self.devices.shape):
      device = self.devices[pos]
      got = self._inner[device].fn(*[ext[n][pos] for n in stencil.input_names],
                                   *params[device])
      for name, out in zip(stencil.output_names, got):
        outs[name][pos] = out
    return outs

  def _finish(self, got: Mapping[str, np.ndarray], ins, copy: bool = False
              ) -> Tuple[Shards, ...]:
    """Each shard's outputs cropped to its local extent, with the global
    ``border: preserve``. A crop along axis 0 alone is a contiguous view
    of the shard's output; ``copy`` (outputs a replay overwrites) makes
    it fresh memory, as ``border: preserve`` does anyway."""
    crops = self._crops()
    copy = copy and not self.stencil.preserve_border
    results = []
    for name in self.stencil.output_names:
      arr = _map(lambda _, out: out[crops].clone(
          memory_format=torch.contiguous_format) if copy else
                 out[crops].contiguous(), got[name])
      if self.stencil.preserve_border:
        arr = _map(lambda pos, out: preserve(
            self.stencil, valid_box(self.plan, self.shape, self.local_shape,
                                    len(self._axes), name, pos),
            name, out, {n: a[pos] for n, a in ins.items()}), arr)
      results.append(Shards(arr, self.padded_shape))
    return tuple(results)

  # -- the recorded call ------------------------------------------------------

  def _record(self, ins, params) -> graphs.Captured:
    """A graph of one call over fixed buffers: per input, its shards'
    halo-extended tensors (zero where no neighbour's halo lands), whose
    interiors take the arguments; a copy of each param. It holds the
    exchange between those buffers and the per-shard launches."""
    crops = self._crops()
    ext, interiors = {}, []
    for name, arr in ins.items():
      ext[name] = _map(lambda _, t: torch.zeros(
          self.ext_shape, dtype=bits(t).dtype, device=t.device).view(t.dtype),
                       arr)
      interiors += [e[crops] for e in ext[name].flat]
    fixed = {d: [p.clone() for p in ps] for d, ps in params.items()}

    def call():
      for arr in ext.values():
        self._exchange_in_place(arr)
      return self._launch(ext, fixed)

    return graphs.Captured(
        call, interiors + [p for ps in fixed.values() for p in ps])

  def _sources(self, ins, params) -> List[torch.Tensor]:
    """A call's tensors in the order of ``_record``'s buffers."""
    return ([t for arr in ins.values() for t in arr.flat] +
            [p for d in self.distinct for p in params[d]])

  def _exchange_in_place(self, ext: np.ndarray) -> None:
    """``_exchange`` over every sharded axis, within the halo-extended
    buffers of one input: each halo takes its neighbour's edge cells
    (axis 0 first, over the interior of later axes; then axis 1 over the
    extended axis 0, which carries the corners)."""
    crops = self._crops()
    for axis in range(len(crops)):
      lo, hi = self._halos[axis]
      n = self.local_shape[axis]

      def box(start, stop, _axis=axis):
        return tuple(slice(start, stop) if a == _axis else
                     slice(None) if a < _axis else crop
                     for a, crop in enumerate(crops))

      for pos in np.ndindex(*ext.shape):
        before, after = list(pos), list(pos)
        before[axis] -= 1
        after[axis] += 1
        if lo and pos[axis] > 0:
          bits(ext[pos])[box(0, lo)] = bits(ext[tuple(before)])[box(n, n + lo)]
        if hi and pos[axis] + 1 < ext.shape[axis]:
          bits(ext[pos])[box(lo + n, lo + n + hi)] = \
              bits(ext[tuple(after)])[box(lo, lo + hi)]

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
    args: List[object] = [
        self.shard(arr) for arr in global_inputs(
            self.stencil, self.shape, self.padded_shape, inputs)]
    args += [Replicated(torch.from_numpy(arr), self.distinct)
             for arr in param_arrays(self.stencil, params)]
    return tuple(args)

  def __call__(self, inputs: Mapping[str, np.ndarray],
               params: Optional[Mapping[str, np.ndarray]] = None
               ) -> Dict[str, torch.Tensor]:
    outs = self.fn(*self.prepare(inputs, params))
    crop = tuple(slice(0, r) for r in self.shape)
    return {name: out.gather(self.device)[crop]
            for name, out in zip(self.stencil.output_names, outs)}
