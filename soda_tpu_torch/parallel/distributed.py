"""The sharded executor's rank form: one process per shard over
``torch.distributed``.

The counterpart of soda_tpu/parallel/spmd.py:115-427 as each device
runs it. There ``shard_map`` runs ``step`` on every device's shard and
``lax.ppermute`` moves the halos; here every rank of a process group
builds the same ``DistributedShardedExecutor`` and runs ``step`` on the
shard at its position. parallel/spmd.py's ``ShardedExecutor`` holds
every shard in one process instead; this form shares its geometry, its
inner executors and its global ``border: preserve``.

Rank ``r`` holds the shard at row-major position ``r`` of the mesh
(``mesh_shape``, a shape: the entries are ranks). A shard's position on
a sharded array axis is its place on that axis's mesh-axis group's
flattened ring, outer axis major (``mesh.shard_coords``), so
``dim_axes=[('slice', 'x')]`` works as in the JAX package. Every mesh
axis shards an array axis here: a rank holds a distinct shard.

The exchange: per input per sharded axis per call one
``dist.batch_isend_irecv`` with the two neighbours on the axis's ring
(each edge slab to the neighbour whose halo it is, each halo from the
neighbour it comes from); zeros at the global edge, as ``ppermute``'s
edge gives. On a 2-D mesh axis 0 goes first, then axis 1 over the
extended axis 0, which carries the corners diagonal taps read. Every
type travels as its bytes (a ``uint8`` view, as ``mesh.bits`` views an
unsigned type for the single-controller copies): gloo takes no 16-bit
integers. A rank with no neighbour on an axis posts no batch (NCCL at
world size 1).

The transport follows the group's backend (``dist.get_backend``), named
in ``repr``: NCCL moves CUDA tensors as they are, on NCCL's stream;
gloo moves host tensors, so a slab on the card is copied to the host
before its send and a received halo goes back to the card after its
wait. Only those two backends are taken, and a failing NCCL call raises:
no other transport stands in.

``overlap='on'`` is the JAX package's overlapped step (spmd.py:303-340),
step for step: the lo and hi sends and receives of every input are
posted first; the interior then runs on the local shard alone; then the
P2P works are waited on, the two edge bands (a received halo and a lo +
hi strip of the shard) run, and the pieces are stitched. Under NCCL the
halos move on NCCL's stream while the interior runs on the compute
stream; under gloo on gloo's threads. The conditions are the JAX
package's: one sharded axis, the 'xla' inner, a local extent no smaller
than lo + hi.

``fn`` takes and returns this rank's local tensors, so ``api.chained``
feeds outputs back with one exchange a step; it records no CUDA graph
(NCCL under graph capture is later work).
"""

from __future__ import annotations

import os
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist

from soda_tpu_torch import utils
from soda_tpu_torch.backend.fused import (check_args, check_stencil,
                                          resolve_device)
from soda_tpu_torch.backend.plan import make_plan
from soda_tpu_torch.parallel import launch
from soda_tpu_torch.parallel.mesh import (Mesh, Shards, device_array,
                                          shard_coords)
from soda_tpu_torch.parallel.spmd import (INNERS, _cat, _map, check_overlap,
                                          geometry, global_inputs,
                                          inner_options, param_arrays,
                                          preserve, valid_box)


def rank_device(device, rank: int) -> torch.device:
  """A rank's device: ``device`` checked, or for None the card
  ``cuda:LOCAL_RANK`` (raises utils.InputError without a usable GPU)."""
  if device is None:
    if not torch.cuda.is_available():
      raise utils.InputError('device None is cuda:LOCAL_RANK, and no CUDA '
                             "device is available (pass device='cpu')")
    device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', rank)))
  return resolve_device(device)


class Posted(NamedTuple):
  """One posted exchange: its P2P works, the sent tensors (kept alive
  until the works end), and the lo and hi halo buffers (None at the
  global edge and where a halo is empty)."""
  works: List[object]
  sends: List[torch.Tensor]
  lo: Optional[torch.Tensor]
  hi: Optional[torch.Tensor]


def rank_mesh(mesh_shape: Sequence[int], axis_names: Optional[Sequence[str]],
              devices: Sequence) -> Mesh:
  """A mesh of ``mesh_shape`` over ``devices`` (one an entry, row-major:
  rank r's at entry r) on ``axis_names`` (default 'x', and 'y')."""
  names = tuple(axis_names or ('x', 'y')[:len(mesh_shape)])
  return Mesh(device_array(devices, tuple(mesh_shape)), names)


def _slab_bytes(tensor: torch.Tensor, axis: int, width: int
                ) -> Tuple[int, ...]:
  """The shape of the bytes of ``tensor``'s slab ``width`` wide along
  ``axis`` (the last axis counts bytes)."""
  shape = list(tensor.shape)
  shape[axis] = width
  shape[-1] *= tensor.element_size()
  return tuple(shape)


class DistributedShardedExecutor:
  """One rank's part of a stencil run over a mesh of ranks.

  Args:
    stencil: a core.Stencil of this package (the same on every rank).
    global_shape: full grid shape (streaming axis first).
    mesh_shape: the mesh's shape; its product must be the group's size
      (default: every rank on one axis).
    axis_names: one name per mesh axis (default 'x', and 'y').
    dim_axes: optional array-axis -> mesh-axes mapping, as
      ``ShardedExecutor`` takes it.
    inner: 'fused' (default; 'pallas' and 'auto' are its aliases),
      'grouped' or 'xla' (the whole-grid executor).
    inner_opts: keyword arguments of the inner executor.
    overlap: 'off' (default) or 'on' (the overlapped step).
    device: this rank's device; None is ``cuda:LOCAL_RANK``.
    trace: optional callable, called with 'post' after each P2P batch
      is posted, 'wait' before each batch is waited on and 'inner N'
      before each inner call on N rows.

  The group is the default process group: its ranks are the mesh's.

  ``prepare`` takes the global numpy inputs (the same on every rank) and
  keeps this rank's padded, wrapped shard and every param; ``fn`` maps
  local tensors to local outputs; ``gather`` makes global outputs on
  every rank; ``__call__`` is the three. ``launches`` counts this
  rank's inner launches, ``exchanges`` the P2P batches it posted and
  ``halo_bytes`` the bytes its halos received.
  """

  recordable = False  # chained runs its steps from Python

  def __init__(self, stencil, global_shape: Sequence[int],
               mesh_shape: Optional[Sequence[int]] = None,
               axis_names: Optional[Sequence[str]] = None, dim_axes=None,
               inner: str = 'fused', inner_opts: Optional[Mapping] = None,
               overlap: str = 'off', device=None,
               trace: Optional[Callable[[str], None]] = None):
    check_stencil(stencil)
    if not dist.is_initialized():
      raise utils.InputError('the rank form runs in a process group '
                             '(launch.spawn or launch.init_from_env)')
    self.stencil = stencil
    self.shape = tuple(int(s) for s in global_shape)
    self.plan = make_plan(stencil, 'full')
    self.trace = trace
    self.backend = str(dist.get_backend())
    if self.backend not in launch.BACKENDS:
      raise utils.InputError('backend %s: the rank form moves halos over '
                             '%s' % (self.backend, ' or '.join(
                                 launch.BACKENDS)))
    self.rank = dist.get_rank()
    self.world_size = dist.get_world_size()
    mesh_shape = tuple(int(n) for n in mesh_shape or (self.world_size,))
    if int(np.prod(mesh_shape)) != self.world_size:
      raise utils.InputError('a mesh of shape %s needs %d ranks; the group '
                             'has %d' % (mesh_shape,
                                         int(np.prod(mesh_shape)),
                                         self.world_size))
    self.device = rank_device(device, self.rank)
    if self.backend == 'nccl' and self.device.type != 'cuda':
      raise utils.InputError('NCCL moves CUDA tensors; %s is not a card'
                             % self.device)
    # gloo moves host tensors: halos and gathers stage through the host
    self.staged = self.backend == 'gloo' and self.device.type != 'cpu'
    # the mesh as the geometry reads it: every entry stands for a rank
    self.mesh = rank_mesh(mesh_shape, axis_names,
                          [self.device] * self.world_size)
    (self._axes, self.padded_shape, self.local_shape, self._halos,
     self.ext_shape) = geometry(stencil, self.shape, self.mesh, dim_axes)
    idle = set(self.mesh.axis_names) - {n for group in self._axes
                                        for n in group}
    if idle:
      raise utils.InputError('mesh axes %s shard no array axis; in the '
                             'rank form every rank holds its own shard'
                             % sorted(idle))
    self._ranks = _map(lambda _, c: int(np.ravel_multi_index(c, mesh_shape)),
                       shard_coords(self.mesh, self._axes))
    self.pos = next(p for p in np.ndindex(*self._ranks.shape)
                    if self._ranks[p] == self.rank)
    self.inner, opts = inner_options(inner, inner_opts)
    check_overlap(overlap, len(self._axes), self.inner, self._halos,
                  self.local_shape)
    self.overlap = overlap
    self._opts = opts
    self._inners: Dict[Tuple[int, ...], object] = {}
    for shape in self._inner_shapes():
      self._inner_at(shape)
    self.exchanges = 0
    self.halo_bytes = 0

  def __repr__(self) -> str:
    return ('DistributedShardedExecutor(rank %d of %d at shard %s, mesh %s, '
            '%s: %s, inner %s, overlap %s, device %s)' % (
                self.rank, self.world_size, self.pos, dict(self.mesh.shape),
                self.backend, 'halos staged through host memory'
                if self.staged else 'halos moved as they lie', self.inner,
                self.overlap, self.device))

  @property
  def launches(self) -> int:
    return sum(ex.launches for ex in self._inners.values())

  @launches.setter
  def launches(self, value: int) -> None:
    """Reset every inner executor's count (only 0 is meaningful)."""
    if value != 0:
      raise ValueError('launches can only be reset to 0')
    for ex in self._inners.values():
      ex.launches = 0

  # -- inner executors --------------------------------------------------------

  def _inner_shapes(self) -> List[Tuple[int, ...]]:
    """The shapes the inner runs at: the extended shard; under overlap
    the local shard (the interior) and the two edge bands."""
    if self.overlap == 'off':
      return [self.ext_shape]
    lo, hi = self._halos[0]
    rest = self.local_shape[1:]
    shapes = [self.local_shape]
    if lo:
      shapes.append((2 * lo + hi,) + rest)
    if hi:
      shapes.append((lo + 2 * hi,) + rest)
    return shapes

  def _inner_at(self, shape: Tuple[int, ...]):
    if shape not in self._inners:
      self._inners[shape] = INNERS[self.inner](
          self.stencil, shape, device=self.device,
          apply_preserve_border=False, **self._opts)
    return self._inners[shape]

  def _run(self, ins: Sequence[torch.Tensor], params) -> List[torch.Tensor]:
    shape = tuple(ins[0].shape)
    if self.trace:
      self.trace('inner %d' % shape[0])
    return list(self._inner_at(shape).fn(*ins, *params))

  # -- the exchange -------------------------------------------------------------

  def _peer(self, axis: int, step: int) -> Optional[int]:
    """The global rank of the shard ``step`` places along ``axis``, or
    None past the global edge."""
    pos = list(self.pos)
    pos[axis] += step
    if not 0 <= pos[axis] < self._ranks.shape[axis]:
      return None
    return int(self._ranks[tuple(pos)])

  def _wire(self, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` as the backend sends it: its bytes, contiguous, on the
    host under gloo."""
    wire = tensor.contiguous().view(torch.uint8)
    if self.staged:
      wire = wire.cpu()
    if self.backend == 'gloo' and wire.device.type != 'cpu':
      raise RuntimeError('a CUDA tensor reached gloo')
    return wire

  def _post(self, tensor: torch.Tensor, axis: int, tag: int = 0) -> Posted:
    """Post the exchange of ``tensor``'s edge slabs along ``axis``: one
    batch (none where this rank has no neighbour)."""
    lo, hi = self._halos[axis]
    n = tensor.shape[axis]
    before, after = self._peer(axis, -1), self._peer(axis, 1)
    ops, keep, recv = [], [], {}
    for width, send_at, to, came_from, side in ((lo, n - lo, after, before,
                                                 'lo'),
                                                (hi, 0, before, after, 'hi')):
      if not width:
        continue
      if to is not None:
        keep.append(self._wire(tensor.narrow(axis, send_at, width)))
        ops.append(dist.P2POp(dist.isend, keep[-1], to, tag=tag))
      if came_from is not None:
        recv[side] = torch.empty(_slab_bytes(tensor, axis, width),
                                 dtype=torch.uint8,
                                 device='cpu' if self.staged else self.device)
        ops.append(dist.P2POp(dist.irecv, recv[side], came_from, tag=tag))
    works = dist.batch_isend_irecv(ops) if ops else []
    if ops:
      self.exchanges += 1
      if self.trace:
        self.trace('post')
    return Posted(works, keep, recv.get('lo'), recv.get('hi'))

  def _halo(self, buffer: Optional[torch.Tensor], like: torch.Tensor,
            axis: int, width: int) -> torch.Tensor:
    """A received halo on this rank's device, or zeros at the edge."""
    if buffer is None:
      return torch.zeros(_slab_bytes(like, axis, width), dtype=torch.uint8,
                         device=self.device).view(like.dtype)
    self.halo_bytes += buffer.numel() * buffer.element_size()
    return buffer.to(self.device).view(like.dtype)

  def _wait(self, posted: Posted) -> None:
    if self.trace and posted.works:
      self.trace('wait')
    for work in posted.works:
      work.wait()

  def _exchange(self, tensor: torch.Tensor, axis: int) -> torch.Tensor:
    """``tensor`` extended along ``axis`` with its neighbours' halos."""
    lo, hi = self._halos[axis]
    if not (lo or hi):
      return tensor
    posted = self._post(tensor, axis)
    self._wait(posted)
    parts = []
    if lo:
      parts.append(self._halo(posted.lo, tensor, axis, lo))
    parts.append(tensor)
    if hi:
      parts.append(self._halo(posted.hi, tensor, axis, hi))
    return _cat(parts, axis)

  # -- the step -----------------------------------------------------------------

  def _step(self, ins: List[torch.Tensor], params) -> List[torch.Tensor]:
    """The outputs on the local extent, before the global border."""
    ext = []
    for tensor in ins:
      for axis in range(len(self._axes)):
        tensor = self._exchange(tensor, axis)
      ext.append(tensor)
    crops = tuple(slice(lo, lo + n) for (lo, _), n in
                  zip(self._halos, self.local_shape))
    return [out[crops].contiguous() for out in self._run(ext, params)]

  def _step_overlapped(self, ins: List[torch.Tensor], params
                       ) -> List[torch.Tensor]:
    """spmd.py:303-340: sends and receives first, the interior while
    they fly, then the edge bands from the received halos."""
    lo, hi = self._halos[0]
    length = self.local_shape[0]
    posted = [self._post(t, 0, tag) for tag, t in enumerate(ins)] \
        if lo or hi else []
    interior = self._run(ins, params)
    for p in posted:
      self._wait(p)
    pieces: List[List[torch.Tensor]] = [[] for _ in interior]
    if lo:
      band = [_cat([self._halo(p.lo, t, 0, lo), t[:lo + hi]], 0)
              for p, t in zip(posted, ins)]
      for piece, out in zip(pieces, self._run(band, params)):
        piece.append(out[lo:2 * lo])
    for piece, out in zip(pieces, interior):
      piece.append(out[lo:length - hi])
    if hi:
      band = [_cat([t[length - (lo + hi):], self._halo(p.hi, t, 0, hi)], 0)
              for p, t in zip(posted, ins)]
      for piece, out in zip(pieces, self._run(band, params)):
        piece.append(out[lo:lo + hi])
    return [_cat(piece, 0) for piece in pieces]

  # -- the executor contract --------------------------------------------------

  def fn(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Positional ``fn(*inputs, *params) -> (outputs...)`` on this rank:
    inputs and outputs are its local shards (``local_shape``), params
    whole; every rank of the group calls it together."""
    stencil = self.stencil
    check_args(stencil, self.local_shape, self.device, args)
    n_in = len(stencil.input_names)
    ins, params = list(args[:n_in]), args[n_in:]
    step = self._step_overlapped if self.overlap == 'on' else self._step
    outs = step(ins, params)
    if stencil.preserve_border:
      local_in = dict(zip(stencil.input_names, ins))
      outs = [preserve(stencil, valid_box(self.plan, self.shape,
                                          self.local_shape, len(self._axes),
                                          name, self.pos),
                       name, out, local_in)
              for name, out in zip(stencil.output_names, outs)]
    return tuple(outs)

  def prepare(self, inputs: Mapping[str, np.ndarray],
              params: Optional[Mapping[str, np.ndarray]] = None
              ) -> Tuple[torch.Tensor, ...]:
    """Global numpy inputs (the same on every rank) -> this rank's
    shard of each, wrapped and padded; params -> tensors on its device;
    in ``fn``'s positional order."""
    box = tuple(slice(p * n, (p + 1) * n)
                for p, n in zip(self.pos, self.local_shape))
    args = [torch.from_numpy(np.ascontiguousarray(arr[box])).to(self.device)
            for arr in global_inputs(self.stencil, self.shape,
                                     self.padded_shape, inputs)]
    args += [torch.from_numpy(arr).to(self.device)
             for arr in param_arrays(self.stencil, params)]
    return tuple(args)

  def gather(self, outs: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every rank's local outputs -> the global outputs (cropped to the
    global shape) on this rank's device, on every rank (``all_gather``;
    through the host under gloo)."""
    crop = tuple(slice(0, r) for r in self.shape)
    result = {}
    for name, out in zip(self.stencil.output_names, outs):
      wire = self._wire(out)
      parts = [torch.empty_like(wire) for _ in range(self.world_size)]
      dist.all_gather(parts, wire)
      grid = _map(lambda _, r: parts[r], self._ranks)
      whole = Shards(grid, self.padded_shape).gather(self.device)
      result[name] = whole.view(out.dtype)[crop]
    return result

  def __call__(self, inputs: Mapping[str, np.ndarray],
               params: Optional[Mapping[str, np.ndarray]] = None
               ) -> Dict[str, torch.Tensor]:
    return self.gather(self.fn(*self.prepare(inputs, params)))
