"""Device meshes and sharded tensors for the single-controller executors.

The counterpart of ``jax.sharding.Mesh`` as soda_tpu/parallel/spmd.py
uses it, of ``_axis_groups`` (spmd.py:48-71, copied) and of a global
array sharded over a mesh. One process holds the mesh and one local
tensor per shard; shards on different cards exchange halos as
device-to-device copies.

A device may appear in a mesh more than once: that is how one card
holds a 2x2 mesh, as the JAX package's tests run an 8-device mesh on
one host's virtual CPU devices.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.backend import semantics

# same-size signed dtype of each unsigned storage dtype: concatenation
# and zero fill run on these views, which every device supports
_BITS = {torch.uint16: torch.int16, torch.uint32: torch.int32,
         torch.uint64: torch.int64}


def bits(tensor: torch.Tensor) -> torch.Tensor:
  """``tensor`` viewed as a dtype every copy operation supports."""
  return tensor.view(_BITS.get(tensor.dtype, tensor.dtype))


def device_array(devices: Iterable, shape: Sequence[int]) -> np.ndarray:
  """An object ndarray of ``torch.device`` of ``shape``."""
  flat = [torch.device(d) for d in np.asarray(devices, dtype=object).flat]
  arr = np.empty(len(flat), dtype=object)
  arr[:] = flat
  return arr.reshape(tuple(shape))


class Mesh:
  """Devices laid out on named axes.

  Attributes:
    devices: object ndarray of ``torch.device``.
    axis_names: one name per axis of ``devices``.
    shape: ordered name -> size mapping, as ``jax.sharding.Mesh.shape``.
    size: the number of mesh entries.
  """

  def __init__(self, devices, axis_names: Sequence[str]):
    arr = np.asarray(devices, dtype=object)
    self.devices = device_array(arr, arr.shape)
    self.axis_names = tuple(axis_names)
    if len(self.axis_names) != self.devices.ndim:
      raise utils.InputError('%d axis names for a %d-D mesh' %
                             (len(self.axis_names), self.devices.ndim))
    if len(set(self.axis_names)) != len(self.axis_names):
      raise utils.InputError('mesh axis names repeat: %s' %
                             (self.axis_names,))
    self.shape = collections.OrderedDict(zip(self.axis_names,
                                             self.devices.shape))

  @property
  def size(self) -> int:
    return int(self.devices.size)

  def __repr__(self) -> str:
    return 'Mesh(%s, %s)' % (dict(self.shape), sorted(
        {str(d) for d in self.devices.flat}))


def visible_devices(kind) -> List[torch.device]:
  """The distinct visible devices of one kind: every CUDA card for
  'cuda' (raises utils.InputError where none is usable), the one CPU
  for 'cpu'."""
  kind = torch.device(kind).type
  if kind == 'cpu':
    return [torch.device('cpu')]
  semantics.require_device_support(torch.device(kind))
  return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def axis_groups(mesh: Mesh, dim_axes) -> Tuple[Tuple[str, ...], ...]:
  """Normalize the array-axis -> mesh-axes mapping (spmd.py:48-71).

  Default: mesh axis k shards array axis k. An entry may instead be a
  tuple of mesh axis names sharding one array axis over their
  flattened ring, outer axis major: ``dim_axes=[('slice', 'x')]``.
  """
  if dim_axes is None:
    return tuple((name,) for name in mesh.axis_names)
  groups = []
  seen = set()
  for entry in dim_axes:
    group = (entry,) if isinstance(entry, str) else tuple(entry)
    for name in group:
      if name not in mesh.shape:
        raise utils.InputError('unknown mesh axis %r' % (name,))
      if name in seen:
        raise utils.InputError('mesh axis %r used twice' % (name,))
      seen.add(name)
    groups.append(group)
  return tuple(groups)


def shard_devices(mesh: Mesh, axes: Tuple[Tuple[str, ...], ...]
                  ) -> np.ndarray:
  """The device of each shard: an object ndarray with one axis per
  sharded array axis, of the size of its mesh-axis group. A shard's
  index on an array axis is its position on the group's flattened ring
  (outer axis major); mesh axes that shard nothing are replicas of the
  same shard, and the one at index 0 computes it."""
  sizes = [[mesh.shape[n] for n in group] for group in axes]
  grid = tuple(int(np.prod(s)) for s in sizes)
  where = {name: k for k, name in enumerate(mesh.axis_names)}
  out = np.empty(grid, dtype=object)
  for pos in np.ndindex(*grid):
    coord = [0] * len(mesh.axis_names)
    for group, size, i in zip(axes, sizes, pos):
      for name, c in zip(group, np.unravel_index(i, size)):
        coord[where[name]] = int(c)
    out[pos] = mesh.devices[tuple(coord)]
  return out


@dataclasses.dataclass
class Shards:
  """A tensor sharded over a mesh: one local tensor per shard.

  Attributes:
    tensors: object ndarray of local tensors, one axis per sharded
      array axis (the leading axes of the global tensor).
    shape: the global shape (padded to a multiple of the shard grid).
  """
  tensors: np.ndarray
  shape: Tuple[int, ...]

  @classmethod
  def of(cls, tensors: Sequence[torch.Tensor], shape) -> 'Shards':
    """Shards along the leading axis, one tensor each, in order."""
    arr = np.empty(len(tensors), dtype=object)
    for i, tensor in enumerate(tensors):  # numpy would unpack tensors
      arr[i] = tensor
    return cls(arr, tuple(shape))

  @property
  def grid(self) -> Tuple[int, ...]:
    return self.tensors.shape

  def gather(self, device=None) -> torch.Tensor:
    """The global tensor on ``device`` (default: the first shard's)."""
    first = self.tensors.flat[0]
    device = first.device if device is None else torch.device(device)

    def cat(arr, axis):
      if arr.ndim == 1:
        return torch.cat([bits(t).to(device) for t in arr], dim=axis)
      return torch.cat([cat(sub, axis + 1) for sub in arr], dim=axis)

    return cat(self.tensors, 0).view(first.dtype)


class Replicated:
  """A tensor with one copy on each of a set of devices (JAX's
  ``P()``): a param of a sharded or meshed call."""

  def __init__(self, tensor: torch.Tensor, devices: Iterable[torch.device]):
    self.copies: Dict[torch.device, torch.Tensor] = {}
    for device in devices:
      if device not in self.copies:
        self.copies[device] = tensor.to(device)

  def on(self, device: torch.device) -> torch.Tensor:
    return self.copies[device]
