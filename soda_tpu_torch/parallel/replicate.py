"""Coarse-grain replication: batched execution of independent grids.

The counterpart of soda_tpu/parallel/replicate.py. The reference's
``replication factor`` duplicates the whole dataflow pipeline so R
tiles stream concurrently; its win is for small grids, where one grid
cannot fill the device. The TPU maps the compiled kernel over the batch
one grid after another (``lax.map``); here the R grids are the second
axis of the kernel's launch grid, so they run in one launch, side by
side. Params are shared by all replicas.

With a mesh (``mesh.Mesh``), the batch splits over the mesh's first
axis, as the JAX package shards it (:73-85): each entry of that axis
runs R / n grids in one replicated launch on its device, and the other
mesh axes, which replicate the batch there, compute nothing twice.
``backend='xla'`` maps the whole-grid executor over the replicas.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.backend.fused import prepare_args
from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
from soda_tpu_torch.parallel.mesh import Replicated, Shards, bits

# What the replica axis replaces, for the run's report: the TPU's
# sequential lax.map of the compiled kernel over the batch.
REPLACES = 'soda_tpu/parallel/replicate.py:69'


class ReplicatedExecutor:
  """Run ``replication_factor`` independent grids per call.

  Inputs and outputs carry a leading batch axis of that extent. The
  inner executor is the one ``get_executor(stencil, shape, backend)``
  gives (one fused kernel, or one per stage group under ``cluster:
  coarse/fine``), built with ``replicas``: one launch per kernel for
  all the grids of a device. With ``backend='xla'`` the whole-grid
  executor is mapped over the grids one by one.

  Args:
    stencil: a core.Stencil of this package.
    shape: one grid's shape (streaming axis first).
    replication_factor: R >= 1 (default: the stencil's
      ``replication_factor``).
    device: 'cuda' (default; raises without a usable GPU) or 'cpu'.
    mesh: None, or a ``mesh.Mesh`` whose first axis splits the batch
      (R must divide by its size); then ``prepare`` gives ``Shards``
      over the batch axis and ``Replicated`` params, and ``fn`` takes
      and returns those.
    backend: 'auto' (default), 'fused' or 'xla'.
    **kwargs: the inner executor's options (the fused kernel's ``tile``,
      modes and layout keys, FusedExecutor), as the JAX package forwards
      them (soda_tpu/parallel/replicate.py:36,48).
  """

  def __init__(self, stencil, shape: Sequence[int],
               replication_factor: Optional[int] = None, device='cuda',
               mesh=None, backend: str = 'auto', **kwargs):
    from soda_tpu_torch.backend import get_executor
    if backend not in ('auto', 'fused', 'xla'):
      raise ValueError('unknown backend for replication: %s' % backend)
    self.stencil = stencil
    self.shape = tuple(int(s) for s in shape)
    factor = replication_factor if replication_factor is not None \
        else (stencil.replication_factor or 1)
    if factor < 1:
      raise utils.InputError('replication factor must be >= 1')
    self.replication_factor = factor
    self.mesh = mesh
    if mesh is None:
      devices = [device]
    else:
      axis = mesh.axis_names[0]
      axis_size = mesh.shape[axis]
      if factor % axis_size:
        raise utils.InputError(
            "replication factor %d not divisible by mesh axis %r "
            "size %d" % (factor, axis, axis_size))
      devices = [mesh.devices[(i,) + (0,) * (mesh.devices.ndim - 1)]
                 for i in range(axis_size)]
    self.per_device = factor // len(devices)
    if backend != 'xla':
      kwargs['replicas'] = self.per_device
    # one executor per distinct device, one batch slice per mesh entry
    self._executors = {d: get_executor(stencil, self.shape, backend,
                                       device=d, **kwargs)
                       for d in dict.fromkeys(devices)}
    self._inner = [self._executors[d] for d in devices]
    self.inner = self._inner[0]
    self.device = self.inner.device

  @property
  def launches(self) -> int:
    return sum(ex.launches for ex in self._executors.values())

  @launches.setter
  def launches(self, value: int) -> None:
    for ex in self._executors.values():
      ex.launches = value

  def _run(self, inner, args: Sequence[torch.Tensor]
           ) -> Tuple[torch.Tensor, ...]:
    """One device's grids: ``args`` inputs of ``(n, *shape)``."""
    if not isinstance(inner, WholeGridExecutor):
      return inner.fn(*args)
    n_in = len(self.stencil.input_names)
    per = [inner.fn(*[a[r] for a in args[:n_in]], *args[n_in:])
           for r in range(args[0].shape[0])]
    return tuple(torch.stack([bits(o) for o in outs]).view(outs[0].dtype)
                 for outs in zip(*per))

  def fn(self, *args):
    """``fn(*inputs[R, ...], *params) -> (outputs[R, ...], ...)``; with a
    mesh, inputs and outputs are ``Shards`` over the batch axis and
    params ``Replicated``."""
    if self.mesh is None:
      return self._run(self.inner, args)
    n_in = len(self.stencil.input_names)
    want = (self.replication_factor,) + self.shape
    for arg in args[:n_in]:
      if not isinstance(arg, Shards) or arg.shape != want or \
          arg.grid != (len(self._inner),):
        raise utils.InputError('expected Shards of %s over %d devices; '
                               'prepare them with ReplicatedExecutor.prepare'
                               % (want, len(self._inner)))
    outs = [self._run(inner, [a.tensors[i] for a in args[:n_in]] +
                      [p.on(inner.device) for p in args[n_in:]])
            for i, inner in enumerate(self._inner)]
    return tuple(Shards.of(per_output, want) for per_output in zip(*outs))

  def prepare(self, inputs: Mapping[str, np.ndarray],
              params: Optional[Mapping[str, np.ndarray]] = None):
    want = (self.replication_factor,) + self.shape
    for name in self.stencil.input_names:
      if name in inputs and np.shape(inputs[name]) != want:
        raise utils.InputError(
            'replicated input %s shape %s != %s (batch of %d grids)' %
            (name, np.shape(inputs[name]), want, self.replication_factor))
    batch = (self.per_device,) + self.shape
    if self.mesh is None:
      return prepare_args(self.stencil, batch, self.device, inputs, params)
    n_in = len(self.stencil.input_names)
    per, args = self.per_device, []
    for i, inner in enumerate(self._inner):
      part = {n: np.asarray(inputs[n])[i * per:(i + 1) * per]
              for n in self.stencil.input_names if n in inputs}
      args.append(prepare_args(self.stencil, batch, inner.device, part,
                               params))
    ins = [Shards.of(per_input, want) for per_input in zip(*args)][:n_in]
    devices = [ex.device for ex in self._executors.values()]
    return tuple(ins + [Replicated(p, devices) for p in args[0][n_in:]])

  def __call__(self, inputs: Mapping[str, np.ndarray],
               params: Optional[Mapping[str, np.ndarray]] = None
               ) -> Dict[str, torch.Tensor]:
    outs = self.fn(*self.prepare(inputs, params))
    if self.mesh is not None:
      outs = tuple(o.gather(self.device) for o in outs)
    return dict(zip(self.stencil.output_names, outs))
