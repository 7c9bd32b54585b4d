"""Coarse-grain replication: batched execution of independent grids.

The counterpart of soda_tpu/parallel/replicate.py. The reference's
``replication factor`` duplicates the whole dataflow pipeline so R
tiles stream concurrently; its win is for small grids, where one grid
cannot fill the device. The TPU maps the compiled kernel over the batch
one grid after another (``lax.map``); here the R grids are the second
axis of the kernel's launch grid, so they run in one launch, side by
side. Params are shared by all replicas.

Sharding the batch over several cards (the JAX package's ``mesh``) is
not ported yet (ROADMAP A9).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from soda_tpu_torch import utils

# What the replica axis replaces, for the run's report: the TPU's
# sequential lax.map of the compiled kernel over the batch.
REPLACES = 'soda_tpu/parallel/replicate.py:69'


class ReplicatedExecutor:
  """Run ``replication_factor`` independent grids per call.

  Inputs and outputs carry a leading batch axis of that extent. The
  inner executor is the ordinary one for the stencil (one fused kernel,
  or one per stage group under ``cluster: coarse/fine``), built with
  ``replicas=R``: one launch per kernel for all R grids.

  Args:
    stencil: a core.Stencil of this package.
    shape: one grid's shape (streaming axis first).
    replication_factor: R >= 1 (default: the stencil's
      ``replication_factor``).
    device: 'cuda' (default; raises without a usable GPU) or 'cpu'.
    mesh: not ported; raises NotImplementedError.
  """

  def __init__(self, stencil, shape: Sequence[int],
               replication_factor: Optional[int] = None, device='cuda',
               mesh=None):
    from soda_tpu_torch.backend import get_executor
    if mesh is not None:
      raise NotImplementedError(
          'sharding the replicated batch over several cards is not '
          'ported yet: ROADMAP A9 (sharding over NCCL)')
    self.stencil = stencil
    self.shape = tuple(int(s) for s in shape)
    factor = replication_factor if replication_factor is not None \
        else (stencil.replication_factor or 1)
    if factor < 1:
      raise utils.InputError('replication factor must be >= 1')
    self.replication_factor = factor
    self.inner = get_executor(stencil, self.shape, device=device,
                              replicas=factor)
    self.device = self.inner.device

  @property
  def launches(self) -> int:
    return self.inner.launches

  @launches.setter
  def launches(self, value: int) -> None:
    self.inner.launches = value

  def fn(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``fn(*inputs[R, ...], *params) -> (outputs[R, ...], ...)``."""
    return self.inner.fn(*args)

  def prepare(self, inputs: Mapping[str, np.ndarray],
              params: Optional[Mapping[str, np.ndarray]] = None
              ) -> Tuple[torch.Tensor, ...]:
    want = (self.replication_factor,) + self.shape
    for name in self.stencil.input_names:
      if name in inputs and np.shape(inputs[name]) != want:
        raise utils.InputError(
            'replicated input %s shape %s != %s (batch of %d grids)' %
            (name, np.shape(inputs[name]), want, self.replication_factor))
    return self.inner.prepare(inputs, params)

  def __call__(self, inputs: Mapping[str, np.ndarray],
               params: Optional[Mapping[str, np.ndarray]] = None
               ) -> Dict[str, torch.Tensor]:
    outs = self.fn(*self.prepare(inputs, params))
    return dict(zip(self.stencil.output_names, outs))
