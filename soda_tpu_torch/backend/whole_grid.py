"""The whole-grid executor: the fused kernel's plain version, whole grid.

The counterpart of soda_tpu/backend/xla.py (``XlaExecutor``, :30-174).
It is ``fused_stencil_plain`` with the whole grid as one tile: every
stage the torch Evaluator over shifted slices of its parents, stored on
its valid region (zero outside it), each buffer dropped after its last
reader. Plain PyTorch on any device; no kernel of this package runs, so
``launches`` stays 0. ``get_executor(..., 'xla')`` builds it, and the
sharded executor takes it as its ``'xla'`` inner.

What differs from the JAX package: its XLA path turns on the TPU
rewrites ``fast_rsqrt`` and ``fast_int_div`` (xla.py:51-52); this one
computes the oracle's C arithmetic, as the fused kernel does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from soda_tpu_torch.backend.fused import (check_args, check_stencil,
                                          fix_border, fused_stencil_plain,
                                          prepare_args, resolve_device)
from soda_tpu_torch.backend.tile_plan import make_tile_plan


class WholeGridExecutor:
  """Run a stencil as whole-grid PyTorch arithmetic on any device.

  Args:
    stencil: a core.Stencil of this package.
    shape: full array shape (streaming axis first).
    cluster: fusion granularity, as XlaExecutor takes it (checked; the
      stencil's by default). There each group is one jit region; eager
      PyTorch runs stage by stage either way, so nothing here depends
      on it.
    device: 'cuda' (default; raises without a usable GPU) or 'cpu'.
    apply_preserve_border: apply ``border: preserve`` (default). The
      sharded executor passes False: it crops each shard and redoes the
      border against the global grid.

  The same ``prepare``/``fn``/``__call__`` contract as FusedExecutor.
  ``launches`` is always 0: no kernel of this package runs.
  """

  launches = 0

  def __init__(self, stencil, shape: Sequence[int],
               cluster: Optional[str] = None, device='cuda',
               apply_preserve_border: bool = True):
    check_stencil(stencil)
    if cluster not in (None, 'none', 'full', 'coarse', 'fine'):
      raise ValueError('unknown cluster granularity: %s' % cluster)
    self.stencil = stencil
    self.shape = tuple(int(s) for s in shape)
    self.plan = make_tile_plan(stencil, self.shape, self.shape)
    self.device = resolve_device(device)
    self.apply_preserve_border = apply_preserve_border

  def prepare(self, inputs: Mapping[str, np.ndarray],
              params: Optional[Mapping[str, np.ndarray]] = None
              ) -> Tuple[torch.Tensor, ...]:
    return prepare_args(self.stencil, self.shape, self.device, inputs,
                        params)

  def fn(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Positional ``fn(*inputs, *params) -> (outputs...)``."""
    stencil = self.stencil
    check_args(stencil, self.shape, self.device, args)
    n_in = len(stencil.input_names)
    outs = fused_stencil_plain(stencil, args[:n_in], args[n_in:],
                               tile=self.plan)
    if stencil.preserve_border and self.apply_preserve_border:
      outs = fix_border(stencil, self.shape, args[:n_in], outs)
    return outs

  def __call__(self, inputs: Mapping[str, np.ndarray],
               params: Optional[Mapping[str, np.ndarray]] = None
               ) -> Dict[str, torch.Tensor]:
    outs = self.fn(*self.prepare(inputs, params))
    return dict(zip(self.stencil.output_names, outs))
