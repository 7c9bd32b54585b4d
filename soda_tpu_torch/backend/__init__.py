"""Execution backends of the PyTorch/CUDA port.

- fused: one generated CUDA C++ kernel per stencil (FusedExecutor); its
  plain PyTorch version runs the same tiles on the CPU
- get_executor: dispatch (the counterpart of soda_tpu.backend)

The NumPy oracle stays soda_tpu.backend.reference.
"""

from __future__ import annotations

from typing import Tuple

# backends of soda_tpu that the port does not have yet -> ROADMAP item
_NOT_PORTED = {
    'xla': 'ROADMAP A2 (whole-grid executor)',
    'grouped': 'ROADMAP A7 (grouped executor)',
    'replicated': 'ROADMAP A8 (replication)',
    'sharded': 'ROADMAP A9 (sharding over NCCL)',
}


def get_executor(stencil, shape: Tuple[int, ...], backend: str = 'auto',
                 device='cuda'):
  """Build an executor: 'auto' or 'fused' (one fused CUDA kernel).

  ``device`` is explicit: 'cuda' (the default) raises when no usable
  GPU exists; pass 'cpu' to run the kernel's plain version. Backends not
  yet ported raise NotImplementedError naming their ROADMAP item;
  nothing falls back quietly.
  """
  if backend not in ('auto', 'fused'):
    if backend in _NOT_PORTED:
      raise NotImplementedError('backend %r is not ported yet: %s' %
                                (backend, _NOT_PORTED[backend]))
    raise ValueError('unknown backend: %s' % backend)
  if (stencil.cluster or 'none') in ('coarse', 'fine'):
    raise NotImplementedError(
        'cluster: %s runs one kernel per stage group, not ported yet: %s' %
        (stencil.cluster, _NOT_PORTED['grouped']))
  from soda_tpu_torch.backend.fused import FusedExecutor
  return FusedExecutor(stencil, shape, device=device)
