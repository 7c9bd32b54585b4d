"""Execution backends of the PyTorch/CUDA port.

- fused: one generated CUDA C++ kernel per stencil (FusedExecutor); its
  plain PyTorch version runs the same tiles on the CPU
- grouped: one fused kernel per stage group under ``cluster:
  coarse/fine`` (GroupedExecutor)
- replicated: R independent grids per call, one launch per kernel
  (soda_tpu_torch.parallel.replicate.ReplicatedExecutor)
- get_executor: dispatch (the counterpart of soda_tpu/backend/__init__.py)

The NumPy oracle is backend/reference.py.
"""

from __future__ import annotations

from typing import Tuple

# backends of the JAX package that the port does not have yet -> ROADMAP
_NOT_PORTED = {
    'xla': 'ROADMAP A2 (whole-grid executor)',
    'sharded': 'ROADMAP A9 (sharding over NCCL)',
}


def get_executor(stencil, shape: Tuple[int, ...], backend: str = 'auto',
                 device='cuda', **kwargs):
  """Build an executor.

  'auto' or 'fused': one fused CUDA kernel, or, under ``cluster:
  coarse/fine``, one per stage group (GroupedExecutor); ``replicas=R``
  batches R grids per call. 'replicated': ReplicatedExecutor
  (``replication_factor``; inputs of shape ``(R, *shape)``).

  ``device`` is explicit: 'cuda' (the default) raises when no usable
  GPU exists; pass 'cpu' to run the kernels' plain versions. Backends
  not yet ported raise NotImplementedError naming their ROADMAP item;
  nothing falls back quietly.
  """
  if backend == 'replicated':
    from soda_tpu_torch.parallel.replicate import ReplicatedExecutor
    return ReplicatedExecutor(stencil, shape, device=device, **kwargs)
  if backend not in ('auto', 'fused'):
    if backend in _NOT_PORTED:
      raise NotImplementedError('backend %r is not ported yet: %s' %
                                (backend, _NOT_PORTED[backend]))
    raise ValueError('unknown backend: %s' % backend)
  if (stencil.cluster or 'none') in ('coarse', 'fine'):
    # one kernel per stage group, handing off through device memory
    # (fine == coarse, as in the fusion plan)
    from soda_tpu_torch.backend.grouped import GroupedExecutor
    return GroupedExecutor(stencil, shape, device=device, **kwargs)
  from soda_tpu_torch.backend.fused import FusedExecutor
  return FusedExecutor(stencil, shape, device=device, **kwargs)
