"""Execution backends of the PyTorch/CUDA port.

- fused: one generated CUDA C++ kernel per stencil (FusedExecutor); its
  plain PyTorch version runs the same tiles on the CPU
- grouped: one fused kernel per stage group under ``cluster:
  coarse/fine`` (GroupedExecutor)
- xla: the whole-grid executor, the fused kernel's plain version over
  the whole grid as one tile (backend/whole_grid.py; the JAX package's
  name)
- replicated: R independent grids per call, one launch per kernel
  (soda_tpu_torch.parallel.replicate.ReplicatedExecutor)
- sharded: the grid split over a device mesh with a halo exchange
  (soda_tpu_torch.parallel.spmd.ShardedExecutor), or its rank form, one
  process per shard (soda_tpu_torch.parallel.distributed)
- get_executor: dispatch (the counterpart of soda_tpu/backend/__init__.py)

The NumPy oracle is backend/reference.py.
"""

from __future__ import annotations

from typing import Tuple


def get_executor(stencil, shape: Tuple[int, ...], backend: str = 'auto',
                 device='cuda', **kwargs):
  """Build an executor.

  'auto' or 'fused': one fused CUDA kernel, or, under ``cluster:
  coarse/fine``, one per stage group (GroupedExecutor); ``replicas=R``
  batches R grids per call. Where the tile plan does not fit shared
  memory this raises the plan's InputError: ``cluster: coarse`` (one
  kernel per stage group) and 'xla' are the explicit ways out; nothing
  falls back quietly. 'xla': WholeGridExecutor (``cluster``; plain
  PyTorch, no kernel). 'replicated': ReplicatedExecutor
  (``replication_factor``, ``mesh``, ``backend``; inputs of shape
  ``(R, *shape)``). 'sharded': ShardedExecutor (``mesh``, ``inner``,
  ``dim_axes``, ``inner_opts``, ``overlap``); given a ``mesh_shape``
  (a shape of ranks, not devices), the rank form
  DistributedShardedExecutor (``axis_names`` and the same options),
  built on every rank of the default process group.

  ``device`` is explicit: 'cuda' (the default) raises when no usable
  GPU exists; pass 'cpu' to run the kernels' plain versions.
  """
  if backend == 'replicated':
    from soda_tpu_torch.parallel.replicate import ReplicatedExecutor
    return ReplicatedExecutor(stencil, shape, device=device, **kwargs)
  if backend == 'sharded' and kwargs.get('mesh_shape') is not None:
    from soda_tpu_torch.parallel.distributed import \
        DistributedShardedExecutor
    return DistributedShardedExecutor(stencil, shape, device=device, **kwargs)
  if backend == 'sharded':
    from soda_tpu_torch.parallel.spmd import ShardedExecutor
    kwargs.pop('mesh_shape', None)
    return ShardedExecutor(stencil, shape, device=device, **kwargs)
  if backend == 'xla':
    from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
    return WholeGridExecutor(stencil, shape, device=device, **kwargs)
  if backend not in ('auto', 'fused'):
    raise ValueError('unknown backend: %s' % backend)
  if (stencil.cluster or 'none') in ('coarse', 'fine'):
    # one kernel per stage group, handing off through device memory
    # (fine == coarse, as in the fusion plan)
    from soda_tpu_torch.backend.grouped import GroupedExecutor
    return GroupedExecutor(stencil, shape, device=device, **kwargs)
  from soda_tpu_torch.backend.fused import FusedExecutor
  return FusedExecutor(stencil, shape, device=device, **kwargs)
