"""The rank form's gate: the JAX package's nine multi-device configs.

    python -m soda_tpu_torch.parallel.dryrun --nproc 4 --backend gloo --device cpu
    python -m soda_tpu_torch.parallel.dryrun --nproc 4 --backend gloo --device cuda:0
    python -m soda_tpu_torch.parallel.dryrun --backend nccl   # one rank a card
    torchrun --nproc-per-node N -m soda_tpu_torch.parallel.dryrun [--backend gloo]

The nine configurations of ``dryrun_multichip`` (__graft_entry__.py:
42-217), copied as data with their shapes and conditions, run on N ranks
of the rank form (parallel/distributed.py) and held against the port's
NumPy oracle: floats within 1e-4 (relative and absolute), integers
equal, on each output's valid region (the whole grid under ``border:
preserve``). Rank 0 prints ``dryrun_multichip OK on N ranks``. Where the
JAX run takes its default inner ('xla') the copy names it.

Under ``torchrun`` (its ``RANK`` in the environment) the process joins
the group torchrun made; otherwise ``--nproc`` ranks are spawned
(parallel/launch.py). ``--device`` is every rank's device; without it a
rank takes ``cuda:LOCAL_RANK``. Under NCCL every rank needs its own card.

The module also holds the rank targets the tests and ``chip_smoke.py``
run (``collect``): a child process imports only the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import shutil
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from soda_tpu_torch import api, corpus, profiling, utils
from soda_tpu_torch.backend import get_executor, reference
from soda_tpu_torch.parallel import launch
from soda_tpu_torch.parallel.distributed import (DistributedShardedExecutor,
                                                 rank_mesh)
from soda_tpu_torch.parallel.spmd import geometry, inner_options

TOLERANCE = 1e-4


@dataclasses.dataclass
class Case:
  """One run of the rank form, the same on every rank.

  ``full``: compare the whole grid (``border: preserve`` defines every
  cell). ``steps``: run ``api.chained(ex, steps)`` in place of one call.
  ``calls``: time that many back-to-back calls (on a card). ``raises``:
  the constructor must raise utils.InputError (its message is kept).
  ``trace``: log the executor's P2P posts, waits and inner calls.
  """
  label: str
  stencil: object
  shape: Tuple[int, ...]
  mesh_shape: Tuple[int, ...]
  axis_names: Optional[Tuple[str, ...]] = None
  dim_axes: object = None
  inner: str = 'fused'
  inner_opts: Optional[Dict] = None
  overlap: str = 'off'
  full: bool = False
  steps: int = 0
  calls: int = 0
  raises: bool = False
  trace: bool = False

  def executor(self, device, trace=None) -> DistributedShardedExecutor:
    """The rank form of the case, through ``get_executor``."""
    return get_executor(
        self.stencil, self.shape, 'sharded', mesh_shape=self.mesh_shape,
        axis_names=self.axis_names, dim_axes=self.dim_axes,
        inner=self.inner, inner_opts=self.inner_opts, overlap=self.overlap,
        device=device, trace=trace)


def configs(n: int) -> List[Case]:
  """The nine configs of ``dryrun_multichip(n)``, in its order (the
  2-D mesh and the ('slice', 'x') ring need an even n >= 4)."""
  even = n % 2 == 0 and n >= 4
  out = [
      # iterate=2 sweeps on one exchange, the whole-grid inner
      Case('jacobi2d xla', corpus.build('jacobi2d'), (8 * n, 32), (n,),
           inner='xla'),
      # a multi-stage integer pipeline, the fused kernel per shard
      Case('sobel2d fused', corpus.build('sobel2d'), (8 * n, 32), (n,)),
  ]
  if even:
    # two-phase exchange: seidel2d's diagonal taps read the corners
    out.append(Case('seidel2d 2-D mesh', corpus.build('seidel2d'),
                    (8 * (n // 2), 16 * 2), (n // 2, 2), ('x', 'y'),
                    inner='xla'))
    # the streaming axis over the flattened ('slice', 'x') ring
    out.append(Case("jacobi2d ('slice', 'x')", corpus.build('jacobi2d'),
                    (8 * n, 32), (2, n // 2), ('slice', 'x'),
                    dim_axes=[('slice', 'x')], inner='xla'))
  out += [
      Case('blur fused, tuned options', corpus.build('blur'), (16 * n, 32),
           (n,), inner_opts={'stage_mode': 'value', 'shift_mode': 'roll',
                             'stream_loop': 'peel', 'prefetch': 3,
                             'block_rows': 8}),
      Case('jacobi3d fused, mid tiles', corpus.build('jacobi3d'),
           (8 * n, 16, 32), (n,),
           inner_opts={'stage_mode': 'value', 'mid_tile': 8,
                       'dma_split': 2}),
      Case('sobel2d grouped', corpus.build('sobel2d'), (8 * n, 32), (n,),
           inner='grouped'),
      Case('jacobi2d overlap', corpus.build('jacobi2d'), (16 * n, 32), (n,),
           inner='xla', overlap='on'),
      # an extent that does not divide, and the global border
      Case('jacobi2d preserve, padded', corpus.build('jacobi2d',
                                                     border='preserve'),
           (8 * n + 3, 32), (n,), inner='xla', full=True),
  ]
  return out


def kernel_sources(cases: Sequence[Case]) -> List[object]:
  """The CUDA sources the kernel inners of ``cases`` build on a rank
  (``cuda_source.KernelSource``), for one nvcc batch ahead of a run."""
  from soda_tpu_torch.backend import cuda_source, grouped
  from soda_tpu_torch.backend.tile_plan import kernel_plan
  out = []
  for case in cases:
    inner, opts = inner_options(case.inner, case.inner_opts)
    if case.raises or inner == 'xla':
      continue
    ext = geometry(case.stencil, case.shape,
                   rank_mesh(case.mesh_shape, case.axis_names,
                             ['cpu'] * int(np.prod(case.mesh_shape))),
                   case.dim_axes)[-1]
    subs = (grouped.group_stencils(case.stencil)[1] if inner == 'grouped'
            else [case.stencil])
    out += [cuda_source.generate(kernel_plan(sub, ext, **opts))
            for sub in subs]
  return out


def inputs_of(case: Case):
  """The seeded numpy inputs and params of a case (the oracle's)."""
  return (reference.make_test_inputs(case.stencil, case.shape),
          reference.make_test_params(case.stencil))


def check(case: Case, got: Dict[str, np.ndarray],
          want: Dict[str, np.ndarray]) -> None:
  """Raise AssertionError unless ``got`` matches ``want`` by the
  dryrun's rule: integers equal, floats within 1e-4."""
  for name in case.stencil.output_names:
    region = (slice(None),) * len(case.shape) if case.full else \
        reference.output_valid_slices(case.stencil, case.shape, name)
    g, w = np.asarray(got[name])[region], np.asarray(want[name])[region]
    where = '%s:%s' % (case.label, name)
    if case.stencil.symbol_table[name].is_float:
      np.testing.assert_allclose(g, w, rtol=TOLERANCE, atol=TOLERANCE,
                                 err_msg=where)
    else:
      np.testing.assert_array_equal(g, w, err_msg=where)


def run_case(case: Case, device) -> Dict[str, object]:
  """One case on this rank: the gathered outputs (numpy), this rank's
  launches, P2P batches and halo bytes of the call (or of the chained
  run), and where asked the back-to-back µs a call (and the inner's
  alone) and the trace of the call."""
  if case.raises:
    try:
      case.executor(device)
    except utils.InputError as err:
      return {'label': case.label, 'error': str(err)}
    return {'label': case.label, 'error': None}
  log: List[str] = []
  ex = case.executor(device, log.append if case.trace else None)
  inputs, params = inputs_of(case)
  args = ex.prepare(inputs, params)
  ex.launches = ex.exchanges = ex.halo_bytes = 0
  if case.steps:
    outs = api.chained(ex, case.steps)(*args)
  else:
    outs = ex.fn(*args)
  result = {'label': case.label, 'launches': ex.launches,
            'exchanges': ex.exchanges, 'halo_bytes': ex.halo_bytes,
            'ext_shape': ex.ext_shape, 'repr': repr(ex), 'order': log,
            'outputs': {k: v.cpu().numpy()
                        for k, v in ex.gather(outs).items()}}
  if case.calls:
    result['host_us'], result['device_us'] = profiling.back_to_back_us(
        lambda: ex.fn(*args), calls=case.calls)
    # a kernel inner alone on the halo-extended shard, one rank at a
    # time, the others waiting: its launches replayed from a CUDA graph,
    # with the card to themselves (no host, no exchange)
    result['inner_us'] = None
    if ex.inner != 'xla':
      n_in = len(case.stencil.input_names)
      ext = [torch.zeros(ex.ext_shape, dtype=t.dtype, device=t.device)
             for t in args[:n_in]]
      for rank in range(ex.world_size):
        dist.barrier()
        if rank == ex.rank:
          result['inner_us'] = profiling.replay_us(
              lambda: ex._run(ext, args[n_in:]), calls=case.calls)
      dist.barrier()
  return result


def gate(device=None) -> None:
  """Rank target: the nine configs, each against the oracle."""
  n = dist.get_world_size()
  if device is not None and torch.device(device).type == 'cpu':
    torch.set_num_threads(1)  # the ranks share the host's cores
  for case in configs(n):
    got = run_case(case, device)['outputs']
    inputs, params = inputs_of(case)
    check(case, got, reference.run(case.stencil, inputs, params))
  if dist.get_rank() == 0:
    print('dryrun_multichip OK on %d ranks' % n, flush=True)


def collect(out_dir: str, cases: Sequence[Case], device=None) -> None:
  """Rank target: ``run_case`` over ``cases``; rank r writes its
  results to ``out_dir/rank<r>.pkl`` (outputs from rank 0 alone)."""
  rank = dist.get_rank()
  if device is not None and torch.device(device).type == 'cpu':
    torch.set_num_threads(1)
  results = []
  for case in cases:
    result = run_case(case, device)
    if rank and 'outputs' in result:
      del result['outputs']
    results.append(result)
  with open(os.path.join(out_dir, 'rank%d.pkl' % rank), 'wb') as f:
    pickle.dump(results, f)


def collect_world(cases: Sequence[Case], nproc: int, backend: str,
                  device=None) -> List[List[Dict[str, object]]]:
  """Spawn ``nproc`` ranks that ``collect`` ``cases``; per rank, its
  results in case order."""
  out_dir = tempfile.mkdtemp(prefix='soda_collect_')
  try:
    launch.spawn(collect, nproc, backend, out_dir, list(cases), device)
    ranks = []
    for rank in range(nproc):
      # written by the ranks just spawned
      with open(os.path.join(out_dir, 'rank%d.pkl' % rank), 'rb') as f:
        ranks.append(pickle.load(f))
    return ranks
  finally:
    shutil.rmtree(out_dir, ignore_errors=True)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--nproc', type=int, default=None,
                      help='ranks to spawn (default: one a visible card); '
                      'ignored under torchrun')
  parser.add_argument('--backend', choices=launch.BACKENDS, default='nccl')
  parser.add_argument('--device', default=None,
                      help='every rank\'s device (cpu, cuda:0); default '
                      'cuda:LOCAL_RANK')
  args = parser.parse_args(argv)
  if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
    launch.init_from_env(args.backend)
    gate(args.device)
    dist.destroy_process_group()
    return 0
  nproc = args.nproc or torch.cuda.device_count()
  if nproc < 1:
    print('dryrun: no CUDA device; pass --nproc N --backend gloo --device '
          'cpu', file=sys.stderr)
    return 1
  launch.spawn(gate, nproc, args.backend, args.device)
  return 0


if __name__ == '__main__':
  sys.exit(main())
