"""The mode kernels' generated CUDA, run on the CPU by an emulation.

There is no nvcc here, so the kernel text of a mode plan (stream_loop,
prefetch, dma_split, out_dma: backend/cuda_source.py ``_mode_kernel``)
is compiled with g++ against the emulation of tests/torch_emulation.py:
a CTA is 512 host threads, ``__syncthreads`` a barrier, shared memory
one buffer per CTA filled with a non-zero pattern first, and
``soda::cp_async`` a copy that lands when ``cp_async_wait`` retires its
group (deferred) or at once (eager): a kernel right under both orders
reads no slot before its copies land and overwrites none that is still
read. Each copy's alignment is checked, and the build runs under
AddressSanitizer, so a read past an input or past shared memory fails.
Each kernel's outputs are held against the NumPy oracle on their valid
regions: integers bit-exact, floats within the reference threshold.
The card runs the same text (tests/test_torch_gpu.py, chip_smoke.py).
"""

import concurrent.futures
import shutil

import numpy as np
import pytest

from soda_tpu_torch.backend import reference, tile_plan
from soda_tpu_torch.testing import (MODE_CASES as CASES, check_outputs,
                                    mode_inputs, mode_stencil)

from torch_emulation import compile_kernel, run_kernel


def _case_id(case):
  name, shape, opts, min_ctas, reps = case
  keys = '-'.join('%s=%s' % kv for kv in sorted(opts.items()))
  return '%s-%s-%s-ctas%d-r%d' % (name, 'x'.join(map(str, shape)), keys,
                                  min_ctas, reps)


def _plan(case):
  name, shape, opts, min_ctas, _ = case
  saved = tile_plan.MIN_CTAS
  tile_plan.MIN_CTAS = min_ctas
  try:
    return tile_plan.kernel_plan(mode_stencil(name), shape, **opts)
  finally:
    tile_plan.MIN_CTAS = saved


@pytest.fixture(scope='module')
def built(tmp_path_factory):
  """Every case's plan and emulation (the compilers run at once)."""
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('no g++ on this machine')
  tmp = tmp_path_factory.mktemp('emu')
  plans = [_plan(case) for case in CASES]
  with concurrent.futures.ThreadPoolExecutor(4) as pool:
    exes = list(pool.map(lambda i: compile_kernel(gxx, tmp, i, plans[i],
                                                  CASES[i][4]),
                         range(len(CASES))))
  return tmp, plans, exes


@pytest.mark.parametrize('index', range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_mode_kernel_matches_oracle(built, index):
  tmp, plans, exes = built
  name, shape, _, _, reps = CASES[index]
  stencil = plans[index].stencil
  grids = mode_inputs(stencil, name, shape, reps)
  params = reference.make_test_params(stencil)
  for eager in (False, True):
    outs = run_kernel(exes[index], tmp, stencil, grids, params, eager)
    for r, grid in enumerate(grids):
      got = {n: o.reshape((len(grids),) + shape)[r]
             for n, o in zip(stencil.output_names, outs)}
      with np.errstate(all='ignore'):
        want = reference.run(stencil, grid, params)
      check_outputs(stencil, shape, got, want, '%s %s replica %d' % (
          name, 'eager' if eager else 'deferred', r))


def test_cases_reach_every_path():
  """The cases above cover each branch of the generated mode kernel."""
  plans = [_plan(case) for case in CASES]
  seen = set()
  for plan in plans:
    cfg = plan.config
    seen.add('slots%d' % plan.slots)
    seen.add('split' if cfg.dma_split > 1 else 'whole fill')
    if plan.rolling:
      seen.add('rolling')
    if plan.peel and plan.steady[0] <= plan.steady[1]:
      seen.add('peel steady')
    elif cfg.stream_loop == 'peel':
      seen.add('peel under 4 steps')
    if plan.n_chunks > 1 and plan.grid[0] % plan.steps:
      seen.add('ragged last run')
    for name in plan.stencil.input_names:
      if plan.buffered(name):
        width, phase = tile_plan.copy_width(plan.stencil, name, plan.shape,
                                            plan.tile, plan.spans)
        itemsize = plan.dtype(name).np_dtype.itemsize
        seen.add('copy %d/%d phase %d' % (width, itemsize, phase))
    if cfg.out_dma:
      for name in plan.stencil.output_names:
        itemsize = plan.dtype(name).np_dtype.itemsize
        vec = (plan.tile[-1] * itemsize % 16 == 0 and
               plan.shape[-1] * itemsize % 16 == 0)
        seen.add('store16' if vec else 'store element')
  assert seen >= {
      'slots1', 'slots2', 'slots3', 'slots4', 'split', 'whole fill',
      'rolling', 'peel steady', 'peel under 4 steps', 'ragged last run',
      'copy 4/2 phase 0', 'copy 4/2 phase 1', 'copy 0/2 phase 0',
      'copy 0/1 phase 0', 'copy 4/4 phase 0', 'copy 8/8 phase 0',
      'store16', 'store element'}, sorted(seen)
