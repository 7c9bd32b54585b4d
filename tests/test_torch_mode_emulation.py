"""The mode kernels' generated CUDA, run on the CPU by an emulation.

There is no nvcc here, so the kernel text of a mode plan (stream_loop,
prefetch, dma_split, out_dma) is compiled with g++ against the
emulation of tests/torch_emulation.py: a CTA is 512 host threads,
``__syncthreads`` a barrier, shared memory one buffer per CTA filled
with a non-zero pattern first, and ``soda::cp_async`` a copy that lands
when ``cp_async_wait`` retires its group (deferred) or at once (eager):
a kernel right under both orders reads no slot before its copies land
and overwrites none that is still read. Each copy's alignment is
checked, and the build runs under AddressSanitizer, so a read past an
input or past shared memory fails. Each case runs twice: the kernel the
keys build, the short form (backend/cuda_source.py ``_short_kernel``:
the walk at the ``prefetch`` depth, split fills, staged stores), and
the old mode kernel the same keys build with ``_short=()``
(``_mode_kernel``). Each is held against the NumPy oracle on the valid
regions, integers bit-exact and floats within the reference threshold,
and the short form also against the old kernel. The card runs the same
text (tests/test_torch_gpu.py, chip_smoke.py).
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


def _plan(case, old=True):
  """The case's plan: the old mode kernel's (``_short=()``), or with
  ``old=False`` the short form's that its keys build."""
  name, shape, opts, min_ctas, _ = case
  saved = tile_plan.MIN_CTAS
  tile_plan.MIN_CTAS = min_ctas
  try:
    return tile_plan.kernel_plan(mode_stencil(name), shape, **opts,
                                 **({'_short': ()} if old else {}))
  finally:
    tile_plan.MIN_CTAS = saved


@pytest.fixture(scope='module')
def built(tmp_path_factory):
  """Every case's plans and emulations, the old mode kernel's first,
  then the short form's (the compilers run at once), and a cache of
  their runs."""
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('no g++ on this machine')
  tmp = tmp_path_factory.mktemp('emu')
  plans = [_plan(case) for case in CASES] + [_plan(case, False)
                                             for case in CASES]
  with concurrent.futures.ThreadPoolExecutor(6) as pool:
    exes = list(pool.map(lambda i: compile_kernel(
        gxx, tmp, i, plans[i], CASES[i % len(CASES)][4]), range(len(plans))))
  return tmp, plans, exes, {}


def _run(built, index, eager):
  """Each replica's outputs of emulation ``index`` (cached)."""
  tmp, plans, exes, runs = built
  if (index, eager) not in runs:
    name, shape, _, _, reps = CASES[index % len(CASES)]
    stencil = plans[index].stencil
    grids = mode_inputs(stencil, name, shape, reps)
    params = reference.make_test_params(stencil)
    outs = run_kernel(exes[index], tmp, stencil, grids, params, eager)
    runs[index, eager] = grids, params, [
        {n: o.reshape((len(grids),) + shape)[r]
         for n, o in zip(stencil.output_names, outs)}
        for r in range(len(grids))]
  return runs[index, eager]


def _check_oracle(built, index):
  name, shape = CASES[index % len(CASES)][:2]
  stencil = built[1][index].stencil
  for eager in (False, True):
    grids, params, got = _run(built, index, eager)
    for r, grid in enumerate(grids):
      with np.errstate(all='ignore'):
        want = reference.run(stencil, grid, params)
      check_outputs(stencil, shape, got[r], want, '%s %s replica %d' % (
          name, 'eager' if eager else 'deferred', r))


@pytest.mark.parametrize('index', range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_mode_kernel_matches_oracle(built, index):
  assert built[1][index].short is None  # the old mode kernel
  _check_oracle(built, index)


@pytest.mark.parametrize('index', range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_short_form_modes_match_oracle_and_old_kernel(built, index):
  """The short form the keys build: against the oracle, and against
  the old mode kernel's emulation (integers bit for bit, floats within
  the reference threshold)."""
  new = index + len(CASES)
  plan = built[1][new]
  assert plan.short is not None and plan.config == built[1][index].config
  _check_oracle(built, new)
  name, shape = CASES[index][:2]
  grids, _, old = _run(built, index, False)
  _, _, got = _run(built, new, False)
  for r in range(len(grids)):
    check_outputs(plan.stencil, shape, got[r], old[r],
                  '%s replica %d vs the old mode kernel' % (name, r))


def test_short_form_cases_reach_every_path():
  """The cases cover each branch the modes add to the short form: the
  walk at depths 2-4 with runs of several steps, cut by the grid's end,
  and of one; split fills; staged stores of 16 bytes and of one
  element; 16-byte units and the element path."""
  seen = set()
  for case in CASES:
    plan = _plan(case, False)
    short, cfg = plan.short, plan.config
    seen.add('depth%d' % short.depth if short.has('walk') else 'no walk')
    seen.add('vec' if short.vec > 1 else 'element')
    if short.has('walk') and plan.steps > 1:
      seen.add('run')
      if plan.grid[0] % plan.steps:
        seen.add('ragged last run')
    if cfg.dma_split > 1:
      seen.add('split walk' if short.has('walk') else 'split')
    for name in plan.staging:
      itemsize = plan.dtype(name).np_dtype.itemsize
      seen.add('store16' if plan.tile[-1] * itemsize % 16 == 0 and
               plan.shape[-1] * itemsize % 16 == 0 else 'store element')
  assert seen >= {'depth2', 'depth3', 'depth4', 'no walk', 'vec', 'element',
                  'run', 'ragged last run', 'split walk', 'store16',
                  'store element'}, sorted(seen)


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
