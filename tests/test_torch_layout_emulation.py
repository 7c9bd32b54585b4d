"""The layout forms' generated CUDA, run on the CPU by an emulation.

The kernel text of a layout plan (backend/cuda_source.py: the value
forms' warp windows ``_value_blocks``, the transposed regions, the
packed 16-bit stages, the chunked stage loops) is compiled with g++
against tests/torch_emulation.py: 512 host threads a CTA, warps of
32 with their own barrier (``__syncwarp``), ``__shfl_sync`` as a
per-warp exchange between two of those barriers, ``__vadd2`` and
``__byte_perm`` as PTX defines them, under AddressSanitizer and UBSan.
A shuffle that not all 32 lanes reach deadlocks the emulation, which
the run's time limit turns into a failure. Each case's outputs are held
against the NumPy oracle on their valid regions (integers bit-exact,
floats within the reference threshold) and against the form's plain
version (``layout_stencil_plain``).
"""

import concurrent.futures
import shutil

import numpy as np
import pytest
import torch

from soda_tpu_torch.backend import reference, tile_plan
from soda_tpu_torch.backend.fused import layout_stencil_plain, prepare_args
from soda_tpu_torch.testing import (LAYOUT_CASES as CASES, check_outputs,
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
  tmp = tmp_path_factory.mktemp('layout_emu')
  plans = [_plan(case) for case in CASES]
  with concurrent.futures.ThreadPoolExecutor(4) as pool:
    exes = list(pool.map(lambda i: compile_kernel(gxx, tmp, i, plans[i],
                                                  CASES[i][4]),
                         range(len(CASES))))
  return tmp, plans, exes


@pytest.mark.parametrize('index', range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_layout_kernel_matches_oracle(built, index):
  tmp, plans, exes = built
  name, shape, _, _, reps = CASES[index]
  plan = plans[index]
  stencil = plan.stencil
  grids = mode_inputs(stencil, name, shape, reps)
  params = reference.make_test_params(stencil)
  outs = run_kernel(exes[index], tmp, stencil, grids, params, False)
  for r, grid in enumerate(grids):
    got = {n: o.reshape((len(grids),) + shape)[r]
           for n, o in zip(stencil.output_names, outs)}
    with np.errstate(all='ignore'):
      want = reference.run(stencil, grid, params)
    check_outputs(stencil, shape, got, want, '%s replica %d' % (name, r))
    args = prepare_args(stencil, shape, torch.device('cpu'), grid, params)
    n_in = len(stencil.input_names)
    plain = layout_stencil_plain(stencil, args[:n_in], args[n_in:],
                                 tile=plan)
    check_outputs(stencil, shape, got,
                  dict(zip(stencil.output_names, plain)),
                  '%s replica %d vs layout_stencil_plain' % (name, r))


def test_cases_reach_every_form():
  """The cases above cover each form and each path of the value forms."""
  seen = set()
  for case in CASES:
    plan = _plan(case)
    layout = plan.layout
    seen.add(layout.form)
    if plan.warp is not None:
      seen.add('roll' if layout.roll else 'window')
      seen.add('rotate' if layout.rotate else 'slice')
      seen.add('%d-D' % plan.dim)
      if plan.config.stream_loop:
        seen.add('stream')
      if plan.rolling:
        seen.add('rolling')
      if plan.config.out_dma:
        seen.add('out_dma')
      if case[4] > 1:
        seen.add('replicas')
      if plan.stencil.param_stmts:
        seen.add('params')
      if any(plan.dtype(n).np_dtype.itemsize == 8 for n in plan.spans):
        seen.add('64-bit')
      if layout.narrow16 and not layout.rotate:
        seen.add('narrow slice')
    elif plan.config.stream_loop:
      seen.add('chunked stream')
  assert seen >= {'L1', 'L2', 'L3', 'L4', 'roll', 'window', 'rotate',
                  'slice', '2-D', '3-D', 'stream', 'rolling', 'out_dma',
                  'replicas', 'params', '64-bit', 'narrow slice',
                  'chunked stream'}, sorted(seen)
