"""The layout forms' generated CUDA, run on the CPU by an emulation.

The kernel text of a layout plan is compiled with g++ against
tests/torch_emulation.py: 512 host threads a CTA, warps of 32 with their
own barrier (``__syncwarp``), ``__shfl_sync`` as a per-warp exchange
between two of those barriers, ``__vadd2`` and ``__byte_perm`` as PTX
defines them, ``cp.async`` copies landing when their group is retired
(deferred) or at once (eager), under AddressSanitizer and UBSan. A
shuffle that not all 32 lanes reach deadlocks the emulation, which the
run's time limit turns into a failure.

Two forms the same keys build:

- the short form's layout element (backend/cuda_source.py
  ``_short_kernel``'s region: register rows, lane rotates, packed 16-bit
  pairs; ``compute_chunk`` the short form itself), what the keys build:
  every ``LAYOUT_CASES`` case and ``LAYOUT_SHORT_EXTRA``, deferred and
  eager, against the NumPy oracle on the valid regions (integers
  bit-exact, floats within the reference threshold) and against the
  plan's plain version (``fused.plain_version``); the semantics fuzz
  programs under three key sets against the oracle;
- the old layout forms (``_short=()``: the warp windows
  ``_value_blocks``, the transposed regions, the packed stages, the
  chunked stage loops), against the oracle and ``layout_stencil_plain``.
"""

import concurrent.futures
import shutil

import numpy as np
import pytest
import torch

from soda_tpu_torch.backend import reference, tile_plan
from soda_tpu_torch.backend.fused import (layout_stencil_plain, plain_version,
                                          prepare_args)
from soda_tpu_torch.testing import (FUZZ_SEEDS, LAYOUT_CASES as CASES,
                                    LAYOUT_SHORT_EXTRA, check_outputs,
                                    mode_inputs, mode_stencil)

from torch_emulation import compile_kernel, run_kernel

SHORT_CASES = CASES + LAYOUT_SHORT_EXTRA
# the semantics fuzz programs (every integer width and sign, half, float,
# double) in value mode, with 'rotate', with 'slice' and transposed lane
# regions, and packed under narrow with roll, one key set a seed in turn
FUZZ_KEYS = ({'stage_mode': 'value'},
             {'stage_mode': 'value', 'lane_shift': 'slice',
              'transpose_lanes': 'on'},
             {'stage_mode': 'value', 'narrow': 'on', 'shift_mode': 'roll'})
FUZZ_CASES = tuple(('fuzz%d' % seed, (20, 48), FUZZ_KEYS[seed % 3], 1, 1)
                   for seed in FUZZ_SEEDS)


def _case_id(case):
  name, shape, opts, min_ctas, reps = case
  keys = '-'.join('%s=%s' % kv for kv in sorted(opts.items()))
  return '%s-%s-%s-ctas%d-r%d' % (name, 'x'.join(map(str, shape)), keys,
                                  min_ctas, reps)


def _plan(case, old=True):
  """The case's plan: the old layout form's (``_short=()``), or with
  ``old=False`` the short form's that its keys build."""
  name, shape, opts, min_ctas, _ = case
  saved = tile_plan.MIN_CTAS
  tile_plan.MIN_CTAS = min_ctas
  try:
    return tile_plan.kernel_plan(mode_stencil(name), shape, **opts,
                                 **({'_short': ()} if old else {}))
  finally:
    tile_plan.MIN_CTAS = saved


def _compile_all(tmp, plans, cases):
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('no g++ on this machine')
  with concurrent.futures.ThreadPoolExecutor(4) as pool:
    return list(pool.map(lambda i: compile_kernel(gxx, tmp, i, plans[i],
                                                  cases[i][4]),
                         range(len(cases))))


@pytest.fixture(scope='module')
def built(tmp_path_factory):
  """Every case's old layout plan and emulation (the compilers run at
  once)."""
  tmp = tmp_path_factory.mktemp('layout_emu')
  plans = [_plan(case) for case in CASES]
  return tmp, plans, _compile_all(tmp, plans, CASES)


@pytest.fixture(scope='module')
def built_short(tmp_path_factory):
  """Every short case's plan and emulation (the compilers run at once)."""
  tmp = tmp_path_factory.mktemp('layout_short_emu')
  plans = [_plan(case, old=False) for case in SHORT_CASES]
  return tmp, plans, _compile_all(tmp, plans, SHORT_CASES)


@pytest.fixture(scope='module')
def built_fuzz(tmp_path_factory):
  """Every fuzz case's short-form plan and emulation."""
  tmp = tmp_path_factory.mktemp('layout_fuzz_emu')
  plans = [_plan(case, old=False) for case in FUZZ_CASES]
  return tmp, plans, _compile_all(tmp, plans, FUZZ_CASES)


@pytest.mark.parametrize('index', range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_layout_kernel_matches_oracle(built, index):
  """The old layout form (``_short=()``) against the oracle and its
  plain version."""
  tmp, plans, exes = built
  name, shape, _, _, reps = CASES[index]
  plan = plans[index]
  assert plan.short is None
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


@pytest.mark.parametrize('eager', [False, True], ids=['deferred', 'eager'])
@pytest.mark.parametrize('index', range(len(SHORT_CASES)),
                         ids=[_case_id(c) for c in SHORT_CASES])
def test_short_layout_kernel_matches_oracle_and_plain(built_short, index,
                                                      eager):
  """The short form's layout element the keys build, its cp.async copies
  landing late and at once: against the oracle and the plan's plain
  version."""
  tmp, plans, exes = built_short
  name, shape, _, _, reps = SHORT_CASES[index]
  plan = plans[index]
  assert plan.short is not None and plan.warp is None
  stencil = plan.stencil
  grids = mode_inputs(stencil, name, shape, reps)
  params = reference.make_test_params(stencil)
  outs = run_kernel(exes[index], tmp, stencil, grids, params, eager)
  plain = plain_version(plan)
  for r, grid in enumerate(grids):
    got = {n: o.reshape((len(grids),) + shape)[r]
           for n, o in zip(stencil.output_names, outs)}
    with np.errstate(all='ignore'):
      want = reference.run(stencil, grid, params)
    check_outputs(stencil, shape, got, want, '%s replica %d' % (name, r))
    args = prepare_args(stencil, shape, torch.device('cpu'), grid, params)
    n_in = len(stencil.input_names)
    check_outputs(stencil, shape, got, dict(zip(
        stencil.output_names, plain(stencil, args[:n_in], args[n_in:],
                                    plan))),
                  '%s replica %d vs %s' % (name, r, plain.__name__))


@pytest.mark.parametrize('index', range(len(FUZZ_CASES)),
                         ids=[_case_id(c) for c in FUZZ_CASES])
def test_short_layout_fuzz_matches_oracle(built_fuzz, index):
  """A random program's layout element (each type, each key set in
  turn) against the NumPy oracle, its copies landing late."""
  tmp, plans, exes = built_fuzz
  name, shape, _, _, reps = FUZZ_CASES[index]
  plan = plans[index]
  assert plan.short is not None and plan.short.region is not None
  stencil = plan.stencil
  grids = mode_inputs(stencil, name, shape, reps)
  params = reference.make_test_params(stencil)
  outs = run_kernel(exes[index], tmp, stencil, grids, params, False)
  got = {n: o.reshape(shape) for n, o in zip(stencil.output_names, outs)}
  with np.errstate(all='ignore'):
    want = reference.run(stencil, grids[0], params)
  check_outputs(stencil, shape, got, want, name)


def test_cases_reach_every_form():
  """The cases above cover each old form and each path of the old value
  forms."""
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


def test_short_cases_reach_every_path():
  """The short cases cover each branch the layout element adds to the
  short form: register rows with axis-0 halos, lane rotates and a
  window's unstored edges, several windows a row and several windows a
  warp, inline members, exits into a buffer, packed pairs and pairs off,
  a member off for 'slice' and for an axis-1 read, transposed members
  under 'slice', the walk, staged stores, 16-byte units and the element
  path, replicas, params, 64-bit cells, 3-D, and compute_chunk."""
  seen = set()
  for case in SHORT_CASES:
    plan = _plan(case, old=False)
    short, reg = plan.short, plan.short.region
    seen.add('%d-D' % plan.dim)
    seen.add('vec' if short.vec > 1 else 'element')
    if 'chunk' in short.layout:
      seen.add('chunk')
    if 'packed' in short.off:
      seen.add('pairs off')
    if reg is None:
      continue
    if any(sum(reg.halo[m]) for m in reg.arrays):
      seen.add('halo rows')
    if sum(reg.edge):
      seen.add('rotates')
    if reg.windows > 1:
      seen.add('windows a row')
    if reg.lanes < 32:
      seen.add('windows a warp')
    if reg.inline:
      seen.add('inline')
    if any(plan.buffered(e) for e in reg.exits):
      seen.add('exit buffer')
    if reg.packed:
      seen.add('packed')
    if any('slice' in why for why in reg.off.values()):
      seen.add('slice off')
    if any('axis between' in why for why in reg.off.values()):
      seen.add('axis-1 off')
    if not plan.layout.rotate and any(m in plan.layout.transposed
                                      for m in reg.members):
      seen.add('transposed')
    if short.has('walk') and plan.steps > 1:
      seen.add('walk')
    if plan.config.out_dma:
      seen.add('out_dma')
    if case[4] > 1:
      seen.add('replicas')
    if plan.stencil.param_stmts:
      seen.add('params')
    if any(plan.dtype(n).np_dtype.itemsize == 8 for n in reg.members):
      seen.add('64-bit')
  assert seen >= {'2-D', '3-D', 'vec', 'element', 'chunk', 'pairs off',
                  'halo rows', 'rotates', 'windows a row', 'windows a warp',
                  'inline', 'exit buffer', 'packed', 'slice off', 'axis-1 off',
                  'transposed', 'walk', 'out_dma', 'replicas', 'params',
                  '64-bit'}, sorted(seen)
