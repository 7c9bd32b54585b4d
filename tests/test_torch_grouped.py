"""The port's grouped executor (``cluster: coarse/fine``) against the
JAX package's.

One fused kernel per stage group, handing full-size tensors from group
to group. On the CPU each group runs its kernel's plain version; it must
agree with ``GroupedPallasExecutor`` (Pallas in interpret mode, as
tests/test_grouped.py runs it) and with the NumPy oracle on the original
stencil's valid regions, the only cells a grouped run defines. The
same kernels as tests/test_grouped.py; each side builds its own stencil
from the same DSL text.
"""

import numpy as np
import pytest
import torch

from soda_tpu import corpus as jax_corpus
from soda_tpu.backend import get_executor as jax_get_executor
from soda_tpu.backend.grouped import GroupedPallasExecutor
from soda_tpu_torch import corpus, get_executor, utils
from soda_tpu_torch.backend import reference
from soda_tpu_torch.backend.grouped import (GroupedExecutor,
                                            group_stencils,
                                            grouped_stencil_plain)
from soda_tpu_torch.testing import check_outputs

torch.set_num_threads(1)

KERNELS = ['blur', 'sobel2d', 'jacobi2d', 'denoise2d', 'heat3d', 'xcorr']


def _numpy(outs):
  return {k: np.asarray(v) for k, v in outs.items()}


@pytest.mark.parametrize('name', KERNELS)
def test_coarse_matches_grouped_pallas_and_oracle(name):
  stencil = corpus.build(name, cluster='coarse')
  jax_stencil = jax_corpus.build(name, cluster='coarse')
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  ex = get_executor(stencil, shape, device='cpu')
  assert isinstance(ex, GroupedExecutor)
  # one kernel per stage; a kernel is counted only where it launches
  assert len(ex.executors) == len(ex.plan.groups) == len(ex.plan.stages)
  got = {k: v.numpy() for k, v in ex(inputs, params).items()}
  assert ex.launches == 0
  pallas = jax_get_executor(jax_stencil, shape, 'pallas')
  assert isinstance(pallas, GroupedPallasExecutor)
  assert len(pallas.executors) == len(ex.executors)
  check_outputs(stencil, shape, got,
                reference.run(stencil, inputs, params), name + ':coarse')
  check_outputs(stencil, shape, got, _numpy(pallas(inputs, params)),
                name + ':coarse vs grouped pallas')


@pytest.mark.parametrize('name', ['blur', 'denoise2d'])
def test_executor_matches_its_plain_version(name):
  stencil = corpus.build(name, cluster='coarse')
  shape = corpus.TEST_DIMS[name]
  ex = GroupedExecutor(stencil, shape, device='cpu')
  args = ex.prepare(reference.make_test_inputs(stencil, shape))
  got = dict(zip(stencil.output_names, ex.fn(*args)))
  plain = grouped_stencil_plain(stencil, args[:len(stencil.input_names)])
  check_outputs(stencil, shape, got, dict(zip(stencil.output_names, plain)),
                name + ' plain', )


def test_fine_behaves_as_coarse():
  shape = corpus.TEST_DIMS['denoise2d']
  outs = []
  for cluster in ('fine', 'coarse'):
    stencil = corpus.build('denoise2d', cluster=cluster)
    ex = get_executor(stencil, shape, device='cpu')
    assert isinstance(ex, GroupedExecutor)
    assert len(ex.executors) == len(ex.plan.stages)
    outs.append(ex(reference.make_test_inputs(stencil, shape)))
  region = reference.output_valid_slices(stencil, shape)
  for out in stencil.output_names:
    np.testing.assert_array_equal(outs[0][out].numpy()[region],
                                  outs[1][out].numpy()[region])


def test_preserve_border_through_groups():
  stencil = corpus.build('jacobi2d', cluster='coarse', border='preserve')
  jax_stencil = jax_corpus.build('jacobi2d', cluster='coarse',
                                 border='preserve')
  shape = corpus.TEST_DIMS['jacobi2d']
  inputs = reference.make_test_inputs(stencil, shape)
  got = {k: v.numpy() for k, v in
         GroupedExecutor(stencil, shape, device='cpu')(inputs).items()}
  # preserve defines every cell, the border included
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                'preserve:grouped', full=True)
  check_outputs(stencil, shape, got,
                _numpy(jax_get_executor(jax_stencil, shape, 'pallas')(inputs)),
                'preserve:grouped vs pallas', full=True)


def test_groups_run_in_chronological_order():
  """The plan's group order follows the hash seed; the executor's order
  is the stencil's own, so each group's kernel source is stable."""
  stencil = corpus.build('denoise2d', cluster='coarse')
  plan, subs = group_stencils(stencil)
  order = [t.name for t in stencil.chronological_tensors]
  names = [sub.output_names[0] for sub in subs]
  assert names == sorted(names, key=order.index)
  assert len(subs) == len(plan.groups)


def test_grid_is_checked_against_the_whole_stencil():
  stencil = corpus.build('denoise2d', cluster='coarse')
  with pytest.raises(utils.InputError):
    GroupedExecutor(stencil, (3, 3), device='cpu')


def test_iterate_clones_keep_their_storage_type():
  """jacobi2d's second sweep reads ``t0_iter1``-style clones, which are
  tensors, not statements; a uint16 handoff stays uint16 storage."""
  stencil = corpus.build('blur', cluster='coarse', iterate=2)
  shape = corpus.TEST_DIMS['blur']
  _, subs = group_stencils(stencil)
  handoffs = [n for sub in subs[1:] for n in sub.input_names]
  assert handoffs and all(
      str(stencil.tensors[n].dtype) == 'uint16' for n in handoffs)
  ex = GroupedExecutor(stencil, shape, device='cpu')
  inputs = reference.make_test_inputs(stencil, shape)
  got = ex(inputs)
  assert all(v.dtype == torch.uint16 for v in got.values())
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                'blur iterate 2 coarse')
