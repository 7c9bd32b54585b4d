"""The port's whole-grid executor against the JAX package's.

``WholeGridExecutor`` (``get_executor(..., 'xla')``) is the fused
kernel's plain version with the whole grid as one tile. It must agree
with ``soda_tpu.backend.xla.XlaExecutor`` and with the NumPy oracle on
the 11 corpus kernels, under ``cluster: coarse``, with ``border:
preserve`` and on random programs. The JAX path turns on the TPU
rewrites ``fast_int_div`` (exact) and ``fast_rsqrt``; the port computes
the oracle's arithmetic, so integers are bit-exact against both and
floats within the reference threshold (tests/checks.py). Each side
builds its stencil from the same DSL text.
"""

import numpy as np
import pytest
import torch

import soda_tpu
from soda_tpu import corpus as jax_corpus
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu_torch import api, corpus, get_executor, utils
from soda_tpu_torch.backend import reference
from soda_tpu_torch.backend.fused import FusedExecutor
from soda_tpu_torch.backend.grouped import GroupedExecutor
from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
from soda_tpu_torch.testing import (FUZZ_SEEDS, FUZZ_SHAPE, check_outputs,
                                    gen_program, make_inputs)

torch.set_num_threads(1)


def _numpy(outs, shape):
  # XlaExecutor returns an output whose expression is a constant as a
  # 0-d array; the port's is the full grid
  return {k: np.broadcast_to(np.asarray(v), shape) for k, v in outs.items()}


def _check(stencil, jax_stencil, shape, inputs, params=None, cluster=None,
           context=''):
  ex = get_executor(stencil, shape, 'xla', device='cpu', cluster=cluster)
  assert isinstance(ex, WholeGridExecutor) and ex.launches == 0
  got = ex(inputs, params)
  assert all(tuple(v.shape) == shape for v in got.values())
  full = stencil.preserve_border
  with np.errstate(all='ignore'):
    want = reference.run(stencil, inputs, params)
  check_outputs(stencil, shape, got, want, context, full=full)
  jax_got = _numpy(XlaExecutor(jax_stencil, shape, cluster=cluster)(
      inputs, params), shape)
  check_outputs(stencil, shape, got, jax_got, context + ' vs jax', full=full)
  return ex, got


@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_corpus_matches_xla_and_oracle(name):
  stencil = corpus.build(name)
  shape = corpus.TEST_DIMS[name]
  _check(stencil, jax_corpus.build(name), shape,
         reference.make_test_inputs(stencil, shape),
         reference.make_test_params(stencil), context=name)


@pytest.mark.parametrize('name', ['blur', 'sobel2d', 'denoise2d', 'heat3d'])
def test_coarse_matches_xla_and_oracle(name):
  stencil = corpus.build(name, cluster='coarse')
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  _, got = _check(stencil, jax_corpus.build(name, cluster='coarse'), shape,
                  inputs, cluster='coarse', context=name + ' coarse')
  # eager PyTorch has no jit regions: the grouping changes nothing
  want = WholeGridExecutor(corpus.build(name), shape, device='cpu')(inputs)
  assert all(torch.equal(got[k], want[k]) for k in want)
  with pytest.raises(ValueError, match='cluster granularity'):
    WholeGridExecutor(stencil, shape, cluster='medium', device='cpu')


@pytest.mark.parametrize('name', ['jacobi2d', 'blur', 'sobel2d'])
def test_preserve_border(name):
  stencil = corpus.build(name, border='preserve')
  shape = corpus.TEST_DIMS[name]
  _check(stencil, jax_corpus.build(name, border='preserve'), shape,
         reference.make_test_inputs(stencil, shape),
         context=name + ' preserve')


@pytest.mark.parametrize('seed', list(FUZZ_SEEDS)[:10])
def test_fuzz_program_matches_xla_and_oracle(seed):
  # narrow programs: the jax.numpy Evaluator's domain on the CPU
  text = gen_program(seed, narrow=True)
  stencil = api.build_stencil(text)
  _check(stencil, soda_tpu.build_stencil(text), FUZZ_SHAPE,
         make_inputs(stencil, FUZZ_SHAPE, seed), context='fuzz%d' % seed)


@pytest.mark.parametrize('seed', list(FUZZ_SEEDS)[10:20])
def test_wide_fuzz_program_matches_oracle(seed):
  # every integer width, integer division and double
  stencil = api.build_stencil(gen_program(seed))
  inputs = make_inputs(stencil, FUZZ_SHAPE, seed)
  got = WholeGridExecutor(stencil, FUZZ_SHAPE, device='cpu')(inputs)
  with np.errstate(all='ignore'):
    want = reference.run(stencil, inputs)
  check_outputs(stencil, FUZZ_SHAPE, got, want, 'wide fuzz%d' % seed)


@pytest.mark.parametrize('shape', [(9, 32), (24, 7)])
def test_any_grid_shape_matches_the_oracle(shape):
  """The grid is one tile of whatever shape it is given."""
  stencil = corpus.build('jacobi2d')
  inputs = reference.make_test_inputs(stencil, shape)
  got = WholeGridExecutor(stencil, shape, device='cpu')(inputs)
  check_outputs(stencil, shape, got, reference.run(stencil, inputs),
                'jacobi2d %s' % (shape,))


def test_prepare_checks_its_arguments():
  stencil = corpus.build('blur')
  ex = WholeGridExecutor(stencil, (40, 64), device='cpu')
  with pytest.raises(utils.InputError, match='missing input'):
    ex({})
  with pytest.raises(utils.InputError, match='compiled shape'):
    ex({'input': np.zeros((40, 63), np.uint16)})
  with pytest.raises(utils.InputError):
    WholeGridExecutor(stencil, (2, 2), device='cpu')


_FAR_TAP = '\n'.join([
    'kernel: far', 'burst width: 64', 'unroll factor: 1', 'iterate: 1',
    'border: ignore', 'cluster: none', 'input dram 0 float: x(320, *)',
    'output dram 1 float: y(0, 0) = x(-150, -150) + x(150, 150)'])


def test_auto_raises_where_the_plan_does_not_fit():
  """'auto' is the fused kernel: where even a one-cell tile does not fit
  shared memory it raises the tile plan's error, before any build, and
  names the explicit ways out; the whole-grid executor runs only when
  asked for by name."""
  stencil = api.build_stencil(_FAR_TAP)
  shape = (320, 320)
  for backend in ('auto', 'fused'):
    with pytest.raises(utils.InputError,
                       match=r"shared memory.*cluster: coarse.*'xla'"):
      get_executor(stencil, shape, backend, device='cpu')
  ex = get_executor(stencil, shape, 'xla', device='cpu')
  assert isinstance(ex, WholeGridExecutor)
  inputs = reference.make_test_inputs(stencil, shape)
  check_outputs(stencil, shape, ex(inputs), reference.run(stencil, inputs),
                'far tap')


@pytest.mark.parametrize('name,cluster,kind', [
    ('blur', None, FusedExecutor),
    ('contrast', None, FusedExecutor),
    ('denoise2d', 'coarse', GroupedExecutor),
])
def test_auto_keeps_the_kernel_where_it_fits(name, cluster, kind):
  overrides = {'cluster': cluster} if cluster else {}
  stencil = corpus.build(name, **overrides)
  shape = corpus.TEST_DIMS[name]
  assert isinstance(get_executor(stencil, shape, device='cpu'), kind)
