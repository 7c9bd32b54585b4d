"""The port's main path against the JAX package's.

DSL text -> build_stencil -> get_executor(stencil, shape) -> outputs:
``soda_tpu.get_executor`` (JAX; on the CPU the fused Pallas kernel in
interpret mode) against ``soda_tpu_torch.get_executor(..., device='cpu')``
on every corpus kernel, each side with its own stencil built from the
same DSL text. The port must never load jax or the JAX package, must
refuse a CUDA device it does not have, and must take every backend name
of the JAX package that it has ported ('xla', 'sharded', 'replicated')
to its own executor, with no fallback.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import soda_tpu
import soda_tpu_torch
from soda_tpu_torch import corpus, utils
from soda_tpu_torch.backend import reference
from soda_tpu_torch.backend.grouped import GroupedExecutor
from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
from soda_tpu_torch.parallel.replicate import ReplicatedExecutor
from soda_tpu_torch.parallel.spmd import ShardedExecutor

from checks import assert_close_reference

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _overrides(name):
  return ({'tile_size': corpus.TEST_TILE_SIZES[name]}
          if name in corpus.TEST_TILE_SIZES else {})


@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_port_matches_jax_main_path(name):
  # each side builds its own stencil from the same DSL text
  stencil = soda_tpu_torch.build_stencil(corpus.CORPUS[name],
                                         **_overrides(name))
  jax_stencil = soda_tpu.build_stencil(corpus.CORPUS[name],
                                       **_overrides(name))
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  want = soda_tpu.get_executor(jax_stencil, shape)(inputs, params)
  got = soda_tpu_torch.get_executor(stencil, shape, device='cpu')(inputs,
                                                                  params)
  for out in stencil.output_names:
    region = reference.output_valid_slices(stencil, shape, out)
    assert_close_reference(got[out].numpy()[region],
                           np.asarray(want[out])[region],
                           stencil.symbol_table[out].is_float,
                           '%s:%s' % (name, out))


def test_port_never_loads_jax():
  code = '\n'.join([
      'import sys',
      'sys.path.insert(0, %r)' % str(REPO),
      'import soda_tpu_torch',
      'from soda_tpu_torch import corpus',
      'from soda_tpu_torch.backend import reference',
      "st = soda_tpu_torch.build_stencil(corpus.CORPUS['blur'],",
      "                                  tile_size=(64, 0))",
      "ex = soda_tpu_torch.get_executor(st, (40, 64), device='cpu')",
      'out = ex(reference.make_test_inputs(st, (40, 64)))',
      "assert out['blur_y'].shape == (40, 64)",
      "print('jax' in sys.modules, 'soda_tpu' in sys.modules)",
  ])
  env = {k: v for k, v in os.environ.items() if not k.startswith('JAX')}
  proc = subprocess.run([sys.executable, '-c', code], env=env,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert proc.stdout.strip() == 'False False'


def test_cuda_device_without_a_gpu_raises():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device exists here')
  stencil = corpus.build('blur')
  with pytest.raises(utils.InputError, match='no CUDA device'):
    soda_tpu_torch.get_executor(stencil, (40, 64))
  with pytest.raises(utils.InputError, match='no CUDA device'):
    soda_tpu_torch.get_executor(stencil, (40, 64), device='cuda')


@pytest.mark.parametrize('backend,kind', [('xla', WholeGridExecutor),
                                          ('sharded', ShardedExecutor)])
def test_unported_backends_name_their_roadmap_item(backend, kind):
  """The backends that raised naming their ROADMAP items (A2, A9) before
  they were ported now build their executors, which match the JAX
  package's backend of the same name and the oracle."""
  stencil = corpus.build('blur')
  shape = corpus.TEST_DIMS['blur']
  ex = soda_tpu_torch.get_executor(stencil, shape, backend, device='cpu')
  assert isinstance(ex, kind)
  inputs = reference.make_test_inputs(stencil, shape)
  got = ex(inputs)['blur_y'].numpy()
  want = soda_tpu.get_executor(soda_tpu.build_stencil(
      corpus.CORPUS['blur'], **_overrides('blur')), shape, backend)(inputs)
  region = reference.output_valid_slices(stencil, shape)
  np.testing.assert_array_equal(got[region],
                                np.asarray(want['blur_y'])[region])
  np.testing.assert_array_equal(
      got[region], reference.run(stencil, inputs)['blur_y'][region])


def test_unknown_backend_raises():
  stencil = corpus.build('blur')
  with pytest.raises(ValueError, match='unknown backend'):
    soda_tpu_torch.get_executor(stencil, (40, 64), 'grouped', device='cpu')


@pytest.mark.parametrize('backend,cluster,kind', [
    ('auto', 'coarse', GroupedExecutor),
    ('fused', 'fine', GroupedExecutor),
    ('replicated', 'none', ReplicatedExecutor),
])
def test_grouped_and_replicated_dispatch(backend, cluster, kind):
  """``cluster: coarse/fine`` runs one kernel per stage group, and
  ``backend='replicated'`` a batch of grids; both against the oracle."""
  stencil = corpus.build('blur', cluster=cluster, replication_factor=2)
  shape = corpus.TEST_DIMS['blur']
  ex = soda_tpu_torch.get_executor(stencil, shape, backend, device='cpu')
  assert isinstance(ex, kind)
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)['blur_y']
  if kind is ReplicatedExecutor:
    got = ex({'input': np.stack([inputs['input']] * 2)})['blur_y'][1]
  else:
    got = ex(inputs)['blur_y']
  region = reference.output_valid_slices(stencil, shape)
  np.testing.assert_array_equal(got.numpy()[region], want[region])


def test_chained_applies_the_stencil_n_times():
  stencil = corpus.build('jacobi2d')
  jax_stencil = soda_tpu.build_stencil(corpus.CORPUS['jacobi2d'])
  shape = (40, 32)
  inputs = reference.make_test_inputs(stencil, shape)
  ex = soda_tpu_torch.get_executor(stencil, shape, device='cpu')
  run3 = soda_tpu_torch.chained(ex, 3)
  (got,) = run3(*ex.prepare(inputs))
  want = inputs['t1']
  for _ in range(3):
    want = soda_tpu.get_executor(jax_stencil, shape)({'t1': want})['t0']
    want = np.asarray(want)
  # three applications of a two-sweep stencil: a margin of 3 * 2 cells
  region = (slice(6, shape[0] - 6), slice(6, shape[1] - 6))
  assert_close_reference(got.numpy()[region], want[region], True, 'chained')
