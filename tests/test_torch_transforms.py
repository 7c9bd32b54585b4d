"""torch.func and autograd through the port's whole-grid executor.

The port of tests/test_transforms.py: ``WholeGridExecutor.fn``
(``get_executor(..., 'xla')``) is plain PyTorch built out of place, so
it composes with ``torch.func.vmap`` and ``torch.autograd`` as the JAX
``XlaExecutor.fn`` composes with ``jax.vmap`` and ``jax.grad``. Every
case runs both on the same numpy inputs. Integer stencils compare bit
for bit, floats within rtol = atol = 1e-6 (the JAX test's tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soda_tpu import api as jax_api
from soda_tpu import corpus as jax_corpus
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu_torch import chained, corpus, get_executor
from soda_tpu_torch.backend import reference
from soda_tpu_torch.testing import check_outputs

torch.set_num_threads(1)

SHAPE = (32, 24)


@pytest.fixture(scope='module')
def jacobi():
  return (get_executor(corpus.build('jacobi2d'), SHAPE, 'xla', device='cpu'),
          XlaExecutor(jax_corpus.build('jacobi2d'), SHAPE))


def _grad(fn, x: np.ndarray) -> np.ndarray:
  a = torch.from_numpy(x).requires_grad_(True)
  fn(a).backward()
  return a.grad.numpy()


def test_grad_matches_finite_differences(jacobi):
  ex, jax_ex = jacobi
  x = np.random.RandomState(0).rand(*SHAPE).astype(np.float32)

  def loss(a):
    return torch.sum(ex.fn(a)[0] ** 2)

  g = _grad(loss, x)
  assert g.shape == SHAPE
  want = np.asarray(jax.grad(lambda a: jnp.sum(jax_ex.fn(a)[0] ** 2))(
      jnp.asarray(x)))
  np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)
  # central difference at an interior cell (f32: loose tolerance)
  eps = 1e-2
  with torch.no_grad():
    for cell in ((11, 11), (15, 7)):
      e = np.zeros_like(x)
      e[cell] = eps
      fd = (loss(torch.from_numpy(x + e)) -
            loss(torch.from_numpy(x - e))) / (2 * eps)
      assert abs(float(fd) - float(g[cell])) <= 2e-2 * max(1.0, abs(float(fd)))


def test_grad_zero_outside_stencil_reach(jacobi):
  """d out[c] / d in[far] is zero beyond the (iterate-deep) window."""
  ex, jax_ex = jacobi
  x = np.random.RandomState(1).rand(*SHAPE).astype(np.float32)
  c = (16, 12)
  g = _grad(lambda a: ex.fn(a)[0][c], x)
  # jacobi2d iterate=2: 5-point window applied twice -> reach 2 per axis
  assert float(g[c[0] + 3, c[1]]) == 0.0
  assert float(g[c[0], c[1] + 3]) == 0.0
  assert float(g[c[0] + 1, c[1]]) != 0.0
  want = np.asarray(jax.grad(lambda a: jax_ex.fn(a)[0][c])(jnp.asarray(x)))
  np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)
  assert np.array_equal(g != 0, want != 0)


def _vmap_against_loop(ex, jax_ex, batch):
  """``torch.func.vmap`` of ``ex.fn`` over the leading axis of every
  input equals a Python loop over it (bit for bit for integers, 1e-6
  for floats), and each entry agrees with ``jax.vmap`` of the JAX
  executor (the reference's pass rule)."""
  stencil = ex.stencil
  per = [ex.prepare({n: batch[n][k] for n in stencil.input_names})
         for k in range(len(next(iter(batch.values()))))]
  args = [torch.stack(col) for col in zip(*per)]
  vout = torch.func.vmap(ex.fn)(*args)
  jax_out = jax.vmap(jax_ex.fn)(*[jnp.asarray(batch[n])
                                  for n in stencil.input_names])
  for k, one in enumerate(per):
    want = ex.fn(*one)
    for name, got, loop, ref in zip(stencil.output_names, vout, want,
                                    jax_out):
      assert got[k].dtype == loop.dtype
      if got.is_floating_point():
        np.testing.assert_allclose(got[k].numpy(), loop.numpy(), rtol=1e-6,
                                   atol=1e-6)
      else:
        assert torch.equal(got[k], loop), name
      shape = tuple(loop.shape)
      check_outputs(stencil, shape, {name: got[k]},
                    {name: np.broadcast_to(np.asarray(ref[k]), shape)},
                    'vmap %s[%d] vs jax' % (name, k),
                    full=stencil.preserve_border)


def test_vmap_matches_python_loop(jacobi):
  ex, jax_ex = jacobi
  rng = np.random.RandomState(2)
  _vmap_against_loop(ex, jax_ex,
                     {'t1': rng.rand(3, *SHAPE).astype(np.float32)})


@pytest.mark.parametrize('name', ['blur', 'sobel2d', 'denoise2d'])
def test_vmap_matches_python_loop_corpus(name):
  stencil = corpus.build(name)
  shape = corpus.TEST_DIMS[name]
  ex = get_executor(stencil, shape, 'xla', device='cpu')
  jax_ex = XlaExecutor(jax_corpus.build(name), shape)
  batch = {}
  for k in range(3):
    for n, v in reference.make_test_inputs(stencil, shape, seed=k).items():
      batch.setdefault(n, []).append(v)
  _vmap_against_loop(ex, jax_ex, {n: np.stack(v) for n, v in batch.items()})


def test_vmap_with_preserve_border():
  stencil = corpus.build('jacobi2d', border='preserve')
  ex = get_executor(stencil, SHAPE, 'xla', device='cpu')
  jax_ex = XlaExecutor(jax_corpus.build('jacobi2d', border='preserve'), SHAPE)
  rng = np.random.RandomState(4)
  _vmap_against_loop(ex, jax_ex,
                     {'t1': rng.rand(2, *SHAPE).astype(np.float32)})


def test_grad_through_chained_steps():
  """grad composes with `chained`, the multi-step runner."""
  st = corpus.build('jacobi2d')
  ex = get_executor(st, SHAPE, 'xla', device='cpu')
  step = chained(ex, 3)
  x = np.random.RandomState(3).rand(*SHAPE).astype(np.float32)
  g = _grad(lambda a: torch.sum(step(a)[0]), x)
  assert g.shape == SHAPE and bool(np.any(g != 0))
  jax_step = jax_api.chained(XlaExecutor(jax_corpus.build('jacobi2d'), SHAPE),
                             3)
  want = np.asarray(jax.grad(lambda a: jnp.sum(jax_step(a)[0]))(
      jnp.asarray(x)))
  np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)
