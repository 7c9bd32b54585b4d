"""exp9's 2.5-D jacobi probe: its plain versions against the JAX script.

``soda_tpu_torch/experiments/layout25d.py`` ports the Pallas probe of
experiments/exp9_layout25d.py (``build_25d``). Its kernel runs only on
the card (tests/test_torch_gpu.py; a g++ emulation of its text in
tests/test_torch_copy_emulation.py); here its two plain versions (the
whole-grid function and the walk that follows the kernel's CTAs, tiles,
clipped slab starts and buffer slots) equal each other bit for bit, and
match the script's kernel, loaded by path and run under
``pltpu.force_tpu_interpret_mode()``, within 1e-6 absolute on rows [2,
h-2), all columns (XLA on the CPU may contract the script's sums: 2.4e-7
measured at (64, 16, 128)), at the script's check shape and at shapes of
three and more row blocks; and the port's NumPy oracle within 1e-4 on
the script's region.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from soda_tpu_torch import corpus, utils
from soda_tpu_torch.backend import reference
from soda_tpu_torch.experiments import exp9_layout25d, layout25d

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_TOL = 1e-6

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def script():
  spec = importlib.util.spec_from_file_location(
      'jax_exp9_layout25d', REPO / 'experiments' / 'exp9_layout25d.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  module.log = lambda *a: None
  return module


# (shape, block): the script's check; three and four row blocks (the
# first, middle and last block classes), one band (the wrap inside a
# CTA's own columns), a block of several tiles
SHAPES = [((64, 16, 128), 32), ((96, 2, 128), 32), ((128, 1, 128), 32),
          ((192, 2, 128), 64)]


@pytest.mark.parametrize('shape, block', SHAPES + [((2048, 2, 128), 256),
                                                    ((2048, 2, 128), 1024),
                                                    ((256, 3, 128), 128)])
def test_walk_equals_the_whole_grid_function(shape, block):
  x = layout25d.grid_input(shape, 'cpu')
  want = layout25d.jacobi25d_plain(x)
  got = layout25d.jacobi25d_walk(x, block)
  assert torch.equal(got, want)
  assert torch.equal(layout25d.jacobi25d(x, block), want)
  h = shape[0]
  flat = got.reshape(h, -1)
  assert not flat[:2].any() and not flat[h - 2:].any()


@pytest.mark.parametrize('shape, block', SHAPES)
def test_plain_matches_the_jax_kernel(script, shape, block):
  x = layout25d.grid_input(shape, 'cpu')
  with pltpu.force_tpu_interpret_mode():
    want = np.asarray(script.build_25d(shape[0], shape[1], block)(
        jnp.asarray(x.numpy())))
  h = shape[0]
  got = layout25d.jacobi25d(x, block).numpy()
  assert np.max(np.abs(got[2:h - 2] - want[2:h - 2])) <= JAX_TOL


def test_plain_matches_the_oracle_on_the_scripts_region():
  x = layout25d.grid_input(layout25d.CHECK_SHAPE, 'cpu')
  h = x.shape[0]
  stencil = corpus.build('jacobi2d', tile_size=exp9_layout25d.JACOBI_TILE)
  want = reference.run(stencil, {'t1': x.reshape(h, -1).numpy()})['t0']
  got = layout25d.jacobi25d_plain(x).reshape(h, -1).numpy()
  err = np.max(np.abs(got[2:h - 2, 2:-2] - want[2:h - 2, 2:-2]))
  assert err < exp9_layout25d.ORACLE_TOL


def test_slab_starts_clip_as_the_script():
  """A tile's slab starts HALO rows before it, clipped to the grid (the
  script's start(p), :64-65, at a block of one tile)."""
  h = 96
  starts = [layout25d.slab_start(t0, h) for t0 in range(0, h, layout25d.TILE)]
  rows = layout25d.TILE + 2 * layout25d.HALO
  assert starts == [int(np.clip(t0 - 2, 0, h - rows))
                    for t0 in range(0, h, layout25d.TILE)] == [0, 30, 60]


def test_the_input_and_constants_are_the_scripts():
  x = np.random.default_rng(0).standard_normal((64, 16, 128)).astype(
      np.float32)
  assert np.array_equal(layout25d.grid_input((64, 16, 128), 'cpu').numpy(), x)
  assert layout25d.BLOCKS == (256, 512, 1024)
  assert exp9_layout25d.JACOBI_SHAPE == (8192, 2048)
  assert layout25d.bound_ms(layout25d.SHAPE) == pytest.approx(
      8192 * 2048 * 8 / 3.35e12 * 1e3)


def test_jacobi25d_rejects_what_the_kernel_does_not_take():
  x = layout25d.grid_input((64, 16, 128), 'cpu')
  with pytest.raises(utils.InputError, match='float32'):
    layout25d.jacobi25d(x.double(), 32)
  with pytest.raises(utils.InputError, match='multiple'):
    layout25d.jacobi25d(x.reshape(64, -1)[:, :2000].contiguous(), 32)
  with pytest.raises(utils.InputError, match='block'):
    layout25d.jacobi25d(x, 48)
  with pytest.raises(utils.InputError, match='block'):
    layout25d.jacobi25d(x[:48].contiguous(), 32)
  with pytest.raises(utils.InputError, match='cpu or cuda'):
    layout25d.jacobi25d(x.to('meta'), 32)


def test_entry_point_on_the_cpu(capsys):
  assert exp9_layout25d.main(['--device', 'cpu']) == 0
  out = capsys.readouterr().out.splitlines()
  assert len(out) == 7, out
  assert 'bit for bit' in out[0] and 'OK' in out[0]
  assert all('bit for bit' in line for line in out[1:4])
  assert all('max |err| 0' in line for line in out[4:])
