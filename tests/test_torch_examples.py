"""The port's examples (examples/torch_*.py) against the JAX package's.

Each runs here with ``--device cpu`` (the kernels' plain versions) and
must print what its JAX counterpart prints under ``JAX_PLATFORMS=cpu``
at the same shape: the image pipeline's edge response mean and max, the
solver's sweep count and interior mean, the relaxation's mean
temperature and sample row. Sharding is exact, so the port's (4,) mesh
of the one CPU device matches the JAX run on the conftest's 8 virtual
devices. The port's examples import neither jax nor the JAX package.
"""

import ast
import pathlib
import runpy
import sys

import pytest
import torch

from soda_tpu_torch import utils

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / 'examples'
PORTED = ('image_pipeline', 'iterative_solver', 'multichip_relaxation')

torch.set_num_threads(1)


def _port(name, argv, capsys):
  module = runpy.run_path(str(EXAMPLES / ('torch_%s.py' % name)))
  module['main'](argv)
  return capsys.readouterr().out.splitlines()


def _jax(name, argv, monkeypatch, capsys):
  monkeypatch.setattr(sys, 'argv', ['%s.py' % name] + argv)
  runpy.run_path(str(EXAMPLES / ('%s.py' % name)), run_name='__main__')
  return capsys.readouterr().out.splitlines()


def test_image_pipeline_prints_the_jax_lines(monkeypatch, capsys):
  port = _port('image_pipeline', ['--device', 'cpu'], capsys)
  jax = _jax('image_pipeline', [], monkeypatch, capsys)
  assert port == jax
  assert port[1].startswith('edge response mean')


@pytest.mark.parametrize('h,w,batch', [(48, 64, 16), (24, 32, 5),
                                       (24, 32, 1)])
def test_iterative_solver_stops_where_jax_stops(h, w, batch, monkeypatch,
                                                capsys):
  """Batches that end past convergence are rerun launch by launch from
  their start, so the sweep count is the JAX loop's, whatever the
  batch."""
  port = _port('iterative_solver', [str(h), str(w), '--device', 'cpu',
                                    '--batch', str(batch)], capsys)
  jax = _jax('iterative_solver', [str(h), str(w)], monkeypatch, capsys)
  assert port[0] == 'executor: FusedExecutor (block_rows=n/a)'
  assert port[1:] == jax[1:]
  assert 'converged' in port[1]


@pytest.mark.parametrize('argv', [['64', '32', '5'], []],
                         ids=['64x32x5', 'default'])
def test_multichip_relaxation_matches_the_jax_mesh(argv, monkeypatch,
                                                   capsys):
  port = _port('multichip_relaxation', argv + ['--device', 'cpu'], capsys)
  jax = _jax('multichip_relaxation', argv, monkeypatch, capsys)
  assert port[0].startswith('devices: 4,') and jax[0].startswith('devices: 8,')
  assert port[0].split(',')[1:] == jax[0].split(',')[1:]
  assert port[1:] == jax[1:]
  assert port[1].startswith('mean temperature')


@pytest.mark.parametrize('name', PORTED)
def test_examples_run_on_the_card_by_default(name, capsys):
  """``--device`` defaults to cuda; without a card that fails rather
  than falling back to the CPU."""
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  module = runpy.run_path(str(EXAMPLES / ('torch_%s.py' % name)))
  with pytest.raises(utils.InputError, match='no CUDA device'):
    module['main']([])


@pytest.mark.parametrize('name', PORTED)
def test_examples_import_neither_jax_nor_the_jax_package(name):
  tree = ast.parse((EXAMPLES / ('torch_%s.py' % name)).read_text())
  imported = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      imported.update(alias.name.split('.')[0] for alias in node.names)
    elif isinstance(node, ast.ImportFrom):
      imported.add(node.module.split('.')[0])
  assert 'soda_tpu_torch' in imported
  assert imported <= {'argparse', 'numpy', 'pathlib', 'soda_tpu_torch',
                      'sys', 'torch'}, imported
