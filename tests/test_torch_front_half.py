"""The port's own front half against the JAX package's.

The port keeps its own copy of the framework-free modules (DSL parser,
IR, stencil core, optimization passes, fusion plan, NumPy oracle,
corpus), so it imports nothing of ``soda_tpu``. Built from the same DSL
text, both packages must give the same stencil (tensor names, types and
printed expressions in chronological order), the same fusion-plan
stages, and the same oracle outputs bit for bit; both must find the same
external computation-reuse scheduler. No file of the port imports jax or
the JAX package, and running the port (library and command line) never
loads either.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import soda_tpu
from soda_tpu.backend import reference as jax_reference
from soda_tpu.backend.plan import make_plan as jax_make_plan
from soda_tpu.optimization import cr_schedules as jax_cr
import soda_tpu_torch
from soda_tpu_torch import corpus
from soda_tpu_torch.backend import reference
from soda_tpu_torch.backend.fused import FusedExecutor
from soda_tpu_torch.backend.grouped import GroupedExecutor
from soda_tpu_torch.backend.plan import make_plan
from soda_tpu_torch.optimization import cr_schedules
from soda_tpu_torch.parallel.replicate import ReplicatedExecutor
from soda_tpu_torch.testing import (CELLS, FUZZ_SEEDS, FUZZ_SHAPE,
                                    gen_program, make_inputs)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

# every corpus kernel as written, then the benchmark's overrides
# (computation reuse greedy, yes with the TPU cost, distribute)
CASES = ([(name, {}) for name in sorted(corpus.CORPUS)] +
         [(name.split('_')[0], overrides) for name, _, overrides in CELLS
          if 'optimizations' in overrides])


class _StepClock:
  """A stand-in for the ``time`` module whose clock advances a fixed
  step per reading: the schedulers' time budgets (greedy: 1 s) then end
  after the same number of steps on both sides, whatever the load."""

  def __init__(self, step=0.5):
    self.now, self.step = 0.0, step

  def monotonic(self):
    self.now += self.step
    return self.now


def _summary(stencil):
  return [(t.name, str(t.dtype), str(t.expr), [str(let) for let in t.lets])
          for t in stencil.chronological_tensors]


@pytest.mark.parametrize('name,overrides', CASES,
                         ids=['%s-%d' % (c[0], i) for i, c in enumerate(CASES)])
def test_same_stencil_and_plan_as_the_jax_package(name, overrides,
                                                  monkeypatch):
  monkeypatch.setattr(cr_schedules, 'time', _StepClock())
  port = soda_tpu_torch.build_stencil(corpus.CORPUS[name], **overrides)
  monkeypatch.setattr(jax_cr, 'time', _StepClock())
  jax = soda_tpu.build_stencil(corpus.CORPUS[name], **overrides)
  assert _summary(port) == _summary(jax)
  assert port.input_names == jax.input_names
  assert port.output_names == jax.output_names
  for cluster in ('full', 'coarse'):
    assert ({s.name for s in make_plan(port, cluster).stages} ==
            {s.name for s in jax_make_plan(jax, cluster).stages})
    assert len(make_plan(port, cluster).groups) == \
        len(jax_make_plan(jax, cluster).groups)


_ORACLE_CASES = ([('corpus', name) for name in sorted(corpus.CORPUS)] +
                 [('fuzz', seed) for seed in FUZZ_SEEDS])


@pytest.mark.parametrize('kind,key', _ORACLE_CASES,
                         ids=['%s-%s' % c for c in _ORACLE_CASES])
def test_oracle_is_bit_exact_with_the_jax_package(kind, key):
  if kind == 'corpus':
    text, shape = corpus.CORPUS[key], corpus.TEST_DIMS[key]
  else:
    text, shape = gen_program(key), FUZZ_SHAPE
  port = soda_tpu_torch.build_stencil(text)
  jax = soda_tpu.build_stencil(text)
  if kind == 'corpus':
    inputs = reference.make_test_inputs(port, shape)
    params = reference.make_test_params(port)
    jax_inputs = jax_reference.make_test_inputs(jax, shape)
    for name in port.input_names:
      np.testing.assert_array_equal(inputs[name], jax_inputs[name])
  else:
    inputs, params = make_inputs(port, shape, key), {}
  with np.errstate(all='ignore'):
    got = reference.run(port, inputs, params)
    want = jax_reference.run(jax, inputs, params)
  assert sorted(got) == sorted(want)
  for out in got:
    assert got[out].dtype == want[out].dtype
    np.testing.assert_array_equal(got[out], want[out], err_msg=str(key))
    region = reference.output_valid_slices(port, shape, out)
    assert region == jax_reference.output_valid_slices(jax, shape, out)


def test_both_find_the_same_external_scheduler():
  assert cr_schedules.find_external_cr() == jax_cr.find_external_cr()
  here = pathlib.Path(cr_schedules.__file__).resolve().parent.parent.parent
  assert here == REPO


def test_shift_prices_match_the_jax_package():
  from soda_tpu.model.estimate import SHIFT_COST
  assert cr_schedules._ROLL_COST == SHIFT_COST['roll']


def _imports(path):
  tree = ast.parse(path.read_text(), str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      yield node.module


_PORT_FILES = sorted((REPO / 'soda_tpu_torch').rglob('*.py')) + \
    [REPO / 'chip_smoke.py']


@pytest.mark.parametrize('path', _PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in _PORT_FILES])
def test_no_port_file_imports_jax_or_the_jax_package(path):
  for module in _imports(path):
    root = module.split('.')[0]
    assert root not in ('jax', 'jaxlib', 'soda_tpu'), (path, module)


def test_running_the_port_loads_neither_jax_nor_the_jax_package(tmp_path):
  soda = tmp_path / 'blur.soda'
  soda.write_text(corpus.CORPUS['blur'])
  code = '\n'.join([
      'import contextlib, io, sys',
      'sys.path.insert(0, %r)' % str(REPO),
      'import soda_tpu_torch',
      'from soda_tpu_torch import corpus, sodac',
      'from soda_tpu_torch.backend import reference',
      "st = soda_tpu_torch.build_stencil(corpus.CORPUS['blur'],",
      "                                  cluster='coarse')",
      "ex = soda_tpu_torch.get_executor(st, (40, 64), device='cpu')",
      'ex(reference.make_test_inputs(st, (40, 64)))',
      'out = io.StringIO()',
      'with contextlib.redirect_stdout(out):',
      "  rc = sodac.main([%r, '--run', '--device', 'cpu', '--shape', "
      "'40,64'])" % str(soda),
      "assert rc == 0 and 'INFO: PASS!' in out.getvalue(), out.getvalue()",
      "print(sorted(m for m in sys.modules",
      "             if m.split('.')[0] in ('jax', 'jaxlib', 'soda_tpu')))",
  ])
  env = {k: v for k, v in os.environ.items() if not k.startswith('JAX')}
  proc = subprocess.run([sys.executable, '-c', code], env=env,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert proc.stdout.strip() == '[]'


@pytest.mark.parametrize('make', [
    lambda st: FusedExecutor(st, (40, 64), device='cpu'),
    lambda st: GroupedExecutor(st, (40, 64), device='cpu'),
    lambda st: ReplicatedExecutor(st, (40, 64), 2, device='cpu'),
], ids=['fused', 'grouped', 'replicated'])
def test_a_jax_built_stencil_is_refused(make):
  jax = soda_tpu.build_stencil(corpus.CORPUS['blur'])
  with pytest.raises(TypeError, match='soda_tpu_torch.core.Stencil'):
    make(jax)


def test_class_identity_is_the_ports_own():
  port = corpus.build('blur')
  jax = soda_tpu.build_stencil(corpus.CORPUS['blur'])
  port_classes = {type(t.expr) for t in port.chronological_tensors
                  if t.expr is not None} | {type(port)}
  assert port_classes and all(c.__module__.startswith('soda_tpu_torch.')
                              for c in port_classes)
  assert type(port) is not type(jax)
