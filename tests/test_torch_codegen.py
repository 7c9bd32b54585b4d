"""The port's printed programs (``--emit-torch``, ``--emit-numpy``)
against the JAX package's (``jax_source``) and the NumPy oracle.

``soda_tpu_torch.codegen.torch_source`` prints a standalone program for
a stencil: 'torch' (torch and numpy) in place of the JAX package's
'jax' target, and the same 'numpy' target, which must print the JAX
package's text. Each program is exec'd here on the CPU: the torch one
against the oracle, against the JAX package's 'jax' program (under
``JAX_PLATFORMS=cpu``) and against the port's 'numpy' program, on the 11
corpus kernels, random programs in the JAX package's CPU domain and, for
the oracle and the 'numpy' program, random programs over every integer
width with division. Integers bit-exact, floats within the reference
threshold (tests/checks.py). Each side builds its stencil from the same
DSL text.
"""

import ast
import types

import numpy as np
import pytest
import torch

import soda_tpu
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu.codegen import jax_source
from soda_tpu_torch import api, corpus
from soda_tpu_torch.backend import reference
from soda_tpu_torch.codegen import torch_source
from soda_tpu_torch.testing import (FUZZ_SEEDS, FUZZ_SHAPE, check_outputs,
                                    gen_program, make_inputs)

torch.set_num_threads(1)


def _module(src):
  module = types.ModuleType('generated_stencil')
  exec(compile(src, '<generated>', 'exec'), module.__dict__)
  return module


def _args(stencil, inputs, params):
  return ([inputs[n] for n in stencil.input_names] +
          [params[n] for n in stencil.param_names])


def _grid(outs, shape):
  # the 'jax' and 'numpy' programs return a constant output as a 0-d array
  return {k: np.broadcast_to(np.asarray(v), shape) for k, v in outs.items()}


def _torch_outputs(stencil, shape, inputs, params):
  module = _module(torch_source.generate(stencil, shape))
  args = [torch.from_numpy(np.ascontiguousarray(a))
          for a in _args(stencil, inputs, params)]
  got = module.compute(*args)
  assert all(tuple(v.shape) == shape for v in got.values())
  for name, value in got.items():
    assert value.dtype == torch.from_numpy(np.zeros(
        1, stencil.symbol_table[name].np_dtype)).dtype, name
  return got


def _check(text, shape, inputs, params=None, context='', jax=True):
  """The torch program against the oracle, the port's 'numpy' program
  and (``jax``) the JAX package's 'jax' program; the port's 'numpy'
  text against the JAX package's where that prints one."""
  params = params or {}
  stencil = api.build_stencil(text)
  got = _torch_outputs(stencil, shape, inputs, params)
  with np.errstate(all='ignore'):
    want = reference.run(stencil, inputs, params)
    printed = _module(torch_source.generate(stencil, shape, 'numpy'))
    mine = _grid(printed.compute(*_args(stencil, inputs, params)), shape)
  check_outputs(stencil, shape, got, want, context)
  check_outputs(stencil, shape, mine, want, context + ' numpy')
  check_outputs(stencil, shape, got, mine, context + ' vs numpy')
  jax_stencil = soda_tpu.build_stencil(text)
  try:
    theirs = jax_source.generate(jax_stencil, shape, 'numpy')
  except AttributeError:
    # the JAX printer cannot apply abs or ! to a literal (the port's
    # can): hold the program to the JAX package's XlaExecutor instead
    theirs = None
  if theirs is not None:
    assert torch_source.generate(stencil, shape, 'numpy') == theirs
  if jax:
    if theirs is not None:
      program = _module(jax_source.generate(jax_stencil, shape, 'jax'))
      jax_got = program.compute(*_args(stencil, inputs, params))
    else:  # the JAX package's own computation of the program
      jax_got = XlaExecutor(jax_stencil, shape)(inputs, params)
    check_outputs(stencil, shape, got, _grid(jax_got, shape),
                  context + ' vs jax')
  return stencil


@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_corpus_programs_match_oracle_numpy_and_jax(name):
  stencil = corpus.build(name)
  shape = corpus.TEST_DIMS[name]
  _check(corpus.CORPUS[name], shape,
         reference.make_test_inputs(stencil, shape),
         reference.make_test_params(stencil), context=name)


@pytest.mark.parametrize('seed', list(FUZZ_SEEDS)[:6])
def test_fuzz_programs_match_oracle_numpy_and_jax(seed):
  # narrow programs: the jax.numpy Evaluator's domain on the CPU
  text = gen_program(seed, narrow=True)
  stencil = api.build_stencil(text)
  _check(text, FUZZ_SHAPE, make_inputs(stencil, FUZZ_SHAPE, seed),
         context='fuzz%d' % seed)


@pytest.mark.parametrize('seed', list(FUZZ_SEEDS)[6:16])
def test_wide_fuzz_programs_match_oracle_and_numpy(seed):
  # every integer width, integer division and double: beyond what the
  # JAX package computes on the CPU without 64-bit mode
  text = gen_program(seed)
  stencil = api.build_stencil(text)
  _check(text, FUZZ_SHAPE, make_inputs(stencil, FUZZ_SHAPE, seed),
         context='wide fuzz%d' % seed, jax=False)


_DIVISION = '''
kernel: division
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 %(t)s: a(16, *)
input dram 0 %(t)s: b(16, *)
output dram 1 %(t)s: q(0, 0) = a(0, 0) / b(0, 1)
output dram 1 %(t)s: r(0, 0) = a(0, 1) %% b(0, 0)
output dram 1 %(t)s: m(0, 0) = min(a(0, 0), b(0, 0)) - max(-a(0, 1), b(0, 1))
output dram 1 uint8: c(0, 0) = uint8(a(0, 0) < b(0, 0))
'''


@pytest.mark.parametrize('dtype', ['int16', 'uint16', 'int32', 'uint32',
                                   'int64', 'uint64', 'int40', 'uint24'])
def test_division_by_zero_and_unsigned_widths(dtype):
  """Division and remainder by zero, MIN / -1, and min, max, negation
  and comparison at every width: the oracle's values."""
  text = _DIVISION % {'t': dtype}
  stencil = api.build_stencil(text)
  shape = (6, 16)
  inputs = make_inputs(stencil, shape, 7)
  t = stencil.symbol_table['b']
  inputs['b'][::2] = 0
  inputs['b'][1] = -1 if t.is_signed else (1 << t.width_in_bits) - 1
  _check(text, shape, inputs, context='division %s' % dtype, jax=False)


def test_header_and_imports():
  stencil = corpus.build('jacobi2d')
  for target in ('torch', 'numpy'):
    src = torch_source.generate(stencil, (24, 32), target)
    assert 'kernel: jacobi2d' in src and 'stencil distance' in src
    assert 'stencil window' in src
    imported = set()
    for node in ast.walk(ast.parse(src)):
      if isinstance(node, ast.Import):
        imported.update(alias.name.split('.')[0] for alias in node.names)
      elif isinstance(node, ast.ImportFrom):
        imported.add(node.module.split('.')[0])
    assert imported == ({'argparse', 'numpy', 'torch'} if target == 'torch'
                        else {'numpy'}), (target, imported)
    assert 'soda_tpu' not in src and 'jax' not in src


def test_main_runs_on_the_cpu_and_needs_the_card_by_default(capsys):
  stencil = corpus.build('blur')
  module = _module(torch_source.generate(stencil, (24, 64)))
  module.main(['--device', 'cpu'])
  torch_sums = capsys.readouterr().out
  _module(torch_source.generate(stencil, (24, 64), 'numpy')).main()
  numpy_sums = capsys.readouterr().out
  assert torch_sums == numpy_sums and 'blur_y checksum' in torch_sums
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='no CUDA device'):
      module.main([])


def test_unknown_target():
  with pytest.raises(ValueError, match='unknown codegen target'):
    torch_source.generate(corpus.build('blur'), target='jax')
