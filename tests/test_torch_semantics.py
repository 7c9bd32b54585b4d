"""The port's torch Evaluator against soda_tpu.backend.semantics.

Random expressions over every integer width and sign (uint16, uint32
and uint64 included, which torch cannot add or compare natively, and
widths that are not a power of two), ``/ %`` with zero divisors and
MIN / -1, bitwise ops, comparisons, ``min/max/select/abs/round``, and
half/float/double values. Each expression goes through the DSL parser
and the pass pipeline, then through the NumPy oracle's Evaluator and
the port's on the same seeded numpy inputs; narrow (<= 32-bit,
division-free) programs also go through the Evaluator with jax.numpy.
Integers must agree bit for bit, floats within the reference threshold
(tests/checks.py) with NaNs in the same cells.
"""

import numpy as np
import pytest
import torch

import soda_tpu
from soda_tpu.backend import semantics as oracle
from soda_tpu_torch.api import build_stencil
from soda_tpu_torch.backend import semantics
from soda_tpu_torch.ir.types import Type
from soda_tpu_torch.testing import gen_program, make_inputs

from checks import assert_close_reference

torch.set_num_threads(1)

SHAPE = (8, 16)


def _build(seed, narrow=False):
  """(program, the port's stencil, its output, the JAX package's output)
  from one DSL text: each side builds with its own classes."""
  program = gen_program(seed, narrow)
  stencil = build_stencil(program)
  jax_tensor = soda_tpu.build_stencil(program).tensors['o']
  return program, stencil, stencil.tensors['o'], jax_tensor


def _compare(got, want, t: Type, context: str):
  got = np.asarray(got)
  want = np.asarray(want)
  assert got.dtype == want.dtype, (got.dtype, want.dtype, context)
  if not t.is_float:
    np.testing.assert_array_equal(got, want, err_msg=context)
    return
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want), context)
  ok = ~np.isnan(want)
  assert_close_reference(got[ok], want[ok], True, context)


def _numpy_eval(tensor, inputs):
  ev = oracle.Evaluator(np, lambda ref: inputs[ref.name])
  with np.errstate(all='ignore'):
    value, _ = ev.eval_stmt(tensor)
    return oracle.wrap(np, value, tensor.dtype)


def _torch_eval(stencil, tensor, inputs):
  ins = {n: semantics.to_repr(torch.from_numpy(np.ascontiguousarray(a)),
                              stencil.symbol_table[n])
         for n, a in inputs.items()}
  ev = semantics.Evaluator(lambda ref: ins[ref.name])
  value, vt = ev.eval_stmt(tensor)
  value = semantics.wrap(value, tensor.dtype, vt)
  value = value.expand(SHAPE) if value.dim() == 0 else value
  return semantics.to_storage(value, tensor.dtype).numpy()


@pytest.mark.parametrize('seed', range(60))
def test_random_expressions_match_oracle(seed):
  program, stencil, tensor, jax_tensor = _build(seed)
  inputs = make_inputs(stencil, SHAPE, seed)
  want = np.broadcast_to(_numpy_eval(jax_tensor, inputs), SHAPE)
  got = _torch_eval(stencil, tensor, inputs)
  _compare(got, want, tensor.dtype, 'seed=%d\n%s' % (seed, program))


@pytest.mark.parametrize('seed', range(100, 125))
def test_random_expressions_match_jax_numpy(seed):
  import jax.numpy as jnp
  program, stencil, tensor, jax_tensor = _build(seed, narrow=True)
  inputs = make_inputs(stencil, SHAPE, seed)
  ev = oracle.Evaluator(jnp, lambda ref: jnp.asarray(inputs[ref.name]))
  value, _ = ev.eval_stmt(jax_tensor)
  want = np.broadcast_to(np.asarray(oracle.wrap(jnp, value, tensor.dtype)),
                         SHAPE)
  got = _torch_eval(stencil, tensor, inputs)
  _compare(got, want, tensor.dtype, 'jnp seed=%d\n%s' % (seed, program))


@pytest.mark.parametrize('tname', ['int32', 'int64', 'uint32', 'uint64'])
def test_c_division_edge_cases(tname):
  """Zero divisors and MIN / -1 give the oracle's results."""
  t = Type(tname)
  info = np.iinfo(t.np_dtype)
  vals = [0, 1, -1, 7, -7, 2, info.min, info.max, 3]
  a = np.array([x for x in vals for _ in vals], dtype=object)
  b = np.array([y for _ in vals for y in vals], dtype=object)
  a = oracle.wrap(np, np.array([int(v) % (1 << 64) for v in a],
                               np.uint64).view(np.int64), t)
  b = oracle.wrap(np, np.array([int(v) % (1 << 64) for v in b],
                               np.uint64).view(np.int64), t)
  with np.errstate(all='ignore'):
    want_q = oracle.c_int_div(np, a, b)
    want_r = oracle.c_int_mod(np, a, b)
  ta = semantics.to_repr(torch.from_numpy(a), t)
  tb = semantics.to_repr(torch.from_numpy(b), t)
  got_q = semantics.to_storage(semantics.c_int_div(ta, tb, t), t).numpy()
  got_r = semantics.to_storage(semantics.c_int_mod(ta, tb, t), t).numpy()
  np.testing.assert_array_equal(got_q, want_q)
  np.testing.assert_array_equal(got_r, want_r)


@pytest.mark.parametrize('tname', ['int16', 'uint16', 'int8', 'uint8',
                                   'int32', 'uint32', 'int12', 'uint3',
                                   'int40'])
def test_wrap_and_wrap_promoted(tname):
  t = Type(tname)
  rng = np.random.default_rng(3)
  v = np.concatenate([rng.integers(-2**40, 2**40, 256),
                      [0, 1, -1, 2**31 - 1, -2**31, 2**32, 65535, 65536]])
  want = oracle.wrap(np, v, t)
  got = semantics.to_storage(semantics.wrap(torch.from_numpy(v), t), t)
  np.testing.assert_array_equal(got.numpy(), want)
  if t.width_in_bits <= 32:
    want_p = oracle.wrap_promoted(np, v.astype(oracle.promote(t).np_dtype), t)
    got_p = semantics.wrap_promoted(torch.from_numpy(v), t)
    np.testing.assert_array_equal(
        semantics.to_storage(got_p, oracle.promote(t)).numpy(), want_p)


@pytest.mark.parametrize('tname,values', [
    ('int16', [2.9, -2.9, 0.5, -0.5, 32767.9, -32768.0]),
    ('int32', [2.9, -2.9, 1e9 + 0.5, -1e9]),
    ('uint16', [2.9, 0.5, 65535.4, 100.0]),
    ('int12', [2.9, -2.9, 2047.5, -2048.0]),
])
def test_float_to_int_truncates_in_range(tname, values):
  t = Type(tname)
  v = np.array(values, np.float64)
  want = oracle.wrap(np, v, t)
  got = semantics.to_storage(semantics.wrap(torch.from_numpy(v), t), t)
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('fn', ['exp', 'log', 'sin', 'cos', 'tan', 'tanh',
                                'rsqrt', 'sqrt'])
@pytest.mark.parametrize('tname', ['float', 'double', 'half'])
def test_transcendentals_within_threshold(fn, tname):
  src = '\n'.join([
      'kernel: tr', 'burst width: 64', 'unroll factor: 1', 'iterate: 1',
      'border: ignore', 'cluster: none',
      'input dram 0 %s: x(16, *)' % tname,
      'output dram 1 %s: o(0, 0) = %s(x(0, 0)) + pow(x(0, 0), 1.5f)' % (
          'double' if tname == 'double' else 'float', fn)])
  stencil = build_stencil(src)
  tensor = stencil.tensors['o']
  t = stencil.symbol_table['x']
  x = (np.random.default_rng(5).random(SHAPE) * 3 + 0.25)
  inputs = {'x': x.astype(t.np_dtype)}
  want = _numpy_eval(soda_tpu.build_stencil(src).tensors['o'], inputs)
  got = _torch_eval(stencil, tensor, inputs)
  _compare(got, want, tensor.dtype, '%s %s' % (fn, tname))


def test_round_is_half_to_even():
  src = '\n'.join([
      'kernel: rd', 'burst width: 64', 'unroll factor: 1', 'iterate: 1',
      'border: ignore', 'cluster: none', 'input dram 0 float: x(16, *)',
      'output dram 1 float: o(0, 0) = round(x(0, 0))'])
  stencil = build_stencil(src)
  x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 2.4999998, 3.5, -2.5]],
               np.float32)
  got = _torch_eval(stencil, stencil.tensors['o'], {'x': x})
  np.testing.assert_array_equal(got.reshape(-1)[:8],
                                [0, 2, 2, -0, -2, 2, 4, -2])


def test_storage_round_trip_of_unsigned_types():
  for tname, info in (('uint16', np.iinfo(np.uint16)),
                      ('uint32', np.iinfo(np.uint32)),
                      ('uint64', np.iinfo(np.uint64))):
    t = Type(tname)
    v = np.array([0, 1, info.max, info.max // 2 + 1], dtype=t.np_dtype)
    back = semantics.to_storage(semantics.to_repr(torch.from_numpy(v), t), t)
    np.testing.assert_array_equal(back.numpy(), v)
