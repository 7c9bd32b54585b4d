"""The port's float conversions against numpy's: each rounds once.

torch's own ``Tensor.to`` rounds a double to half through float32, and
the port once converted a uint64 to double by adding 2**64 to its int64
pattern: two roundings each, where numpy's ``astype`` (the oracle), the
JAX executor and the generated kernel round once (faults C5 and C6).
``semantics.half_of_double`` and ``semantics.float_of_u64`` round once;
the printed program (``--emit-torch``) carries its own copies.

Here, on the CPU:

- ``semantics.wrap`` and the printed ``_cast`` equal numpy bit for bit
  on doubles next to half midpoints, the specials and seeded values, and
  on uint64 values next to float and double midpoints.
- Fault C5's programs (fuzz 221 at (20, 48), nine more at (40, 96)),
  fault C6's two and the ``testing.CAST_SEEDS`` programs run through
  ``WholeGridExecutor``, ``fused_stencil_plain`` and the printed
  program, each equal as numbers to the NumPy oracle (NaN to NaN, +0 to
  -0) and within the reference threshold of the JAX ``XlaExecutor`` under
  x64, built from the same DSL text (the C6 and conversion programs equal
  to it as numbers).

tests/test_torch_cuda_source.py holds the kernel's host loop to the
oracle on the same programs.
"""

import types

import jax
import numpy as np
import pytest
import torch

import soda_tpu
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu_torch import api, testing
from soda_tpu_torch.backend import reference, semantics
from soda_tpu_torch.backend.fused import fused_stencil_plain
from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
from soda_tpu_torch.codegen import torch_source
from soda_tpu_torch.ir.types import Type

torch.set_num_threads(1)

CAST_SHAPE = (24, 64)
_PRINTED = {'torch': torch}
exec(compile(torch_source._PRELUDE, '<prelude>', 'exec'), _PRINTED)


def _bits(a: np.ndarray) -> np.ndarray:
  return a.view('u%d' % a.dtype.itemsize)


def _doubles(kind: str) -> np.ndarray:
  rng = np.random.default_rng(16)
  if kind == 'midpoints':
    return testing.half_midpoints()
  if kind == 'above':
    return np.nextafter(testing.half_midpoints(), np.inf)
  if kind == 'below':
    return np.nextafter(testing.half_midpoints(), -np.inf)
  if kind == 'specials':
    tiny = 2.0 ** -24  # the least half subnormal
    values = [np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 65504.0, 65520.0,
              np.nextafter(65520.0, 0), np.nextafter(65520.0, np.inf),
              -65520.0, 1e300, -1e300, 1e-300, -1e-300, 3.5e38, -3.5e38,
              1e-40, tiny, tiny / 2, np.nextafter(tiny / 2, 0),
              np.nextafter(tiny / 2, 1), 3 * tiny / 2, -3 * tiny / 2,
              2.0 ** -14, np.nextafter(2.0 ** -14, 0), 2.0 ** 16]
    return np.array(values, np.float64)
  return np.concatenate([rng.normal(0, 8, 50000),
                         rng.uniform(-7e4, 7e4, 50000),
                         rng.normal(0, 1e-5, 20000)])


_U64 = [2**63 + 1025, 2**63 + 2**39 + 1, 2**64 - 1, 2**53 + 1, 2**63,
        2**63 - 1, 2**63 + 1, 0, 1, 65519, 65520, 2**24 + 1, 2**53 - 1,
        2**64 - 2**11 + 2**10, 2**63 + 2**40 + 2**39, 2**63 + 2**39,
        2**64 - 2**40 + 2**39]


def _u64(kind: str) -> np.ndarray:
  if kind == 'listed':
    return np.array(_U64, np.uint64)
  rng = np.random.default_rng(64)
  if kind == 'random':
    return rng.integers(0, 2**64 - 1, 50000, dtype=np.uint64, endpoint=True)
  # next to float32 and float64 midpoints, as make_cast_inputs places them
  return np.concatenate([testing._near_midpoints(rng, 25000, 24, 53, 64),
                         testing._near_midpoints(rng, 25000, 53, 53, 64)])


def _to_half(path: str, x: torch.Tensor) -> torch.Tensor:
  if path == 'wrap':
    return semantics.wrap(x, Type('half'), Type('double'))
  return _PRINTED['_cast'](x, 'float64', 'float16')


@pytest.mark.parametrize('path', ['wrap', 'printed'])
@pytest.mark.parametrize('kind', ['midpoints', 'above', 'below', 'specials',
                                  'random'])
def test_double_to_half_rounds_once(kind, path):
  x = _doubles(kind)
  with np.errstate(over='ignore'):
    want = x.astype(np.float16)
  got = _to_half(path, torch.from_numpy(x)).numpy()
  assert got.dtype == np.float16
  bad = _bits(got) != _bits(want)
  assert not bad.any(), (int(bad.sum()), x[bad][:4], got[bad][:4],
                         want[bad][:4])


def test_plain_torch_rounds_twice():
  """What the helpers repair: the doubles one ulp beside a half midpoint
  that ``Tensor.to`` rounds through float32 onto the midpoint."""
  x = np.concatenate([_doubles('above'), _doubles('below')])
  got = torch.from_numpy(x).to(torch.float16).numpy()
  assert (_bits(got) != _bits(x.astype(np.float16))).sum() > 10000


@pytest.mark.parametrize('path', ['wrap', 'printed'])
def test_half_square_root_rounds_once(path):
  rng = np.random.default_rng(5)
  x = np.abs(rng.normal(0, 100, 20000)).astype(np.float16)
  want = np.sqrt(x)
  t = torch.from_numpy(x)
  got = (semantics._sqrt(t) if path == 'wrap' else _PRINTED['_sqrt'](t))
  np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize('path', ['wrap', 'printed'])
@pytest.mark.parametrize('kind', ['listed', 'random', 'midpoints'])
@pytest.mark.parametrize('dst', ['double', 'float', 'half'])
def test_uint64_to_float_rounds_once(dst, kind, path):
  u = _u64(kind)
  with np.errstate(over='ignore'):
    want = u.astype(Type(dst).np_dtype)
  rep = torch.from_numpy(u.view(np.int64))
  if path == 'wrap':
    got = semantics.wrap(rep, Type(dst), Type('uint64'))
  else:
    got = _PRINTED['_cast'](rep, 'uint64', Type(dst).np_dtype.name)
  got = got.numpy()
  assert got.dtype == want.dtype
  bad = _bits(got) != _bits(want)
  assert not bad.any(), (int(bad.sum()), u[bad][:4], got[bad][:4],
                         want[bad][:4])


@pytest.mark.parametrize('src', ['int64', 'int32', 'uint32'])
@pytest.mark.parametrize('dst', ['double', 'float', 'half'])
def test_other_integers_to_float_round_once(src, dst):
  """The signed and 32-bit paths keep torch's conversion, which rounds
  once."""
  rng = np.random.default_rng(3)
  t = Type(src)
  info = np.iinfo(t.np_dtype)
  x = np.concatenate([
      rng.integers(info.min, info.max, 20000, dtype=np.int64, endpoint=True),
      rng.integers(-70000, 70000, 20000)]).astype(t.np_dtype)
  with np.errstate(over='ignore'):
    want = x.astype(Type(dst).np_dtype)
  got = semantics.wrap(semantics.to_repr(torch.from_numpy(x), t), Type(dst),
                       t).numpy()
  np.testing.assert_array_equal(_bits(got), _bits(want))


def _printed(stencil, shape, inputs):
  module = types.ModuleType('generated_stencil')
  exec(compile(torch_source.generate(stencil, shape), '<generated>', 'exec'),
       module.__dict__)
  return module.compute(*[torch.from_numpy(np.ascontiguousarray(inputs[n]))
                          for n in stencil.input_names])


def _paths(stencil, shape, inputs):
  """The three CPU paths' outputs: name -> {output: tensor}."""
  tensors = [torch.from_numpy(np.ascontiguousarray(inputs[n]))
             for n in stencil.input_names]
  return {
      'whole-grid': WholeGridExecutor(stencil, shape, device='cpu')(inputs),
      'plain': dict(zip(stencil.output_names,
                        fused_stencil_plain(stencil, tensors))),
      'printed': _printed(stencil, shape, inputs),
  }


def _jax(text, shape, inputs):
  with jax.enable_x64(True):
    outs = XlaExecutor(soda_tpu.build_stencil(text), shape)(inputs)
    return {k: np.broadcast_to(np.asarray(v), shape) for k, v in outs.items()}


def _check(label, text, shape, inputs, jax_exact=False):
  """Every CPU path equal as numbers to the oracle and within the
  reference threshold of it and of the JAX executor (``jax_exact``: equal
  as numbers to it too; the fuzz programs' doubles may differ from it in
  the last bit); returns the outputs."""
  stencil = api.build_stencil(text)
  with np.errstate(all='ignore'):
    want = reference.run(stencil, inputs)
  jax_got = _jax(text, shape, inputs)
  got = _paths(stencil, shape, inputs)
  for path, outs in got.items():
    where = '%s %s' % (label, path)
    testing.check_exact(stencil, shape, outs, want, where, values=True)
    testing.check_outputs(stencil, shape, outs, want, where)
    testing.check_outputs(stencil, shape, outs, jax_got, where + ' vs jax')
    if jax_exact:
      testing.check_exact(stencil, shape, outs, jax_got, where + ' vs jax',
                          values=True)
  return got, want, jax_got


_REGRESSIONS = testing.regression_cases()


@pytest.mark.parametrize('case', range(len(_REGRESSIONS)),
                         ids=[c[0].replace(' ', '-') for c in _REGRESSIONS])
def test_regression_program_matches_oracle_and_jax(case):
  _check(*_REGRESSIONS[case])


def test_fuzz221_rounds_its_half_once():
  """Fault C5's first cell: x[4, 28] = -2.8544921438073656 lies one
  double-ulp beside a half midpoint (-5.14453125 when rounded twice)."""
  label, text, shape, inputs = _REGRESSIONS[0]
  assert (label, shape) == ('c5 fuzz221', (20, 48))
  got, want, _ = _check(label, text, shape, inputs)
  assert float(want['o'][3, 28]) == -5.146484375
  for outs in got.values():
    assert float(outs['o'][3, 28]) == -5.146484375


@pytest.mark.parametrize('out_type,value,expected', [
    ('double', 2**63 + 1025, 2.0**63 + 2048),
    ('float', 2**63 + 2**39 + 1, float(np.float32(2**63 + 2**40)))])
def test_c6_gives_numpys_value(out_type, value, expected):
  text = testing.c6_program(out_type)
  shape = testing.FUZZ_SHAPE
  got, want, jax_got = _check('c6 ' + out_type, text, shape,
                              {'a': np.full(shape, value, np.uint64)},
                              jax_exact=True)
  assert float(want['o'][0, 0]) == expected
  assert float(np.asarray(jax_got['o'])[0, 0]) == expected
  for outs in got.values():
    assert float(outs['o'][0, 0]) == expected


@pytest.mark.parametrize('seed', testing.CAST_SEEDS)
def test_cast_program_matches_oracle_and_jax(seed):
  text = testing.gen_cast_program(seed)
  stencil = api.build_stencil(text)
  _check('cast%d' % seed, text, CAST_SHAPE,
         testing.make_cast_inputs(stencil, CAST_SHAPE, seed), jax_exact=True)


def test_cast_programs_reach_every_conversion():
  """Between them the programs convert uint64, int64 and uint32 to each
  float type and double to float and half, and compute on halves; each
  has a uint64 input and one output that a second rounding would move."""
  texts = [testing.gen_cast_program(seed) for seed in testing.CAST_SEEDS]
  reached = set()
  for text in texts:
    stencil = api.build_stencil(text)
    types_ = {n: stencil.symbol_table[n].np_dtype.name
              for n in stencil.input_names}
    assert 'uint64' in (types_['a'], types_['b'])
    probe = text.splitlines()[-2]
    assert ('half(x(' in probe and types_['x'] == 'float64') or \
        'uint64' in [types_[v] for v in 'ab' if '%s(' % v in probe]
    for src in ('uint64', 'int64', 'uint32'):
      for dst in ('double', 'float', 'half'):
        for v in 'ab':
          if types_[v] == src and '%s(%s(' % (dst, v) in text:
            reached.add((src, dst))
    if types_['x'] == 'float64':
      reached.update(('double', dst) for dst in ('float', 'half')
                     if '%s(x(' % dst in text)
  want = {(s, d) for s in ('uint64', 'int64') for d in ('double', 'float',
                                                        'half')}
  assert want | {('double', 'half')} <= reached, sorted(reached)


def test_cast_inputs_sit_next_to_midpoints():
  text = testing.gen_cast_program(testing.CAST_SEEDS[0])
  stencil = api.build_stencil(text)
  first = testing.make_cast_inputs(stencil, CAST_SHAPE, 1)
  again = testing.make_cast_inputs(stencil, CAST_SHAPE, 1)
  for name in stencil.input_names:
    np.testing.assert_array_equal(first[name], again[name])
  wide = next(first[n] for n in 'ab'
              if stencil.symbol_table[n].np_dtype == np.uint64)
  assert (wide >= np.uint64(2**53)).mean() > 0.3
  # the moved 64-bit values sit within one of a float or double midpoint

  def near(v, bits):
    step = 1 << (v.bit_length() - bits)
    return any((v + d) % step == step // 2 for d in (-1, 0, 1))

  big = wide[wide >= np.uint64(2**53)].astype(object)
  assert np.mean([near(v, 24) or near(v, 53) for v in big]) > 0.5


@pytest.mark.parametrize('path', ['wrap', 'printed'])
def test_phase28_values_round_once(path):
  """``testing.cast_values()``, which chip_smoke.py's phase 28 converts
  on the card, through both helpers bit for bit against numpy."""
  doubles, wides = testing.cast_values()
  got = _to_half(path, torch.from_numpy(doubles)).numpy()
  with np.errstate(over='ignore'):
    np.testing.assert_array_equal(_bits(got),
                                  _bits(doubles.astype(np.float16)))
  rep = torch.from_numpy(wides.view(np.int64))
  for dst in ('double', 'float', 'half'):
    if path == 'wrap':
      got = semantics.wrap(rep, Type(dst), Type('uint64'))
    else:
      got = _PRINTED['_cast'](rep, 'uint64', Type(dst).np_dtype.name)
    with np.errstate(over='ignore'):
      want = wides.astype(Type(dst).np_dtype)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
