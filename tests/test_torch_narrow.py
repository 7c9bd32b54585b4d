"""The narrow probes' plain versions against the JAX scripts' probes.

``soda_tpu_torch/experiments/narrow.py`` ports the Pallas probes of
exp13, exp29, exp16, exp12, exp1 and exp2. Their kernel runs only on the
card (tests/test_torch_gpu.py; a g++ emulation of its text in
tests/test_torch_narrow_emulation.py); here the plain versions, which
the card's kernel is held to, are held to the JAX scripts, each loaded
by path, on the CPU:

- Pallas kernels the scripts call eagerly (exp12's ``run1``,
  ``chain_kernel``, ``roll_kernel``, ``widen_kernel``; exp13's
  ``legal_probes``; exp1's and exp2's ``probe_i16_ops`` and exp1's
  ``probe_sublane_roll``) run under ``pltpu.force_tpu_interpret_mode``
  with ``pallas_call`` wrapped to record each call's inputs and output:
  the port's inputs equal the script's, bit for bit, and its plain
  version equals the script's output.
- Chains the scripts build inside a timing harness (exp13's
  ``chain_time``, exp2's ``vpu_chain``): the module's ``slope`` is
  replaced by one that keeps the kernel of ``n_small`` (32) iterations,
  which then runs on the port's seeded input. exp16's ``wide_kernel`` and
  ``swar_kernel`` run at 1, 2 and 5 iterations. exp29's bodies are
  captured by wrapping its ``pallas_loop``; the six that lower on the
  CPU run there at 1 and 2 iterations (``roll_strided`` on a (256, 256)
  block: interpret mode takes 25 s an iteration at (256, 1024)), and
  ``roll10_packed`` and ``pack_roundtrip`` (``pack_elementwise`` has no
  CPU lowering) are held to numpy statements of the TPU's semantics.

Integers bit for bit, floats within ``probes.CHAIN_RTOL`` relative (XLA
on the CPU may fuse exp2's multiply-add).
"""

import contextlib
import dataclasses
import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from soda_tpu_torch import utils
from soda_tpu_torch.experiments import (exp1_value_mode, exp2_diag,
                                        exp12_mosaic_reprobe,
                                        exp13_narrow_i16, exp16_swar_erosion,
                                        exp29_pack_i16, narrow, probes)

REPO = pathlib.Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _script(name):
  spec = importlib.util.spec_from_file_location(
      'jax_' + name, REPO / 'experiments' / (name + '.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  module.log = lambda *a: None
  return module


@contextlib.contextmanager
def _recorded_pallas_calls():
  """Every eager ``pallas_call`` in forced TPU interpret mode, its inputs
  and output recorded in order."""
  calls = []
  original = pl.pallas_call

  def wrapped(*args, **kwargs):
    call = original(*args, **kwargs)

    def run(*xs):
      out = call(*xs)
      calls.append(([np.asarray(x) for x in xs], np.asarray(out)))
      return out
    return run

  pl.pallas_call = wrapped
  try:
    with pltpu.force_tpu_interpret_mode():
      yield calls
  finally:
    pl.pallas_call = original


def _assert_same(got: torch.Tensor, want, name, float_rtol=False):
  want = torch.from_numpy(np.ascontiguousarray(want))
  assert tuple(got.shape) == tuple(want.shape), name
  if float_rtol:
    _, rel = probes.max_error(got, want)
    assert rel <= probes.CHAIN_RTOL, (name, rel)
  else:
    assert np.array_equal(got.numpy(), want.numpy().view(
        got.numpy().dtype)), name


def _plain(body, n=1):
  return body.plain(*narrow.body_inputs(body, 'cpu'), n=n)


# -- the scripts' eager probes, recorded once --------------------------------

@pytest.fixture(scope='module')
def exp12_run():
  """exp12's main() with every group: (tag, inputs, output) per case."""
  script = _script('exp12_mosaic_reprobe')
  tags = []
  script.probe = lambda tag, build, args, want=None: (
      tags.append(tag), build(*args))
  old_argv = sys.argv
  sys.argv = ['exp12']
  try:
    with _recorded_pallas_calls() as calls:
      script.main()
  finally:
    sys.argv = old_argv
  return [(tag, ins, out) for tag, (ins, out) in zip(tags, calls)]


@pytest.fixture(scope='module')
def exp13_legal():
  """exp13's legal_probes: (tag, inputs, output, want) per case."""
  script = _script('exp13_narrow_i16')
  cases = []
  script.probe = lambda tag, fn, want=None: cases.append((tag, want, fn()))
  with _recorded_pallas_calls() as calls:
    script.legal_probes()
  return [(tag, ins, out, want) for (tag, want, _), (ins, out) in
          zip(cases, calls)]


@pytest.fixture(scope='module')
def i16_probes():
  """exp1's probe_i16_ops and probe_sublane_roll, exp2's probe_i16_ops:
  {script: [(inputs, output)]}."""
  out = {}
  for name, fns in (('exp1', ('probe_i16_ops', 'probe_sublane_roll')),
                    ('exp2', ('probe_i16_ops',))):
    script = _script({'exp1': 'exp1_value_mode', 'exp2': 'exp2_diag'}[name])
    with _recorded_pallas_calls() as calls:
      for fn in fns:
        getattr(script, fn)()
    out[name] = calls
  return out


def _nonbitwise(bodies):
  return [b for b in bodies if not b.case.endswith('[bitwise]')]


def test_exp12_cases_inputs_and_outputs(exp12_run):
  bodies = _nonbitwise(narrow.EXP12)
  assert [b.case for b in bodies] == [tag for tag, _, _ in exp12_run]
  assert len(bodies) == 15
  for body, (tag, ins, out) in zip(bodies, exp12_run):
    xs = narrow.body_inputs(body, 'cpu')
    assert len(xs) == len(ins) == body.n_inputs, tag
    for x, want in zip(xs, ins):
      _assert_same(x, want, tag)
    assert tuple(out.shape) == body.shape, tag
    assert np.dtype(out.dtype).itemsize == body.dtype.itemsize, tag
    _assert_same(body.plain(*xs), out, tag)
  # the bitwise forms compute their twin's function on its inputs
  for body in narrow.EXP12:
    if body.case.endswith('[bitwise]'):
      twin = narrow.BODIES[body.name[:-len(' [bitwise]')]]
      assert narrow._BINARY[body.op] is narrow._BINARY[twin.op]
      assert [x.numpy().tobytes() for x in narrow.body_inputs(body, 'cpu')] \
          == [x.numpy().tobytes() for x in narrow.body_inputs(twin, 'cpu')]


def test_exp13_legal_cases_inputs_and_outputs(exp13_legal):
  bodies = narrow.EXP13_LEGAL
  assert [b.case for b in bodies] == [tag for tag, _, _, _ in exp13_legal]
  assert len(bodies) == 12
  for body, (tag, ins, out, want) in zip(bodies, exp13_legal):
    xs = narrow.body_inputs(body, 'cpu')
    for x, script_x in zip(xs, ins):
      _assert_same(x, script_x, tag)
    assert tuple(out.shape) == body.shape and out.dtype == np.int16, tag
    assert body.exact == (want is not None), tag
    got = body.plain(*xs)
    _assert_same(got, out, tag)
    if want is not None:
      _assert_same(got, want, tag)


def test_exp1_exp2_probes_inputs_and_outputs(i16_probes):
  for name, bodies in (('exp1', narrow.EXP1), ('exp2', narrow.EXP2_I16)):
    calls = i16_probes[name]
    assert len(calls) == len(bodies) == (5 if name == 'exp1' else 3)
    for body, (ins, out) in zip(bodies, calls):
      xs = narrow.body_inputs(body, 'cpu')
      for x, script_x in zip(xs, ins):
        _assert_same(x, script_x, body.name)
      _assert_same(body.plain(*xs), out, body.name)


# -- chains built in the scripts' timing harnesses ---------------------------

def _kept_small(script):
  """Replace ``script.slope`` by one that keeps the n_small kernel."""
  kept = []

  def slope(f_small, f_big, n_small, n_big, x0, reps=3):
    kept.append((f_small, n_small, x0.shape, x0.dtype))
    return 1.0
  script.slope = slope
  return kept


def test_exp13_chain_kinds_match_the_script():
  script = _script('exp13_narrow_i16')
  kinds = []
  script.chain_time = lambda kind, dtype, shape=(512, 2048): kinds.append(
      (kind, dtype, shape))
  old_argv = sys.argv
  sys.argv = ['exp13', 'time']
  try:
    script.main()
  finally:
    sys.argv = old_argv
  ported = [b for b in narrow.EXP13_CHAIN if not b.case.endswith('[bitwise]')]
  assert len(kinds) == len(ported) == 10
  for (kind, dtype, shape), body in zip(kinds, ported):
    assert body.case == '%s %s' % (kind, dtype)
    assert body.shape == shape and body.dtype == getattr(torch, dtype)


@pytest.mark.parametrize('body', _nonbitwise(narrow.EXP13_CHAIN),
                         ids=lambda b: b.case)
def test_exp13_chain_plain_matches_the_jax_kernel(body):
  script = _script('exp13_narrow_i16')
  kept = _kept_small(script)
  kind, dtype = body.case.split()
  x, = narrow.body_inputs(body, 'cpu')
  with pltpu.force_tpu_interpret_mode():
    script.chain_time(kind, dtype, body.shape)
    f_small, n_small, shape, dt = kept[0]
    want = np.asarray(f_small(jnp.asarray(x.numpy())))
  assert (n_small, tuple(shape), str(dt)) == (32, body.shape, dtype)
  _assert_same(body.plain(x, n=n_small), want, body.name)


def test_exp2_vpu_chain_cases_match_the_script():
  script = _script('exp2_diag')
  cases = []
  script.vpu_chain = lambda kind, shape=(512, 2048), dtype='float32': \
      cases.append((kind, tuple(shape), dtype))
  script.probe_i16_ops = script.dma_ceiling = lambda *a, **k: None
  script.main()
  assert len(cases) == len(narrow.EXP2_CHAIN) == 8
  for (kind, shape, dtype), body in zip(cases, narrow.EXP2_CHAIN):
    assert body.case == '%s %s %s' % (kind, dtype, shape)
    assert body.shape == shape and body.dtype == getattr(torch, dtype)


@pytest.mark.parametrize('body', narrow.EXP2_CHAIN, ids=lambda b: b.case)
def test_exp2_vpu_chain_plain_matches_the_jax_kernel(body):
  script = _script('exp2_diag')
  kept = _kept_small(script)
  kind = body.case.split()[0]
  x, = narrow.body_inputs(body, 'cpu')
  with pltpu.force_tpu_interpret_mode():
    script.vpu_chain(kind, body.shape, str(body.dtype).split('.')[-1])
    f_small, n_small, _, _ = kept[0]
    want = np.asarray(f_small(jnp.asarray(x.numpy())))
  assert n_small == 32
  _assert_same(body.plain(x, n=n_small), want, body.name,
               float_rtol=body.dtype == torch.float32)


def test_exp16_kernels_match_the_jax_kernels():
  script = _script('exp16_swar_erosion')
  wide, swar, swar_bitwise = narrow.EXP16
  raw, = narrow.body_inputs(wide, 'cpu')
  words, = narrow.body_inputs(swar, 'cpu')
  assert torch.equal(words.view(torch.int16), raw)
  assert (wide.shape, swar.shape) == ((512, 2048), (512, 1024))
  assert narrow.EXP16_DISTS == script.DISTS
  for n in probes.CHECK_ITERS:
    _assert_same(wide.plain(raw, n=n),
                 np.asarray(script.wide_kernel()(n)(jnp.asarray(raw.numpy()))),
                 ('wide', n))
    want = np.asarray(script.swar_kernel()(n)(jnp.asarray(words.numpy())))
    _assert_same(swar.plain(words, n=n), want, ('swar', n))
    _assert_same(swar_bitwise.plain(words, n=n), want, ('swar bitwise', n))


@pytest.fixture(scope='module')
def exp29_bodies():
  """exp29's main() (not its interpret path): each probe's tag, body,
  shape, dtype and input, its pallas_loop and timing harness replaced."""
  script = _script('exp29_pack_i16')
  original = script.pallas_loop
  captured = []

  def capture(body, n, shape=script.SHAPE, dtype=None):
    def call(x):
      captured.append((body, tuple(shape), np.dtype(dtype or jnp.int32),
                       np.asarray(x)))
      return x
    return call

  tags = []
  script.pallas_loop = capture
  script.slope = lambda *a, **k: 1.0
  script.log = lambda line, *a: tags.append(line.split()[0])
  old_argv = sys.argv
  sys.argv = ['exp29']
  try:
    script.main()
  finally:
    sys.argv = old_argv
  return script, original, dict(zip(tags, captured))


def test_exp29_probes_match_the_script(exp29_bodies):
  script, _, bodies = exp29_bodies
  assert list(bodies) == [b.case for b in narrow.EXP29]
  assert narrow.EXP29_DISTS == script.DISTS
  for body in narrow.EXP29:
    _, shape, dtype, x = bodies[body.case]
    assert body.shape == shape, body.case
    assert dtype.itemsize == body.dtype.itemsize, body.case
    _assert_same(narrow.body_inputs(body, 'cpu')[0], x, body.case)


LOWERED = ('ew_i32', 'ew_i16_addxor', 'ew_i32_addxor', 'roll10_i32',
           'roll_strided', 'min_i16')


@pytest.mark.parametrize('case', LOWERED)
def test_exp29_plain_matches_the_jax_kernel(exp29_bodies, case):
  _, pallas_loop, bodies = exp29_bodies
  jax_body, shape, dtype, x = bodies[case]
  body = narrow.BODIES['exp29 ' + case]
  if case == 'roll_strided':  # interpret mode: 25 s an iteration at 1024
    shape, x = (256, 256), x[:, :256].copy()
    body = dataclasses.replace(body, shape=shape)
  for n in (1, 2):
    with pltpu.force_tpu_interpret_mode():
      want = np.asarray(pallas_loop(jax_body, n, shape=shape,
                                    dtype=jnp.dtype(dtype))(jnp.asarray(x)))
    _assert_same(body.plain(torch.from_numpy(x), n=n), want, (case, n))


def _np_halves(w):
  w = w.astype(np.uint32)
  return ((w & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int32),
          (w >> 16).astype(np.uint16).view(np.int16).astype(np.int32))


def _np_pack(lo, hi):
  return ((lo.astype(np.int64) & 0xFFFF) |
          ((hi.astype(np.int64) & 0xFFFF) << 16)).astype(np.uint32)


def test_exp29_packed_bodies_hold_the_tpu_semantics(exp29_bodies):
  """pltpu.unpack_elementwise(packed_dtype=int16, unpacked_dtype=int32)
  sign-extends (index 0 the low half), pack_elementwise keeps each
  value's low 16 bits: roll10_packed is a signed min chain on each half,
  pack_roundtrip adds 1 to the low half only (32767 + 1 wraps to
  -32768)."""
  _, _, bodies = exp29_bodies
  xh = bodies['roll10_packed'][3]
  lo, hi = _np_halves(xh)
  for n in probes.CHECK_ITERS:
    want_lo, want_hi = lo.copy(), hi.copy()
    for _ in range(n):
      for d in narrow.EXP29_DISTS:
        want_lo = np.minimum(want_lo, np.roll(want_lo, d, 0))
        want_hi = np.minimum(want_hi, np.roll(want_hi, d, 0))
    got = _plain(narrow.BODIES['exp29 roll10_packed'], n)
    assert np.array_equal(got.numpy().view(np.uint32),
                          _np_pack(want_lo, want_hi)), n
    got = _plain(narrow.BODIES['exp29 pack_roundtrip'], n)
    assert np.array_equal(got.numpy().view(np.uint32),
                          _np_pack(lo + n, hi)), n
  edge = torch.tensor([[0x00007FFF, 0x7FFF7FFF, -1, 0x12348000]],
                      dtype=torch.int32)
  step = narrow._EW['PackRoundtrip'](edge).numpy().view(np.uint32)
  assert list(step[0]) == [0x00008000, 0x7FFF8000, 0xFFFF0000, 0x12348001]


def test_exp29_halves_are_roll10_on_each_half():
  words, = narrow.body_inputs('exp29 roll10_packed', 'cpu')
  roll10 = dataclasses.replace(narrow.BODIES['exp29 roll10_i32'],
                               shape=(256, 512))
  for n in probes.CHECK_ITERS:
    lo, hi = narrow.halves(narrow.BODIES['exp29 roll10_packed'].plain(
        words, n=n))
    want_lo, want_hi = (roll10.plain(h.to(torch.int32), n=n) for h in
                        narrow.halves(words))
    assert torch.equal(lo.to(torch.int32), want_lo)
    assert torch.equal(hi.to(torch.int32), want_hi)


def test_exp29_interpret_path_is_not_the_tpu_function(exp29_bodies):
  """The script's own interpret path (``interpret`` on its command
  line) unpacks the halves unsigned and replaces pack_roundtrip and
  roll_strided by v + 1: on this input each gives another answer than
  the TPU function the port computes, so it is not what the port
  follows."""
  script = _script('exp29_pack_i16')
  bodies = []
  script.pallas_loop = lambda body, n, shape=None, dtype=None: (
      bodies.append(body) or (lambda x: x))
  old_argv = sys.argv
  sys.argv = ['exp29', 'interpret']
  try:
    script.main()
  finally:
    sys.argv = old_argv
  emulated = dict(zip([b.case for b in narrow.EXP29], bodies))
  assert len(bodies) == len(narrow.EXP29)
  _, _, captured = exp29_bodies
  for case in ('roll10_packed', 'pack_roundtrip', 'roll_strided'):
    x = captured[case][3]
    out = np.asarray(emulated[case](jnp.asarray(x)))
    got = _plain(narrow.BODIES['exp29 ' + case])
    assert not np.array_equal(out.view(np.int32), got.numpy()), case


# -- identities that pin the packed forms ------------------------------------

def test_exp16_swar_equals_wide():
  wide, swar, swar_bitwise = narrow.EXP16
  for n in probes.CHECK_ITERS:
    want = _plain(wide, n)
    assert torch.equal(_plain(swar, n).view(torch.int16), want)
    assert torch.equal(_plain(swar_bitwise, n).view(torch.int16), want)


def test_exp13_swar_equals_lane_min_on_its_halves():
  pk = narrow.BODIES['exp13 lane_swar_pk int32']
  lane_min = narrow.BODIES['exp13 lane_min int16']
  words, = narrow.body_inputs(pk, 'cpu')
  for n in probes.CHECK_ITERS + (32,):
    assert torch.equal(pk.plain(words, n=n).view(torch.int16),
                       lane_min.plain(words.view(torch.int16), n=n))


def test_both_forms_of_a_packed_body_share_one_plain_version():
  pairs = [(b, narrow.BODIES[b.name[:-len(' [bitwise]')]])
           for b in narrow.BODIES.values() if b.case.endswith('[bitwise]')]
  assert len(pairs) == 4
  for bitwise, twin in pairs:
    assert (bitwise.form, bitwise.shape, bitwise.phases) == (
        twin.form, twin.shape, twin.phases)
    assert bitwise.op != twin.op
    xs = narrow.body_inputs(twin, 'cpu')
    for n in ((1, 2, 5) if twin.chain else (1,)):
      assert torch.equal(bitwise.plain(*xs, n=n), twin.plain(*xs, n=n))


# -- the checks can tell a wrong kernel --------------------------------------

def _differs(a, b):
  return probes.max_error(a, b) != (0, 0)


CHAINS = [b for b in narrow.BODIES.values() if b.chain]


@pytest.mark.parametrize('body', CHAINS, ids=lambda b: b.name)
def test_check_iterations_tell_a_wrong_kernel(body):
  """At CHECK_ITERS a chain's result depends on its input, and a strip's
  on each step's distance and axis: a kernel that ignores x, or shifts
  wrongly, fails its check there. The result differs from the input too,
  but for exp29's min_i16 (min(v, v + 1) is v but at 32767, which its
  input does not hold; a block that does is changed)."""
  x, = narrow.body_inputs(body, 'cpu')
  ns = probes.CHECK_ITERS
  got = [body.plain(x, n=n) for n in ns]
  if body.name == 'exp29 min_i16':
    edge = torch.full(body.shape, 32767, dtype=torch.int16)
    assert _differs(body.plain(edge), edge)
  else:
    assert _differs(got[0], x)
  other = x.flip(0).contiguous()
  assert any(_differs(g, body.plain(other, n=n)) for g, n in zip(got, ns))
  # the plain version runs the phases' steps in order: one phase a step
  steps = [(axis, d) for axis, dists in body.phases for d in dists]
  shape = body.kshape or body.shape
  for k, (axis, d) in enumerate(steps):
    wrong_steps = [(axis, d + 1)]
    if body.op != 'RollStrided' and d % shape[1 - axis]:
      wrong_steps.append((1 - axis, d))
    for step in wrong_steps:
      wrong = dataclasses.replace(body, phases=tuple(
          (a, (dd,)) for a, dd in steps[:k] + [step] + steps[k + 1:]))
      assert any(_differs(wrong.plain(x, n=n), g)
                 for n, g in zip(ns, got)), (body.name, k, step)


# -- counts, bounds and the wrapper ------------------------------------------

def test_op_and_barrier_counts_as_written():
  """Each body's ops are the least its function needs (ALU-only integer,
  integer, fp32), one count shared by every form of a function;
  barriers one a phase where there are several."""
  ops = {name: (b.ops, b.barriers, b.steps, b.elems)
         for name, b in narrow.BODIES.items()}
  # a min, however written, is one ALU op; a shift of the block is free
  for name in ('exp13 i16 where(a<b,a,b) [cmp+select min]',
               'exp13 i16 mask-min b+((a-b)&-(a<b))',
               'exp12 u32 unsigned compare select', 'exp12 native i16 min'):
    assert ops[name] == ((1, 0, 0), 0, 1, 1), name
  assert ops['exp13 i16 synth-sub a+(b^-1)+1'][0] == (0, 1, 0)
  assert ops['exp13 i16 and/or/xor'][0] == (1, 0, 0)  # a | b
  assert ops['exp13 i16 19-tap lane add fold'][0] == (0, 18, 0)
  assert ops['exp13 i16 19-tap sublane where-min fold'][0] == (18, 0, 0)
  assert ops['exp13 lane_min int16'] == ((1, 0, 0), 0, 1, 1)
  assert ops['exp13 lane_nmin int32'] == ops['exp13 lane_min int32']
  # a pair min and a byte permute (the odd lane shift) a word, both forms
  assert ops['exp13 lane_swar_pk int32 [bitwise]'] == ((2, 0, 0), 0, 1, 2)
  assert ops['exp13 lane_swar_pk int32'] == ((2, 0, 0), 0, 1, 2)
  assert ops['exp29 roll10_i32'] == ((10, 0, 0), 0, 10, 1)
  assert ops['exp29 roll10_packed'] == ((10, 0, 0), 0, 10, 2)
  assert ops['exp29 ew_i32'] == ((1, 1, 0), 0, 1, 1)  # a multiply-add, a min
  # exp16: ten steps of two grid-wide phases; each odd lane distance
  # (1, 3) a byte permute
  assert ops['exp16 wide'] == ((10, 0, 0), 2, 10, 1)
  assert ops['exp16 swar [bitwise]'] == ((12, 0, 0), 2, 10, 2)
  assert ops['exp16 swar'] == ((12, 0, 0), 2, 10, 2)
  assert ops['exp12 24-operand shifted add-chain'][0] == (0, 23, 0)
  assert ops['exp12 pltpu.roll axis=0 wide 2-D'][0] == (0, 0, 0)
  assert ops['exp2 fma float32 (512, 2048)'][0] == (0, 0, 2)
  assert ops['exp2 add int32 (512, 2048)'][0] == (0, 1, 0)
  assert ops['exp29 pack_roundtrip'][0] == (0, 1, 0)  # a packed add
  assert ops['exp2 lane_roll_add float32 (128, 32, 128)'] == (
      (0, 0, 1), 0, 1, 1)
  assert sum(b.barriers for b in narrow.BODIES.values()) == 6
  # every form of one function: one count
  for bitwise in narrow.BODIES.values():
    if bitwise.case.endswith('[bitwise]'):
      assert bitwise.ops == narrow.BODIES[bitwise.name[:-10]].ops
  # bounds: a chain's operations per iteration, a one-shot body's bytes
  lanes = 132 * 1.98e9
  bound, unit = narrow.bound_ms('exp16 wide', 132, 1.98e9)
  assert unit == 'operations'
  assert bound == pytest.approx(10 * 512 * 2048 / (64 * lanes) * 1e3)
  bound, unit = narrow.bound_ms('exp12 native i16 min', 132, 1.98e9)
  assert unit == 'bytes'
  assert bound == pytest.approx(3 * 256 * 512 * 2 / 3.35e12 * 1e3)
  assert narrow.bound_ms('exp2 fma float32 (512, 2048)', 132, 1.98e9)[0] == \
      pytest.approx(2 * 512 * 2048 / (128 * lanes) * 1e3)
  # an add may issue to either integer pipe; a min only to the ALU
  assert narrow.bound_ms('exp2 add int32 (512, 2048)', 132, 1.98e9)[0] == \
      pytest.approx(512 * 2048 / (128 * lanes) * 1e3)
  assert narrow.bound_ms('exp29 ew_i32', 132, 1.98e9)[0] == \
      pytest.approx(256 * 1024 / (64 * lanes) * 1e3)
  # the same kernel, the same function, one bound
  assert narrow.bound_ms('exp13 lane_nmin int32', 132, 1.98e9) == \
      narrow.bound_ms('exp13 lane_min int32', 132, 1.98e9)


def test_fold_bytes_count_the_cells_its_taps_read():
  cells = {name: narrow.cells_read(name) for name in narrow.BODIES}
  assert cells['exp13 i16 19-tap lane where-min fold'] == 256 * 530
  assert cells['exp13 i16 19-tap sublane where-min fold'] == 274 * 512
  assert cells['exp13 i16 lane-shifted slice add (off 3)'] == 256 * 515
  assert cells['exp12 24-operand shifted add-chain'] == 256 * 535
  assert cells['exp12 pltpu.roll axis=0 wide 2-D'] == 256 * 2048
  assert cells['exp12 native i16 min'] == 2 * 256 * 512
  bound, unit = narrow.bound_ms('exp13 i16 19-tap lane where-min fold', 132,
                                1.98e9)
  assert unit == 'bytes'
  assert bound == pytest.approx((256 * 530 + 256 * 512) * 2 / 3.35e12 * 1e3)


def test_library_calls_compute_the_bodies_functions():
  """A body's library call, where it has one, equals its plain version
  (a chain's: one iteration); mask-min is a min, and one iteration of
  exp2's add chains is torch.add(v, v)."""
  assert narrow.BODIES['exp13 i16 mask-min b+((a-b)&-(a<b))'].library is \
      torch.minimum
  for name, body in narrow.BODIES.items():
    if body.library is None:
      continue
    xs = narrow.body_inputs(body, 'cpu')
    got = body.library(*xs)
    assert torch.equal(got.to(body.dtype), body.plain(*xs)), name
  assert {name for name, b in narrow.BODIES.items()
          if b.chain and b.library is not None} == {
              'exp2 add int32 (512, 2048)', 'exp2 add int16 (512, 2048)'}


def test_a_body_over_its_bound_fails():
  assert narrow.within_bound(1.0, 1.0)
  assert narrow.within_bound(1.05, 1.0)
  assert not narrow.within_bound(1.06, 1.0)


def test_register_chains_check_their_main_loop():
  body = narrow.BODIES['exp2 add int32 (512, 2048)']
  iters = narrow.check_iters(body, 32)
  assert iters == probes.CHECK_ITERS + (narrow.EW_UNROLL + 5, 32)
  assert narrow.check_iters(narrow.BODIES['exp16 wide'], 64) == \
      probes.CHECK_ITERS + (64,)
  assert narrow.check_iters(narrow.BODIES['exp12 native i16 min']) == (1,)
  # the source's main loop runs EW_UNROLL iterations a trip
  text = (pathlib.Path(narrow.__file__).parents[1] / 'csrc' /
          narrow.SOURCE).read_text()
  assert 'constexpr int kUnroll = %d;' % narrow.EW_UNROLL in text


@pytest.mark.parametrize('name', sorted(narrow.EXP24_SHIFT))
def test_exp24_shift_chains_as_strips(name):
  """exp24's shift chains as the strip kernel runs them: the same
  function as the chain probe's plain version at CHECK_ITERS, the same
  grid barriers an iteration."""
  strip = narrow.EXP24_SHIFT[name]
  chain = probes.CHAIN_BODIES[name]
  assert strip.barriers == chain.barriers
  x = probes.chain_input(torch.int32, 'cpu')
  for n in probes.CHECK_ITERS:
    assert torch.equal(strip.plain(x, n=n),
                       probes.chain_probe_plain(x, chain, n)), n


def test_main_loop_reads_the_largest_backward_branch():
  text = '''
        Function : _ZN12_GLOBAL__N_12ewINS_8Double32EEEvPKNT_1TEPS2_ixi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R2, R2, R3 ;
        /*0020*/                   IADD3 R2, R2, R2, R3 ;
        /*0030*/                   IADD3 R4, P0, R4, 0x10, RZ ;
        /*0040*/              @P0 BRA 0x10 ;
        /*0050*/                   IADD3 R2, R2, R2, R3 ;
        /*0060*/              @P1 BRA 0x50 ;
        /*0070*/                   BRA 0x70 ;
        /*0080*/                   EXIT ;
'''
  listing, = narrow.parse_listing(text).values()
  assert [op for _, op, _ in narrow.main_loop(listing)] == [
      'IADD3', 'IADD3', 'IADD3', 'BRA']
  assert narrow.parse_sass(text)[
      '_ZN12_GLOBAL__N_12ewINS_8Double32EEEvPKNT_1TEPS2_ixi']['BRA'] == 3


def test_every_body_counted():
  assert len(narrow.BODIES) == 12 + 11 + 8 + 3 + 17 + 5 + 3 + 8
  assert {b.line for b in narrow.BODIES.values()} == {
      57, 195, 72, 76, 126, 50, 76, 87, 148, 68, 147, 161, 174}
  assert probes.SOURCES[-1] == narrow.SOURCE


def test_parse_sass_counts_base_opcodes():
  text = '''
        Function : _ZN12_GLOBAL__N_16binaryINS_6I16MinEEEvPKNT_1TES5_PS3_i
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   IMNMX R5, R2, R5, PT ;
        /*0020*/              @!P0 IMNMX.U32 R5, R2, R5, PT ;
        /*0030*/                   VIMNMX.S16x2 R3, R3, R4, PT ;
        /*0040*/                   EXIT ;
        Function : other
        /*0000*/                   PRMT R2, R2, 0x5432, R3 ;
'''
  got = narrow.parse_sass(text)
  entry = '_ZN12_GLOBAL__N_16binaryINS_6I16MinEEEvPKNT_1TES5_PS3_i'
  assert got[entry] == {'LDC': 1, 'IMNMX': 2, 'VIMNMX.S16x2': 1, 'EXIT': 1}
  assert got['other'] == {'PRMT': 1}
  assert all(m in entry for m in narrow._mangled_op('binary', 'I16Min'))


def test_narrow_probe_rejects_what_the_kernel_does_not_take():
  body = narrow.BODIES['exp12 native i16 min']
  a, b = narrow.body_inputs(body, 'cpu')
  with pytest.raises(utils.InputError, match='unknown narrow body'):
    narrow.narrow_probe('exp12 native i8 min', a, b)
  with pytest.raises(utils.InputError, match='2 inputs'):
    narrow.narrow_probe(body, a)
  with pytest.raises(utils.InputError, match='int16'):
    narrow.narrow_probe(body, a.int(), b.int())
  with pytest.raises(utils.InputError, match='n >= 1'):
    narrow.narrow_probe(body, a, b, n=2)
  with pytest.raises(utils.InputError, match='cpu or cuda'):
    narrow.narrow_probe(body, a.to('meta'), b.to('meta'))
  x, = narrow.body_inputs('exp29 roll10_i32', 'cpu')
  with pytest.raises(utils.InputError, match='n >= 1'):
    narrow.narrow_probe('exp29 roll10_i32', x, n=0)
  with pytest.raises(utils.InputError, match='contiguous'):
    narrow.narrow_probe('exp29 roll10_i32', x.t())


# -- the entry points --------------------------------------------------------

@pytest.mark.parametrize('module, args, lines', [
    (exp13_narrow_i16, [], 23), (exp13_narrow_i16, ['legal'], 12),
    (exp29_pack_i16, [], 8), (exp16_swar_erosion, [], 4),
    (exp12_mosaic_reprobe, [], 17), (exp12_mosaic_reprobe, ['swar'], 6),
    (exp2_diag, [], 13), (exp1_value_mode, [], 9)])
def test_entry_points_on_the_cpu(module, args, lines, capsys):
  assert module.main(['--device', 'cpu'] + args) == 0
  out = capsys.readouterr().out.splitlines()
  assert len(out) == lines, out
  assert all('OK' in line or '==' in line or '(exact)' in line
             for line in out), out


def test_entry_points_need_the_card_by_default(capsys):
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  for module in (exp13_narrow_i16, exp29_pack_i16, exp16_swar_erosion,
                 exp12_mosaic_reprobe, exp2_diag, exp1_value_mode):
    assert module.main([]) == 1
    assert 'no CUDA device' in capsys.readouterr().err
  with pytest.raises(SystemExit):
    exp12_mosaic_reprobe.main(['--device', 'cpu', 'mosaic'])
