"""The narrow probe's one-shot timing module and checks, on the CPU.

``narrow_oneshot`` times the 37 one-shot bodies on the card only; here
its shapes, inputs and library calls are held to the bodies' plain
versions, it refuses to run without a card, and ``narrow.key_ops_kept``
tells a kernel whose op changed kind (its SASS faked). The kernels
themselves run under the g++ emulation
(tests/test_torch_narrow_emulation.py) and on the card (chip_smoke.py
phase 17).
"""

import collections

import pytest
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.experiments import narrow, narrow_oneshot

ONE_SHOT = narrow_oneshot.ONE_SHOT
FOLDS = [b for b in ONE_SHOT if b.form == 'fold']
WITH_LIBRARY = [b for b in ONE_SHOT if b.library is not None]


def test_one_shot_bodies_are_the_scripts_37():
  assert len(ONE_SHOT) == 37
  assert {b.form for b in ONE_SHOT} == {'binary', 'fold'}
  assert sum(b.form == 'fold' for b in ONE_SHOT) == 12
  assert not any(b.chain for b in ONE_SHOT)


@pytest.mark.parametrize('body', FOLDS, ids=[b.name for b in FOLDS])
def test_at_shape_keeps_a_folds_margin_and_taps(body):
  big = narrow_oneshot.at_shape(body, narrow_oneshot.BIG)
  assert big.shape == (8192, 2048) and big.taps == body.taps
  margin = [i - o for i, o in zip(body.input_shape, body.shape)]
  assert [i - o for i, o in zip(big.input_shape, big.shape)] == margin
  assert big.name.endswith('at 8192x2048')
  assert narrow_oneshot.at_shape(body, body.shape) is body


@pytest.mark.parametrize('body', WITH_LIBRARY,
                         ids=[b.name for b in WITH_LIBRARY])
def test_library_call_computes_the_body_at_another_shape(body):
  """Each library call is the body's function at any shape with its
  margin (here 40 x 64, seeded random blocks over the type's range)."""
  small = narrow_oneshot.at_shape(body, (40, 64))
  xs = narrow_oneshot.random_inputs(small, 'cpu', seed=3)
  want = small.plain(*xs)
  got = small.library(*xs)
  if body.op in ('I16Add', 'I16Mul', 'I16Sub', 'I16SynthSub'):
    got = got.to(want.dtype)  # torch's int16 arithmetic wraps as C's
  assert got.shape == want.shape and torch.equal(got, want), body.name


def test_random_inputs_are_seeded_and_span_the_type():
  body = narrow_oneshot.at_shape(narrow.BODIES['exp12 native i16 min'],
                                 (64, 64))
  a = narrow_oneshot.random_inputs(body, 'cpu', seed=5)
  b = narrow_oneshot.random_inputs(body, 'cpu', seed=5)
  assert len(a) == 2 and all(torch.equal(x, y) for x, y in zip(a, b))
  assert a[0].dtype == torch.int16 and a[0].min() < -30000
  assert a[0].max() > 30000 and not torch.equal(a[0], a[1])
  roll = narrow_oneshot.at_shape(narrow.BODIES['exp1 roll axis=0'], (8, 16))
  x, = narrow_oneshot.random_inputs(roll, 'cpu')
  assert x.dtype == torch.float32 and x.abs().max() <= 1


def test_script_bodies_keep_their_own_inputs():
  body = narrow.BODIES['exp13 i16 19-tap lane add fold']
  got = narrow_oneshot.inputs(body, 'cpu')
  want = narrow.body_inputs(body, 'cpu')
  assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_timing_needs_the_card(capsys):
  if torch.cuda.is_available():
    pytest.skip('a card is present')
  with pytest.raises(utils.InputError):
    narrow_oneshot.run(ONE_SHOT[:1], shapes=('script',))
  assert narrow_oneshot.main(['exp12 native i16 min']) == 1
  assert 'error' in capsys.readouterr().err


def test_unknown_kinds_shapes_and_chains_are_refused():
  body = ONE_SHOT[0]
  with pytest.raises(utils.InputError):
    narrow_oneshot.call(body, (), 'newer')
  assert narrow_oneshot.main(['--shapes', 'huge']) == 1
  assert narrow_oneshot.main(['exp29 ew_i32']) == 1
  with pytest.raises(utils.InputError):
    narrow.geometry(narrow.BODIES['exp29 ew_i32'])
  with pytest.raises(utils.InputError):
    narrow.launch(narrow.BODIES['exp29 ew_i32'], [torch.zeros(1)], 1,
                  _old=True)


def _fake_report(monkeypatch, new, old):
  """narrow.sass_report with the given key-op counts for every one-shot
  kernel (new: the default forms, old: the old forms)."""
  def report(old_forms=False):
    counts = collections.Counter(old if old_forms else new)
    return {(b.form, b.op): {'opcodes': counts} for b in ONE_SHOT}
  monkeypatch.setattr(narrow, 'sass_report', report)


@pytest.mark.parametrize('new,old,kept', [
    ({'VIMNMX': 9}, {'VIMNMX': 1}, True),
    ({'VIMNMX.S16x2': 712}, {'VIMNMX.S16x2': 23}, True),
    ({'VIMNMX': 1}, {}, True),  # index arithmetic's own min
    ({'VIMNMX.S16x2': 4}, {'VIMNMX': 1}, False),  # a scalar min packed
    ({'VIMNMX': 8}, {'VIMNMX.S16x2': 1}, False),  # a packed op lost
    ({}, {'VIMNMX': 1}, False),  # the min lost
    ({'VIADD.16x2': 4}, {}, False),  # an add packed
])
def test_key_ops_kept_tells_a_changed_kind(monkeypatch, new, old, kept):
  _fake_report(monkeypatch, new, old)
  body = narrow.BODIES['exp12 native i16 min']
  assert narrow.key_ops(body) == {k: v for k, v in new.items() if v}
  assert narrow.key_ops_kept(body) == kept
