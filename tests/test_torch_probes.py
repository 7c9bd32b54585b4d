"""The experiment probes' plain versions against the JAX scripts' probes.

``soda_tpu_torch/experiments/probes.py`` ports four Pallas probes of
``experiments/``. Their kernels run only on the card
(tests/test_torch_gpu.py); here their plain versions, which the card's
kernels are held to, are held to the JAX scripts on the CPU:

- exp27 and exp30: the scripts' kernels are closures inside ``main()``,
  so each script runs in interpret mode in a subprocess and must print
  OK for every case; then ``stream_probe_plain`` walks every case's
  schedule on the same seed-0 input, and on ragged runs, and must give
  x + 1 bit for bit.
- exp24 and exp45: each script is loaded by path (its top level imports
  only numpy); ``pallas_loop(body, n)`` runs in interpret mode for n in
  {1, 3} on every body of ``main()`` (all flags) and is compared with
  ``chain_probe_plain``: int32 bodies bit for bit, float32 bodies within
  a largest relative error of 1e-5 (XLA on the CPU fuses multiply-adds
  and rounds rsqrt 2 ulp from torch; the largest measured in a CPU run
  was 5.5e-7, full2d_noroll at n = 1; div10, recip10, sqrt10 and full3d
  were exact; see the test for the bodies that overflow).
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.experiments import (exp24_stage_tax, exp27_gridloop,
                                        exp30_dma_granularity,
                                        exp45_transcendental_tax, probes)

REPO = pathlib.Path(__file__).resolve().parent.parent
STREAM_CASES = probes.EXP27_CASES + probes.EXP30_CASES

torch.set_num_threads(1)


def _script(name):
  spec = importlib.util.spec_from_file_location(
      'jax_' + name, REPO / 'experiments' / (name + '.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


@pytest.mark.parametrize('script, cases', [
    ('exp27_gridloop', probes.EXP27_CASES),
    ('exp30_dma_granularity', probes.EXP30_CASES)])
def test_jax_stream_script_passes_every_case(script, cases):
  """The JAX script's own interpret run: every case prints OK, under
  the names the port's cases carry."""
  env = dict(os.environ, JAX_PLATFORMS='cpu')
  proc = subprocess.run(
      [sys.executable, str(REPO / 'experiments' / (script + '.py')),
       'interpret'], env=env, capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stderr[-2000:]
  for case in cases:
    assert any(line.startswith(case.name) and line.split()[-1] == 'OK'
               for line in proc.stderr.splitlines()), (case.name,
                                                       proc.stderr[-2000:])


@pytest.mark.parametrize('case', STREAM_CASES, ids=[c.name for c in
                                                    STREAM_CASES])
def test_stream_plain_is_x_plus_one(case):
  x = probes.stream_input(64, 'cpu')
  got = probes.stream_probe_plain(x, case.kind, case.blk, case.split,
                                  case.depth)
  assert torch.equal(got, x + 1)
  assert torch.equal(probes.stream_probe(x, case.kind, case.blk, case.split,
                                         case.depth), got)


@pytest.mark.parametrize('ctas', [1, 3, 5])
@pytest.mark.parametrize('case', STREAM_CASES, ids=[c.name for c in
                                                    STREAM_CASES])
def test_stream_plain_ragged_runs(case, ctas):
  """13 tiles: the grid form's last run is short (13 = 8 + 5), the loop
  form's CTAs walk 13, 5/4/4 or 3/3/3/2/2 tiles, fewer than a 4-deep
  ring's prologue in the last case."""
  tile = probes._tile_floats(case.blk)
  rng = np.random.default_rng(1)
  x = torch.from_numpy(rng.standard_normal(13 * tile, dtype=np.float32))
  if case.kind == 'grid':
    ctas = probes.stream_ctas(case.kind, case.blk, case.split, case.depth,
                              13, 'cpu')
  got = probes.stream_probe_plain(x, case.kind, case.blk, case.split,
                                  case.depth, ctas=ctas)
  assert torch.equal(got, x + 1)


def test_stream_schedule_covers_every_tile_once():
  for kind, depth in (('grid', 1), ('grid', 2), ('loop', 2)):
    for tiles, ctas in ((13, 5), (256, 792), (4096, 7)):
      if kind == 'grid':
        ctas = probes.stream_ctas(kind, 4, 1, depth, tiles, 'cpu')
      walks = list(probes.stream_schedule(kind, depth, tiles, ctas))
      assert len(walks) == ctas
      assert sorted(t for w in walks for t in w) == list(range(tiles))


def test_stream_probe_rejects_what_the_kernel_does_not_take():
  x = probes.stream_input(64, 'cpu')
  with pytest.raises(utils.InputError, match='split'):
    probes.stream_probe(x, 'loop', 4, split=3)
  with pytest.raises(utils.InputError, match='multiple'):
    probes.stream_probe(x, 'loop', 2, split=4)
  with pytest.raises(utils.InputError, match='shared memory'):
    probes.stream_probe(x, 'loop', 16, depth=4)
  with pytest.raises(utils.InputError, match='float32'):
    probes.stream_probe(x.double(), 'loop', 4)
  with pytest.raises(utils.InputError, match='cpu or cuda'):
    probes.stream_probe(x.to('meta'), 'loop', 4)


# the JAX body of each port body, by its name in the scripts' main()
def _jax_bodies():
  e24, e45 = _script('exp24_stage_tax'), _script('exp45_transcendental_tax')
  bodies = {
      'ew10': e24.body_ew10_real, 'roll10': e24.body_roll10,
      'proll10': e24.body_proll10, 'indep10': e24.body_indep10,
      'proll5_sub': e24.body_proll5_sub, 'proll5_lane': e24.body_proll5_lane,
      'chunk32': e24.make_body_chunk(32),
      'chunk128': e24.make_body_chunk(128),
      'chunk64x512': e24.make_body_chunk(64, 512),
  }
  for d in (1, 2, 7, 8, 16, 64):
    bodies['sub_d%d' % d] = e24.make_body_dist(0, d)
  for d in (1, 2, 7, 8, 64, 128, 256, 512):
    bodies['lane_d%d' % d] = e24.make_body_dist(1, d)
  for name in ('fma10', 'muladd10', 'div10', 'recip10', 'sqrt10', 'rsqrt10',
               'recipsqrt10', 'gstage', 'g_noroll', 'g_norsqrt', 'full2d',
               'full2d_norsqrt', 'full2d_noroll', 'full3d'):
    bodies[name] = getattr(e45, 'body_' + name)
  return {'exp24': e24, 'exp45': e45}, bodies


_SCRIPTS, _JAX_BODIES = _jax_bodies()


def test_every_body_of_the_scripts_is_ported():
  assert sorted(_JAX_BODIES) == sorted(probes.CHAIN_BODIES)
  assert len(probes.CHAIN_BODIES) == 37
  assert probes.SHAPE == _SCRIPTS['exp24'].SHAPE == _SCRIPTS['exp45'].SHAPE
  assert probes.MARGIN0 == _SCRIPTS['exp24'].MARGIN0


def _jax_loop(name, n, x):
  body = probes.CHAIN_BODIES[name]
  return np.asarray(_SCRIPTS[body.experiment].pallas_loop(
      _JAX_BODIES[name], n)(jnp.asarray(x.numpy())))


@pytest.mark.parametrize('name', sorted(probes.CHAIN_BODIES))
def test_chain_plain_matches_the_jax_body(name):
  body = probes.CHAIN_BODIES[name]
  x = probes.chain_input(body.dtype, 'cpu')
  want = {n: _jax_loop(name, n, x) for n in (1, 3)}
  for n in (1, 3):
    got = probes.chain_probe_plain(x, body, n)
    assert got.dtype == body.dtype and tuple(got.shape) == probes.SHAPE
    if body.dtype == torch.int32:
      np.testing.assert_array_equal(got.numpy(), want[n], err_msg=name)
    elif n == 1 or np.isfinite(want[n]).all():
      _, rel = probes.max_error(got, torch.from_numpy(want[n].copy()))
      assert rel <= probes.CHAIN_RTOL, (name, n, rel)
  if body.dtype == torch.float32 and not np.isfinite(want[3]).all():
    # full2d, full2d_norsqrt, full2d_noroll: the JAX body overflows to
    # inf in two iterations and to NaN in three. XLA on the CPU fuses
    # multiply-adds and rounds rsqrt 2 ulp from torch's, and the
    # overflow amplifies that about 12x an iteration (n = 3: 2.1e-5 and
    # 2.7e-5 relative in full2d and full2d_noroll), so the third
    # iteration is held step by step: the plain body applied to the
    # JAX body's second iterate against its third, NaN and inf alike.
    step = probes.chain_probe_plain(
        torch.from_numpy(_jax_loop(name, 2, x).copy()), body, 1)
    _, rel = probes.max_error(step, torch.from_numpy(want[3].copy()))
    assert rel <= probes.CHAIN_RTOL, (name, rel)
  assert probes.max_error(probes.chain_probe(x, body, 3),
                          probes.chain_probe_plain(x, body, 3)) == (0, 0)


def test_chunked_bodies_equal_their_rolled_function():
  """chunk32 and chunk128 compute roll10's function (their margins wrap
  as the rolls do), which is why chunk128 may run roll10's barrier form
  on the card; chunk64x512 rolls inside 512-lane tiles and does not."""
  x = probes.chain_input(torch.int32, 'cpu')
  roll10 = probes.chain_probe_plain(x, 'roll10', 2)
  assert torch.equal(probes.chain_probe_plain(x, 'chunk32', 2), roll10)
  assert torch.equal(probes.chain_probe_plain(x, 'chunk128', 2), roll10)
  assert not torch.equal(probes.chain_probe_plain(x, 'chunk64x512', 2), roll10)
  assert probes.CHAIN_BODIES['chunk128'].taps == \
      probes.CHAIN_BODIES['roll10'].taps


def test_barriers_and_op_counts():
  got = {name: (b.barriers, probes.op_counts(name))
         for name, b in probes.CHAIN_BODIES.items()}
  assert got['ew10'] == (0, {'fp32': 0, 'int32': 15, 'sfu': 0})  # LEA.HI
  assert got['roll10'] == (10, {'fp32': 0, 'int32': 10, 'sfu': 0})
  assert got['indep10'] == (1, {'fp32': 0, 'int32': 10, 'sfu': 0})
  assert got['sub_d64'] == (5, {'fp32': 0, 'int32': 5, 'sfu': 0})
  # 8 chunks of 50 rows: the row steps' shrinking slices, then 32 rows
  assert got['chunk32'][0] == 1 and got['chunk32'][1]['int32'] == \
      8 * (49 + 47 + 43 + 35 + 32) * 1024 / probes.CELLS + 5
  assert got['div10'] == (0, {'fp32': 20, 'int32': 0, 'sfu': 10})
  assert got['gstage'] == (1, {'fp32': 12, 'int32': 0, 'sfu': 1})
  assert got['full2d'] == (2, {'fp32': 45, 'int32': 0, 'sfu': 1})
  assert got['full3d'] == (2, {'fp32': 57, 'int32': 0, 'sfu': 3})
  assert {name: tuple(c.values()) for name, (_, c) in got.items()
          if name.startswith(('sub_', 'lane_', 'proll5'))} == {
              name: (5, 0, 0) for name in got
              if name.startswith(('sub_', 'lane_', 'proll5'))}
  # (int32, fp32, sfu) of the other exp45 bodies, counted by hand
  for name, ops in (('fma10', (0, 20, 0)), ('muladd10', (0, 20, 0)),
                    ('recip10', (0, 20, 10)), ('sqrt10', (0, 10, 10)),
                    ('rsqrt10', (0, 10, 10)), ('recipsqrt10', (0, 20, 20)),
                    ('g_noroll', (0, 16, 1)), ('g_norsqrt', (0, 14, 0)),
                    ('full2d_norsqrt', (0, 47, 0)),
                    ('full2d_noroll', (0, 53, 1))):
    assert probes.CHAIN_BODIES[name].ops == ops, name
  # 2 chunks of 146 rows and 4 of 82: the same count as chunk32's
  assert got['chunk128'][1]['int32'] == 2 * (145 + 143 + 139 + 131 + 128) \
      * 1024 / probes.CELLS + 5
  assert got['chunk64x512'][1]['int32'] == 4 * (81 + 79 + 75 + 67 + 64) \
      * 1024 / probes.CELLS + 5
  bound, unit = probes.chain_bound_ms('roll10', 132, 1.98e9)
  assert unit == 'int32'
  assert bound == pytest.approx(10 * probes.CELLS / (64 * 132 * 1.98e9) * 1e3)


def _differs(a, b):
  return probes.max_error(a, b) != (0, 0)


@pytest.mark.parametrize('name', sorted(probes.CHAIN_BODIES))
def test_check_iterations_tell_a_wrong_kernel(name):
  """At CHECK_ITERS (where the card's kernels are held to their plain
  versions) a body's result differs from its input and depends on it,
  and a shifted body's on each tap's distance and axis: a kernel that
  returns or ignores x, or shifts wrongly, fails the check there (at 64
  iterations most chains have settled on a fixed point or a global
  minimum whatever they were given)."""
  body = probes.CHAIN_BODIES[name]
  x = probes.chain_input(body.dtype, 'cpu')
  other = x.flip(0, 1).contiguous()
  ns = probes.CHECK_ITERS
  assert any(_differs(probes.chain_probe_plain(x, body, n),
                      probes.chain_probe_plain(other, body, n)) for n in ns)
  got = [probes.chain_probe_plain(x, body, n) for n in ns]
  assert _differs(got[0], x)
  for k, (axis, d, last) in enumerate(body.taps):
    # (the other axis unless d spans it: a roll by a whole axis is none)
    for tap in ((axis, d + 1, last), (1 - axis, d, last))[
        :1 + (d % probes.SHAPE[1 - axis] != 0)]:
      taps = body.taps[:k] + (tap,) + body.taps[k + 1:]
      step = probes._shift_step(taps)
      assert any(_differs(probes._times(n, step)(x), want)
                 for n, want in zip(ns, got)), (name, k, tap)


def test_chain_probe_rejects_what_the_kernel_does_not_take():
  x = probes.chain_input(torch.int32, 'cpu')
  with pytest.raises(utils.InputError, match='unknown chain body'):
    probes.chain_probe(x, 'roll11', 1)
  with pytest.raises(utils.InputError, match='float32'):
    probes.chain_probe(x, 'fma10', 1)
  with pytest.raises(utils.InputError, match='n >= 1'):
    probes.chain_probe(x, 'roll10', 0)
  with pytest.raises(utils.InputError, match='cpu or cuda'):
    probes.chain_probe(x.to('meta'), 'roll10', 1)


@pytest.mark.parametrize('module, flags, lines', [
    (exp27_gridloop, [], 4), (exp30_dma_granularity, [], 9),
    (exp24_stage_tax, [], 9), (exp24_stage_tax, ['--dists'], 14),
    (exp45_transcendental_tax, [], 8),
    (exp45_transcendental_tax, ['--decompose'], 7)])
def test_entry_points_on_the_cpu(module, flags, lines, capsys):
  assert module.main(['--device', 'cpu'] + flags) == 0
  out = capsys.readouterr().out.splitlines()
  assert len(out) == lines and all('OK' in line for line in out), out


def test_entry_points_need_the_card_by_default(capsys):
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  for module in (exp27_gridloop, exp24_stage_tax):
    assert module.main([]) == 1
    assert 'no CUDA device' in capsys.readouterr().err
