"""exp32's copy-shift probe: its plain versions against the JAX script.

``soda_tpu_torch/experiments/copyshift.py`` ports the Pallas probes of
experiments/exp32_dma_shift.py. Its kernel runs only on the card
(tests/test_torch_gpu.py; a g++ emulation of its text in
tests/test_torch_copy_emulation.py); here the plain versions, which the
card's kernel is held to, are held to the script, loaded by path: each
case of its ``main()`` and ``check()`` runs through the script's own
builders in interpret mode (``make_*_chain(..., True)``) at 1, 2 and 3
iterations on the script's input, and must equal the port's plain
version bit for bit, stale tail included (and the script's NumPy
oracles). Then the bounds, the SASS readers on a listing, the wrapper's
refusals and the entry point on the CPU.
"""

import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.experiments import copyshift, exp32_dma_shift, narrow

REPO = pathlib.Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def script():
  spec = importlib.util.spec_from_file_location(
      'jax_exp32_dma_shift', REPO / 'experiments' / 'exp32_dma_shift.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  module.log = lambda *a: None
  return module


def _jax_kernel(script, case, n):
  """The script's interpret-mode kernel of ``case`` at ``n`` iterations,
  built as its main() or check() builds it."""
  if case.kind == 'store':
    return script.make_store_chain(len(case.dists), n, True)
  if case.kind == 'rotate':
    return script.make_rot_chain(case.dists, case.axis, n, True)
  if case.kind == 'copy':
    return script.make_dma_chain(case.dists, case.axis, n, True)
  if case.kind == 'overlap':
    return script.make_overlap_chain(case.dists[0], n, True)
  return script.make_fan_chain(case.dists, n, True)


def test_constants_and_cases_are_the_scripts(script):
  assert copyshift.SHAPE == script.SHAPE
  assert copyshift.SUB_DISTS == script.SUB_DISTS
  assert copyshift.LANE_DISTS == script.LANE_DISTS
  assert copyshift.copy_len(script.SHAPE, 0) == script.ROWS_CP == 240
  assert copyshift.copy_len(script.SHAPE, 1) == script.COLS_CP == 896
  # main()'s tags in order (exp32_dma_shift.py:316-329)
  assert [c.name for c in copyshift.MAIN_CASES] == (
      ['store5', 'rot5_sub_d3', 'rot5_lane_d8'] +
      ['dma5_sub_d%d' % d for d in script.SUB_DISTS] +
      ['dma5_lane_d%d' % d for d in script.LANE_DISTS] +
      ['dmaover5_d3', 'dmafan4_sub'])
  assert [c.steps for c in copyshift.MAIN_CASES] == [5] * 10 + [4]
  assert len(copyshift.CHECK_CASES) == 8
  assert {c.line for c in copyshift.CASES.values()} == {81, 153, 226}


def test_inputs_are_the_scripts():
  x0 = np.random.RandomState(0).randint(-30000, 30000, (256, 1024), np.int32)
  x7 = np.random.RandomState(7).randint(-30000, 30000, (256, 1024)).astype(
      np.int32)
  assert np.array_equal(copyshift.copy_input(0, 'cpu').numpy(), x0)
  assert np.array_equal(copyshift.copy_input(7, 'cpu').numpy(), x7)


@pytest.mark.parametrize('n', [1, 2, 3])
@pytest.mark.parametrize('name', [c.name for c in copyshift.MAIN_CASES])
def test_main_case_plain_equals_the_jax_kernel(script, name, n):
  case = copyshift.CASES[name]
  x = copyshift.copy_input(0, 'cpu')
  want = np.asarray(_jax_kernel(script, case, n)(jnp.asarray(x.numpy())))
  got = copyshift.copy_probe(case, x, n)
  assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), (
      name, n)


@pytest.mark.parametrize('n', [1, 2, 3])
@pytest.mark.parametrize('name', [c.name for c in copyshift.CHECK_CASES])
def test_check_case_plain_equals_the_jax_kernel_and_oracle(script, name, n):
  case = copyshift.CASES[name]
  x = copyshift.copy_input(7, 'cpu')
  want = np.asarray(_jax_kernel(script, case, n)(jnp.asarray(x.numpy())))
  got = copyshift.copy_plain(case, x, n).numpy()
  assert np.array_equal(got, want), (name, n)
  xn = x.numpy()
  oracle = (script.np_dma_chain(xn, case.dists, case.axis, n)
            if case.kind == 'copy' else
            script.np_fan_chain(xn, case.dists, n) if case.kind == 'fan' else
            script.np_overlap_chain(xn, case.dists[0], n))
  assert np.array_equal(got, oracle), (name, n)


def test_stale_tail_is_kept():
  """A copy overwrites only b's start: rows past ROWS_CP keep x's values
  (and then their mins), so the last rows differ from a full roll."""
  case = copyshift.CASES['dma5_sub_d8']
  x = copyshift.copy_input(0, 'cpu')
  got = copyshift.copy_plain(case, x, 1)
  # (b's tail held x's rows, each row's min with itself)
  assert torch.equal(got[240:], x[240:])
  rot = copyshift.ROTATE['rot5_sub_d3'].plain(x, n=1)
  assert not torch.equal(copyshift.copy_plain('dma5_sub_d3', x, 1), rot)


def test_counts_and_bounds():
  sms, clock = 132, 1.98e9
  cells = 256 * 1024
  # a copy moves 240 of 256 rows or 896 of 1024 lanes: 8 B a copied cell
  assert copyshift.counts('dma5_sub_d1') == ((5.0, 0.0, 0.0), 37.5)
  assert copyshift.counts('dma5_lane_d128') == ((5.0, 0.0, 0.0), 35.0)
  # a rotate wraps: every cell is stored and read
  assert copyshift.counts('rot5_lane_d8') == ((5.0, 0.0, 0.0), 40.0)
  # one store of rows 1..248, four reads of 240 rows
  assert copyshift.counts('dmafan4_sub') == (
      (4.0, 0.0, 0.0), (4 * 4 * 240 + 4 * 248) / 256)
  assert copyshift.counts('dmaover5_d3') == ((15.0, 5.0, 0.0), 37.5)
  # key 0's step is the identity: four keys' xor and min
  assert copyshift.counts('store5') == ((8.0, 0.0, 0.0), 0.0)
  assert copyshift.counts('check sub d=3') == ((1.0, 0.0, 0.0), 7.5)
  assert copyshift.counts('check lane d=1', (16, 256)) == (
      (1.0, 0.0, 0.0), 4.0)
  bound, by = copyshift.bound_ms('dma5_sub_d3', sms, clock)
  assert by == 'bytes'
  assert bound == pytest.approx(37.5 * cells / (128 * sms * clock) * 1e3)
  assert copyshift.bound_ms('rot5_sub_d3', sms, clock)[0] == pytest.approx(
      bound * 40 / 37.5)
  small = copyshift.bound_ms('dma5_sub_d3', sms, clock, (64, 256))[0]
  assert small == pytest.approx(8 * 5 * 48 * 256 / (128 * sms * clock) * 1e3)
  # the overlap's chain B fits under chain A's shared-memory bytes
  assert copyshift.bound_ms('dmaover5_d3', sms, clock) == (bound, 'bytes')
  store, by = copyshift.bound_ms('store5', sms, clock)
  assert by == 'operations' and store == pytest.approx(
      narrow.ops_ms((8, 0, 0), cells, sms, clock))


def _listing(ops):
  return [(16 * i, op, '') for i, op in enumerate(ops)]


def test_overlap_order_reads_chain_b_between_issue_and_wait():
  loop = _listing(['STS', 'BAR.SYNC.DEFER_BLOCKING', 'SYNCS.ARRIVE.TRANS64',
                   'UBLKCP.S.S', 'LOP3.LUT', 'VIMNMX', 'LEA.HI.SX32',
                   'SYNCS.PHASECHK.TRANS64.TRYWAIT', 'BRA', 'LDS', 'VIMNMX',
                   'BRA'])
  assert copyshift.overlap_order(loop) == {'between': 3, 'after': 1,
                                           'issue': 3, 'wait': 7}
  moved = _listing(['UBLKCP.S.S', 'SYNCS.PHASECHK.TRANS64.TRYWAIT', 'LOP3',
                    'VIMNMX'])
  assert copyshift.overlap_order(moved)['between'] == 0
  assert copyshift.store_loop_counts(_listing(
      ['STS', 'STS.128', 'LDS', 'IMNMX', 'LDS', 'VIMNMX', 'BRA'])) == {
          'STS': 2, 'LDS': 2, 'min': 2}


def test_overlap_order_reads_the_parsed_listing():
  """The kernel's own layout: a lane copy path (an arrive, a copy a row)
  and a row copy path (another arrive, one copy) before the try-wait;
  the wait is the SYNCS with TRYWAIT, not the arrive after the first
  copy."""
  text = '''
        Function : _ZN12_GLOBAL__N_110copy_chainILi2EEEvPKiPiNS_4PlanEx
        /*0000*/                   SYNCS.ARRIVE.TRANS64 RZ, [UR11], R14 ;
        /*0010*/                   UBLKCP.S.S [UR10], [UR27], UR13 ;
        /*0020*/                   UBLKCP.S.S [UR28], [UR23], UR13 ;
        /*0030*/                   SYNCS.ARRIVE.TRANS64 RZ, [UR11], R14 ;
        /*0040*/                   UBLKCP.S.S [UR12], [UR8], UR10 ;
        /*0050*/                   LOP3.LUT R3, R2, 0x5a5a, RZ, 0x3c, !PT ;
        /*0060*/                   VIMNMX R2, R2, R3, PT ;
        /*0070*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR11], R14 ;
        /*0080*/              @!P0 BRA 0x70 ;
        /*0090*/                   LDS R4, [R5] ;
        /*00a0*/                   BRA.U.ANY 0x0 ;
  '''
  listing, = narrow.parse_listing(text).values()
  assert [op for _, op, _ in listing][3:8] == [
      'SYNCS.ARRIVE.TRANS64', 'UBLKCP.S.S', 'LOP3.LUT', 'VIMNMX',
      'SYNCS.PHASECHK.TRANS64.TRYWAIT']
  assert listing[7][2] == 'P0, [UR11], R14'
  assert len(narrow.main_loop(listing)) == 11
  assert copyshift.overlap_order(narrow.main_loop(listing)) == {
      'between': 2, 'after': 0, 'issue': 4, 'wait': 7}
  assert narrow.base_opcode('SYNCS.PHASECHK.TRANS64.TRYWAIT') == 'SYNCS'
  assert narrow.base_opcode('VIMNMX.S16x2.RELU') == 'VIMNMX.S16x2'


def test_cell_slots_are_the_sources():
  text = (REPO / 'soda_tpu_torch' / 'csrc' / copyshift.SOURCE).read_text()
  assert re.search(r'constexpr int kMaxPer = (\d+);', text).group(1) == str(
      copyshift.CELL_SLOTS)


def test_copy_probe_rejects_what_the_kernel_does_not_take():
  x = copyshift.copy_input(0, 'cpu')
  with pytest.raises(utils.InputError, match='unknown exp32 case'):
    copyshift.copy_probe('dma5_sub_d2', x, 1)
  with pytest.raises(utils.InputError, match='int32'):
    copyshift.copy_probe('dma5_sub_d3', x.float(), 1)
  with pytest.raises(utils.InputError, match='n >= 1'):
    copyshift.copy_probe('dma5_sub_d3', x, 0)
  with pytest.raises(utils.InputError, match='strip kernel'):
    copyshift.copy_probe('rot5_sub_d3', x[:128].contiguous(), 1)
  with pytest.raises(utils.InputError, match='leave a block'):
    copyshift.copy_probe('dma5_sub_d3', x[:16].contiguous(), 1)
  with pytest.raises(utils.InputError, match='cpu or cuda'):
    copyshift.copy_probe('dma5_sub_d3', x.to('meta'), 1)


def test_entry_point_on_the_cpu(capsys):
  assert exp32_dma_shift.main(['--device', 'cpu']) == 0
  out = capsys.readouterr().out.splitlines()
  assert len(out) == 11 and all('plain OK' in line for line in out), out
  assert exp32_dma_shift.main(['--device', 'cpu', '--check']) == 0
  out = capsys.readouterr().out.splitlines()
  assert len(out) == 8 and all('plain OK (n=3)' in line for line in out), out


def test_entry_points_need_the_card_by_default():
  """Both new entry points exit 1 without a card (no fallback to the
  plain versions) and 0 under --device cpu, and load neither jax nor the
  JAX package."""
  code = '\n'.join([
      'import contextlib, io, json, sys',
      'sys.path.insert(0, %r)' % str(REPO),
      'import torch',
      'from soda_tpu_torch.experiments import exp32_dma_shift, '
      'exp9_layout25d',
      'with contextlib.redirect_stdout(io.StringIO()), '
      'contextlib.redirect_stderr(io.StringIO()):',
      '  rcs = [m.main(a) for m in (exp32_dma_shift, exp9_layout25d)',
      "         for a in ([], ['--device', 'cpu'])]",
      "print(json.dumps({'rcs': rcs, 'card': torch.cuda.is_available(),",
      "                  'loaded': sorted(m for m in sys.modules if",
      "                                   m.split('.')[0] in ('jax', 'jaxlib',",
      "                                                       'soda_tpu'))}))",
  ])
  env = {k: v for k, v in os.environ.items() if not k.startswith('JAX')}
  proc = subprocess.run([sys.executable, '-c', code], env=env,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr[-4000:]
  got = json.loads(proc.stdout.strip().splitlines()[-1])
  assert got['loaded'] == []
  if not got['card']:
    assert got['rcs'] == [1, 0, 1, 0], got
