"""The H100 cost model (soda_tpu_torch/model/estimate.py) and its fit.

On the CPU, with no card: the estimate's plan fields are the executor's
plan (``tile_plan.kernel_plan``) for the 12 benchmark cells and the
kernel modes; its IR counts equal the JAX package's estimate for the
same DSL text and shape; its operation classes sum to the bound's count
and its ideal time is the bound; the ceiling is at most 1, prices float
multiply-add pairs twice and integer ones once, and lies above every
share in the committed record (soda_tpu_torch/model/h100_record.json,
the counterpart of tests/test_model_honesty.py); the constants are what
``fit --fit`` prints for that record, and they put each default cell's
estimate within 0.67-1.5x of its recorded time. ``profiling``'s
``Throughput`` prints the JAX package's lines, ``measure`` times a CPU
executor, and the device table never initialises CUDA for the CPU.
Stencils with computation reuse are built under a stepped clock
(``testing.build_cell_stepped``), as on every machine alike.
"""

import io
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import soda_tpu
from soda_tpu import profiling as jax_profiling
from soda_tpu.model import estimate as jax_est
from soda_tpu.optimization import cr_schedules as jax_cr
import soda_tpu_torch
from soda_tpu_torch import profiling, testing
from soda_tpu_torch.backend import tile_plan
from soda_tpu_torch.corpus import CORPUS
from soda_tpu_torch.model import estimate as est
from soda_tpu_torch.model import fit
from soda_tpu_torch.optimization import cr_schedules

RECORD = pathlib.Path(est.__file__).resolve().parent / 'h100_record.json'
CELLS = {name: (shape, overrides) for name, shape, overrides in testing.CELLS}
NAMES = [name for name, _, _ in testing.CELLS]
# the keys the JAX package's estimate has and the port's does not: TPU
# slab, VMEM and grid-step fields
JAX_ONLY = ('block_rows', 'slab_rows', 'vmem_bytes', 'vmem_ok', 'grid_steps',
            'grid_m', 'mid_tile', 'grid_step_overhead_s', 'peak_vpu_gflops')
_BUILT = {}


def _cell(name):
  if name not in _BUILT:
    _BUILT[name] = testing.build_cell_stepped(name, CELLS[name][1])
  return _BUILT[name]


def _record():
  with open(RECORD) as f:
    return json.load(f)


@pytest.mark.parametrize('name,opts', [(n, {}) for n in NAMES] +
                         list(testing.MODE_CELLS),
                         ids=['%s-%d' % (n, i) for i, (n, _) in enumerate(
                             [(n, {}) for n in NAMES] +
                             list(testing.MODE_CELLS))])
def test_plan_fields_are_the_executors_plan(name, opts):
  shape = CELLS[name][0]
  stencil = _cell(name)
  got = est.estimate(stencil, shape, 'cpu', kernel_opts=opts)
  plan = tile_plan.kernel_plan(stencil, shape, **opts)
  # the modes build the short form; ``_short=()`` keeps the old one
  assert got['form'] == est.form(plan) == (
      'many-stage' if name == 'contrast' and not opts else 'short')
  if opts:
    assert est.estimate(stencil, shape, 'cpu', kernel_opts=dict(
        opts, _short=()))['form'] == 'mode'

  assert got['tile'] == list(plan.tile)
  assert got['smem_bytes'] == plan.smem_bytes
  assert got['smem_ok'] is (plan.smem_bytes <= tile_plan.SMEM_LIMIT)
  assert got['ctas_per_sm'] == tile_plan.resident_ctas(plan.smem_bytes)
  assert got['tiles'] == plan.n_tiles
  assert got['waves'] == -(-plan.n_tiles // (tile_plan.SMS *
                                             got['ctas_per_sm']))
  form = plan.short or plan.deep
  if form is not None:
    assert got['barriers_per_tile'] == len(form.barriers)
    assert got['evaluations_per_output'] == pytest.approx(form.evaluations)
    assert got['ctas_per_sm'] == form.ctas
  else:
    assert got['barriers_per_tile'] == len(plan.stages)
    assert got['evaluations_per_output'] == pytest.approx(
        tile_plan.stage_evaluations(plan.spans, plan.tile, plan.stages))
  if plan.short is not None:
    assert got['fills_per_output'] == pytest.approx(plan.short.fills)
  assert got['launches'] == 1
  for key in JAX_ONLY:
    assert key not in got


@pytest.mark.parametrize('name', NAMES)
def test_ir_counts_equal_the_jax_estimate(name, monkeypatch):
  shape, overrides = CELLS[name]
  text = CORPUS[name.split('_')[0]]
  monkeypatch.setattr(cr_schedules, 'time', testing.StepClock())
  port = soda_tpu_torch.build_stencil(text, **overrides)
  monkeypatch.setattr(jax_cr, 'time', testing.StepClock())
  jax = soda_tpu.build_stencil(text, **overrides)
  got = est.estimate(port, shape, 'cpu')
  want = jax_est.estimate(jax, shape)
  for key in ('ops_per_cell', 'cells', 'hbm_bytes', 'stages',
              'total_reuse_distance'):
    assert got[key] == want[key], key
  assert [tuple(got['halo'][k]) for k in ('lo', 'hi')] == \
      [tuple(want['halo'][k]) for k in ('lo', 'hi')]
  assert est.count_ops(port) == jax_est.count_ops(jax)


@pytest.mark.parametrize('name', NAMES)
def test_op_classes_sum_to_the_bounds_count(name):
  shape = CELLS[name][0]
  stencil = _cell(name)
  plan = tile_plan.kernel_plan(stencil, shape)
  total = 0
  for stage in plan.stages:
    lo, hi = plan.margins[stage.name]
    valid = int(np.prod([s - a - b for s, a, b in zip(shape, lo, hi)]))
    total += sum(est.stage_op_classes(stage).values()) * valid
  assert total == profiling.op_count(stencil, shape)
  ceil = est.op_model(stencil, plan, 'ceiling')
  assert sum(ceil['arith'].values()) * np.prod(shape) == pytest.approx(
      profiling.op_count(stencil, shape))
  # the expected model counts each stage at its evaluations
  model = est.op_model(stencil, plan)
  for kind in ('f32', 'int'):
    assert set(model['arith'][kind]) == set(profiling.OP_CLASSES)
  assert sum(sum(v.values()) for v in model['arith'].values()) == \
      pytest.approx(sum(sum(est.stage_op_classes(s).values()) *
                        model['evaluations'][s.name] for s in plan.stages))


@pytest.mark.parametrize('name', NAMES)
def test_ideal_time_is_the_bound(name):
  shape = CELLS[name][0]
  stencil = _cell(name)
  got = est.estimate(stencil, shape, 'cpu')
  bound, bound_by = profiling.bound_ms(stencil, shape)
  assert got['ideal_time_s'] == pytest.approx(bound / 1e3, rel=1e-12)
  assert got['bound'] == bound_by
  assert got['est_roofline_frac'] == round(min(
      1.0, got['ideal_time_s'] / got['est_time_s']), 4)
  assert 0 < got['ceiling_frac'] <= 1.0


@pytest.mark.parametrize('name', NAMES)
def test_ceiling_dominates_every_recorded_share(name):
  rows = [r for r in _record()['rows'] if r['cell'] == name]
  assert rows and sum(r['default'] for r in rows) == 1
  shape = CELLS[name][0]
  ceiling = est.ceiling_frac(_cell(name), shape, 'cpu')
  assert ceiling <= 1.0
  for row in rows:
    share = row['bound_ms'] * 1e3 / row['b2b_us']
    assert share <= ceiling * 1.03 + 1e-9, (
        '%s %s: measured share %.3f exceeds the model ceiling %.3f: refit '
        'estimate.py' % (name, row['kernel_opts'], share, ceiling))


def _pairs_stencil(dtype):
  return soda_tpu_torch.build_stencil('''
kernel: pairs
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input %(t)s: a(64, *)
output %(t)s: y(0, 0) = a(0, 0) * a(1, 0) + a(0, 1) * a(1, 1) + a(2, 2)
''' % {'t': dtype})


@pytest.mark.parametrize('dtype', ['float', 'int32', 'int16'])
def test_ceiling_prices_float_pairs_twice_and_integer_pairs_once(dtype):
  """The kernels build with --fmad=false, so a float multiply and add
  are two instructions; nvcc still emits one IMAD for an integer
  a * b + c, so the ceiling prices each contractible integer pair once
  (a 16-bit stage's adds besides at half, as packed pairs)."""
  stencil = _pairs_stencil(dtype)
  shape = (64, 64)
  plan = tile_plan.kernel_plan(stencil, shape)
  ceil = est.op_model(stencil, plan, 'ceiling')
  counts = est.stage_op_classes(plan.stages[0])
  assert (counts['mul'], counts['add']) == (2, 2)
  valid = np.prod([s - 2 for s in shape]) / np.prod(shape)
  if dtype == 'float':
    assert ceil['int_fma_pairs'] == 0
    assert ceil['slots_per_cell'] == pytest.approx(4 * valid)
  elif dtype == 'int32':
    assert ceil['int_fma_pairs'] == pytest.approx(2 * valid)
    assert ceil['slots_per_cell'] == pytest.approx(2 * valid)
  else:  # two IMADs, one slot each (a packed add's half is no cheaper)
    assert ceil['slots_per_cell'] == pytest.approx(2 * valid)


def test_constants_are_the_fit_of_the_record():
  prices, residuals = fit.fit(_record())
  for key in est.PRICE_KEYS:
    assert getattr(est, key) == prices[key], key
  text = fit.constants_text(prices)
  for key in est.PRICE_KEYS:
    assert '%s = %r' % (key, getattr(est, key)) in text
  assert len(residuals) == len(_record()['rows'])
  assert fit.median_log_error(residuals) < math.log(1.5)


def test_fit_without_scipy_finds_the_same_constants(monkeypatch):
  want, _ = fit.fit(_record())
  monkeypatch.setitem(sys.modules, 'scipy.optimize', None)
  got, _ = fit.fit(_record())
  assert got == want


@pytest.mark.parametrize('name', NAMES)
def test_default_cell_estimate_within_range_of_its_record(name):
  record = _record()
  row = next(r for r in record['rows'] if r['cell'] == name and r['default'])
  params = est.device_params(record['device']['device'])
  prices = {key: getattr(est, key) for key in est.PRICE_KEYS}
  feats = fit.row_features(row, prices, params)
  est_us = sum(prices[k] * feats[c] for k, c in est.FITTED) * 1e6
  assert 0.67 <= est_us / row['b2b_us'] <= 1.5, (name, est_us,
                                                   row['b2b_us'])
  if 'computation-reuse' not in CELLS[name][1].get('optimizations', {}):
    # the record's counts are the model's for the same stage graph
    got = est.estimate(_cell(name), CELLS[name][0], 'cpu')
    assert got['tile'] == row['tile']
    assert got['op_model']['smem_bytes'] == pytest.approx(
        row['model']['smem_bytes'])
    for kind, counts in row['model']['arith'].items():
      assert got['op_model']['arith'][kind] == pytest.approx(counts)
    assert got['est_time_s'] * 1e6 == pytest.approx(est_us)


def test_record_names_its_card_and_probe_rows():
  record = _record()
  assert 'H100' in record['device']['nvidia_smi']
  assert ' W' in record['device']['nvidia_smi']
  assert {r['cell'] for r in record['rows']} == set(NAMES)
  assert {'exp27', 'exp24', 'exp45'} <= set(record['probes'])
  for row in record['rows']:
    if row['default']:
      assert row['scheduler'] in ('none', 'native', 'python')
      assert row['whole_grid_ms'] > 0


def test_model_file_overrides_and_rejects_unknown_keys():
  stencil = _cell('blur')
  shape = CELLS['blur'][0]
  base = est.estimate(stencil, shape, 'cpu')
  got = est.estimate(stencil, shape, 'cpu', model_params={
      'hbm_gbps': 1000.0, 'name': 'slow card', 'OP_COST': {'div': 30.0},
      'BARRIER_S': 1e-6})
  assert got['peak_hbm_gbps'] == 1000.0 and got['device'] == 'slow card'
  assert got['est_time_s'] > base['est_time_s']
  assert got['ideal_time_s'] > base['ideal_time_s']
  with pytest.raises(soda_tpu_torch.utils.InputError, match='gops'):
    est.estimate(stencil, shape, 'cpu', model_params={'vpu_gflops': 1.0})
  with pytest.raises(soda_tpu_torch.utils.InputError, match='div'):
    est.estimate(stencil, shape, 'cpu', model_params={'OP_COST': {'x': 1}})
  for bad in ({'OP_COST': 3}, {'BARRIER_S': 'x'}, {'hbm_gbps': 'z'}):
    with pytest.raises(soda_tpu_torch.utils.InputError):
      est.estimate(stencil, shape, 'cpu', model_params=bad)


def test_device_table_assumes_the_h100_on_the_cpu(monkeypatch):
  def no_cuda(*_):
    raise AssertionError('CUDA touched for a CPU device')

  monkeypatch.setattr(torch.cuda, 'get_device_name', no_cuda)
  got = est.device_params('cpu')
  assert 'assumed' in got['device']
  assert got['hbm_gbps'] == profiling.H100_BYTES_PER_S / 1e9
  assert got['ops_per_s'] == profiling.H100_F32_OPS_PER_S
  assert (got['sms'], got['clock_hz'], got['smem_bytes_per_clock']) == (
      132, 1.98e9, 128)
  assert profiling.peak_bandwidth('cpu') == 3350.0
  named = est.device_params('NVIDIA H100 80GB HBM3')
  assert named['device'] == 'NVIDIA H100 80GB HBM3'
  assert profiling.peak_bandwidth('NVIDIA H100 80GB HBM3') == 3350.0


@pytest.mark.parametrize('iterate', [1, 2])
def test_throughput_reports_the_jax_lines(iterate):
  numbers = dict(seconds=3.1e-5, cells=8192 * 2048, hbm_bytes=67108864,
                 iterate=iterate)
  got, want = [], []
  profiling.Throughput(**numbers).report(got.append)
  jax_profiling.Throughput(**numbers).report(want.append)
  assert got == want
  assert len(got) == 3 + (iterate > 1)


def test_measure_times_a_cpu_executor():
  shape = (64, 128)
  stencil = testing.build_cell('blur', {'tile_size': (128, 0)})
  ex = soda_tpu_torch.get_executor(stencil, shape, device='cpu')
  inputs = testing.make_test_inputs(stencil, shape)
  got = profiling.measure(ex, inputs, reps=3)
  assert got.seconds > 0 and got.cells == 64 * 128
  assert got.hbm_bytes == 2 * 2 * 64 * 128
  rep = soda_tpu_torch.get_executor(stencil, shape, 'replicated',
                                    device='cpu', replication_factor=3)
  stacked = {k: np.stack([v] * 3) for k, v in inputs.items()}
  got = profiling.measure(rep, stacked, reps=2)
  assert got.cells == 3 * 64 * 128 and got.hbm_bytes == 3 * 2 * 2 * 64 * 128


def test_print_estimation_is_json():
  out = io.StringIO()
  est.print_estimation(_cell('jacobi3d'), CELLS['jacobi3d'][0], out, 'cpu')
  got = json.loads(out.getvalue())
  assert got['form'] == 'short' and got['stages'] == 2
