"""Measure the fused kernel for the cost model, and fit the model's prices.

    python -m soda_tpu_torch.model.fit --measure OUT.json
    python -m soda_tpu_torch.model.fit --fit RECORD.json

``--measure`` (on the card; exits 1 without one) writes a record: the
card's report (``profiling.device_report``: its nvidia-smi name and
power limit, torch, CUDA and nvcc), and one row per kernel of the 12
benchmark cells (``testing.CELLS``): each cell's default kernel, and
the tiles ``tile_sweep`` sweeps (``short_runs``' tiles of the short
form, ``deep_runs``' schedules of the many-stage form for contrast),
every kernel built at once. A row holds the cell, its kernel options,
the plan's fields and the op model's counts as ``estimate`` reports
them, the device microseconds a call back to back (``b2b_us``: a settle
run, then ``profiling.replay_us``, 200 calls replayed from one CUDA
graph, as first ... last, last ... first; the host enqueues a short-form
call in 30-60 us, as long as the fastest kernels run, so the calls are
replayed), the host's and the device's microseconds a call enqueued
from Python (``back_to_back_us``), the cold-L2 median, the bound, and for a default kernel the whole-grid executor's
cold-L2 median. Each kernel is held bit for bit against its cell's
default kernel, the default kernel within the threshold of the plain
version. Beside them, the probe rows the prices come from: exp27's and
exp30's streaming cases (K6.1-K6.2), exp24's (K6.3) and exp45's (K6.4)
chain bodies,
through ``soda_tpu_torch.experiments``; and which computation-reuse
scheduler built each cell's stage graph.

``--fit`` (on the CPU) derives the probe prices from a record's probe
rows, fits the other constants by non-negative least squares on the
rows' back-to-back times (each row weighted by the inverse of its
time, so that every row counts by its relative error), prints them as
the Python constants of model/estimate.py, and then each row's
estimate against its measurement and the median |log(est/measured)|.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

from soda_tpu_torch.model import estimate as est

# back-to-back calls a measurement: the short form's kernels take 0.03-
# 0.3 ms a call, the many-stage form's 1.5-10 ms
CALLS = 200
DEEP_CALLS = 50
# the chain probes' slope, as chip_smoke.py takes it
CHAIN_N_SMALL, CHAIN_N_BIG = 64, 2048
# cold-L2 repetitions of the whole-grid executor (1-25 ms a call)
WHOLE_GRID_REPS = 5
# the prices no probe row gives: a float32 add and multiply are the
# unit; an integer add runs on either integer pipe (K6.5); an integer
# division by a constant, at its lowering
UNIT_PRICES = {'add': 1.0, 'mul': 1.0}
INT_FIXED = {'add': 1.0, 'div': 4.0}


def _jsonable(opts: Dict[str, object]) -> Dict[str, object]:
  return {k: list(v) if isinstance(v, tuple) else v for k, v in opts.items()}


def scheduler(overrides) -> str:
  """Which computation-reuse scheduler builds a cell's stage graph here:
  'none', 'native' (the external binary) or 'python'."""
  from soda_tpu_torch.optimization import cr_schedules
  if 'computation-reuse' not in overrides.get('optimizations', {}):
    return 'none'
  return 'native' if cr_schedules.find_external_cr() else 'python'


def cell_runs(name, shape, overrides):
  """(stencil, runs) of one cell: its stencil and the (label, kernel
  options, WALK_WAVES or None) of its rows, the default kernel, then
  tile_sweep's tiles of its form."""
  from soda_tpu_torch import testing, tile_sweep
  runs = [('default', {}, None)]
  if name == 'contrast':
    stencil = testing.build_cell(name, overrides)
    for plans in tile_sweep.deep_runs(stencil, shape):
      runs += [('tile', {'tile': p.tile, '_deep': p.deep.elements}, None)
               for p in plans]
  else:
    _, _, stencil, _, tiles = tile_sweep.short_runs([name])[0]
    runs += [(label, {'tile': tile, '_short': elements}, waves)
             for label, tile, elements, waves in tiles]
  return stencil, runs


def measure(out_path: str, log=print) -> int:
  """``--measure``: write the record to ``out_path``."""
  import torch
  if not torch.cuda.is_available():
    print('fit --measure: no CUDA device; it measures the card',
          file=sys.stderr)
    return 1
  from soda_tpu_torch import get_executor, profiling, testing, tile_sweep
  from soda_tpu_torch.backend import build, cuda_source
  from soda_tpu_torch.backend.fused import FusedExecutor, fused_stencil_plain
  from soda_tpu_torch.backend.tile_plan import kernel_plan
  from soda_tpu_torch.experiments import (exp24_stage_tax, exp27_gridloop,
                                          exp30_dma_granularity,
                                          exp45_transcendental_tax)
  t_start = time.time()
  report = profiling.device_report()
  smi = report['nvidia_smi']
  log('[fit] %s | torch %s | cuda %s | %s' % (smi, report['torch'],
                                              report['cuda'], report['nvcc']))
  cells = []
  sources = []
  for name, shape, overrides in testing.CELLS:
    stencil, runs = cell_runs(name, shape, overrides)
    for _, opts, waves in runs:
      with tile_sweep._waves(waves):
        sources.append(cuda_source.generate(kernel_plan(stencil, shape,
                                                        **opts)))
    cells.append((name, shape, overrides, stencil, runs))
  sources = list({src.digest: src for src in sources}.values())
  t = time.time()
  build.build_all(sources)
  log('[fit] nvcc: %d kernels at once (%.1fs)' % (len(sources),
                                                  time.time() - t))
  rows = []
  for name, shape, overrides, stencil, runs in cells:
    t = time.time()
    inputs = testing.make_test_inputs(stencil, shape)
    params = testing.make_test_params(stencil)
    exs = []
    for _, opts, waves in runs:
      with tile_sweep._waves(waves):
        exs.append(FusedExecutor(stencil, shape, **opts))
    args = exs[0].prepare(inputs, params)
    n_in = len(stencil.input_names)
    want = dict(zip(stencil.output_names, exs[0].fn(*args)))
    plain = dict(zip(stencil.output_names, fused_stencil_plain(
        stencil, args[:n_in], args[n_in:])))
    testing.check_outputs(stencil, shape, want, plain, name)
    del plain
    for (label, opts, _), ex in zip(runs[1:], exs[1:]):
      got = dict(zip(stencil.output_names, ex.fn(*args)))
      testing.check_exact(stencil, shape, got, want, '%s %s %s' % (
          name, label, opts))
    del got, want
    calls = DEEP_CALLS if name == 'contrast' else CALLS
    profiling.settle(lambda: exs[0].fn(*args))
    us = {i: [] for i in range(len(exs))}
    order = list(range(len(exs)))
    for i in order + order[::-1]:
      us[i].append(profiling.replay_us(lambda: exs[i].fn(*args),
                                       calls=calls))
    python = [profiling.back_to_back_us(lambda: ex.fn(*args), calls=calls)
              for ex in exs]
    bound, bound_by = profiling.bound_ms(stencil, shape)
    whole = get_executor(stencil, shape, 'xla')
    whole_args = whole.prepare(inputs, params)
    whole_ms = statistics.median(profiling.cuda_times_ms(
        lambda: whole.fn(*whole_args), reps=WHOLE_GRID_REPS, warmup=1))
    del whole, whole_args
    for i, ((label, opts, waves), ex) in enumerate(zip(runs, exs)):
      with tile_sweep._waves(waves):
        e = est.estimate(stencil, shape, 'cuda', kernel_opts=opts)
      if (e['tile'], e['smem_bytes']) != (list(ex.plan.tile),
                                          ex.plan.smem_bytes):
        raise RuntimeError('%s %s: the estimate\'s plan differs from the '
                           'built kernel\'s' % (name, opts))
      b2b = statistics.mean(us[i])
      ms = statistics.median(profiling.cuda_times_ms(lambda: ex.fn(*args)))
      row = {
          'cell': name, 'shape': list(shape), 'label': label,
          'default': i == 0, 'kernel_opts': _jsonable(opts),
          'walk_waves': waves, 'b2b_us': b2b, 'b2b_runs_us': us[i],
          'python_host_us': python[i][0], 'python_device_us': python[i][1],
          'ms': ms, 'bound_ms': bound,
          'bound_by': bound_by, 'share': bound / (b2b / 1e3),
          'ceiling_frac': e['ceiling_frac'],
          'est_us': e['est_time_s'] * 1e6,
          'model': {k: e['op_model'][k] for k in ('arith', 'smem_bytes',
                                                  'hbm_bytes')},
      }
      row.update({k: e[k] for k in ('form', 'tile', 'smem_bytes',
                                    'smem_ok', 'ctas_per_sm', 'tiles',
                                    'waves', 'evaluations_per_output',
                                    'fills_per_output', 'barriers_per_tile',
                                    'launches', 'cells')})
      if i == 0:
        row.update(whole_grid_ms=whole_ms,
                   scheduler=scheduler(overrides))
      rows.append(row)
      log('[fit] %-12s %-18s tile %-14s %-10s %d CTA(s)/SM %3d barriers '
          '%6.2f evaluations  back to back %8.2f us  cold %.4f ms  share '
          '%.3f  estimate %8.2f us (%.2fx) | %s' % (
              name, label, tuple(row['tile']), row['form'],
              row['ctas_per_sm'], row['barriers_per_tile'],
              row['evaluations_per_output'], b2b, ms, row['share'],
              row['est_us'], row['est_us'] / b2b, smi), flush=True)
    del exs, args
    torch.cuda.synchronize()
    log('[fit] %-12s %d rows, whole grid %.3f ms (%.1fs)' % (
        name, len(runs), whole_ms, time.time() - t))
  t = time.time()
  probes = {
      'exp27': exp27_gridloop.run('cuda', log=log),
      'exp30': exp30_dma_granularity.run('cuda', log=log),
      'exp24': exp24_stage_tax.run('cuda', n_small=CHAIN_N_SMALL,
                                   n_big=CHAIN_N_BIG, log=log),
      'exp45': exp45_transcendental_tax.run('cuda', n_small=CHAIN_N_SMALL,
                                            n_big=CHAIN_N_BIG, log=log),
  }
  bad = [r.get('case', r.get('body')) for rs in probes.values() for r in rs
         if not r['ok']]
  if bad:
    raise RuntimeError('probe rows wrong: %s' % bad)
  log('[fit] probes (%.1fs)' % (time.time() - t))
  record = {
      'command': 'python -m soda_tpu_torch.model.fit --measure',
      'date': time.strftime('%Y-%m-%d'),
      'device': report,
      'rows': rows,
      'probes': probes,
      'seconds': time.time() - t_start,
  }
  with open(out_path, 'w') as f:
    json.dump(record, f, indent=1, default=float)
    f.write('\n')
  log('[fit] %d rows, %d probe rows -> %s (%.1fs) | %s' % (
      len(rows), sum(map(len, probes.values())), out_path,
      time.time() - t_start, smi))
  return 0


# -- the fit ----------------------------------------------------------------

def _probe(record, experiment: str, key: str, name: str):
  return next(r for r in record['probes'][experiment] if r[key] == name)


def probe_prices(record) -> Dict[str, object]:
  """The prices the record's probe rows give (see estimate.py's
  comments): STREAM_EFF, INSTR_EFF, OP_COST, INT_OP_COST."""
  from soda_tpu_torch.experiments import probes
  stream = max(r['bound_ms'] / r['ms'] for key in ('exp27', 'exp30')
               for r in record['probes'][key])
  fma = _probe(record, 'exp45', 'body', 'fma10')
  instr = fma['bound_ms'] * 1e3 / fma['us']
  # microseconds of one float32 operation of the chain over the block
  unit = fma['us'] / probes.op_counts('fma10')['fp32']

  def per_step(body):  # each step an add and the priced operation
    row = _probe(record, 'exp45', 'body', body)
    steps = probes.CHAIN_BODIES[body].steps
    return (row['us'] / unit - steps) / steps

  ew = _probe(record, 'exp24', 'body', 'ew10')
  alu = ew['us'] / probes.op_counts('ew10')['int32'] / unit
  div, sqrt = per_step('div10'), per_step('sqrt10')
  op_cost = dict(UNIT_PRICES, div=div, minmax=alu, transcendental=sqrt,
                 other=alu)
  int_cost = dict(INT_FIXED, mul=alu, minmax=alu, transcendental=sqrt,
                  other=alu)
  return {'STREAM_EFF': stream, 'INSTR_EFF': instr,
          'OP_COST': {k: op_cost[k] for k in est.OP_COST},
          'INT_OP_COST': {k: int_cost[k] for k in est.INT_OP_COST}}


def _nnls(a: np.ndarray, b: np.ndarray) -> np.ndarray:
  """min |a x - b| over x >= 0 (scipy's, else an active-set loop)."""
  try:
    from scipy.optimize import nnls
    return nnls(a, b)[0]
  except ImportError:
    free = list(range(a.shape[1]))
    while True:
      x = np.zeros(a.shape[1])
      x[free] = np.linalg.lstsq(a[:, free], b, rcond=None)[0]
      neg = [k for k in free if x[k] < 0]
      if not neg:
        return x
      free.remove(min(neg, key=lambda k: x[k]))


def row_features(row, prices, params) -> Dict[str, float]:
  """A record row's features (estimate.features) at ``prices``."""
  model = dict(row['model'])
  return est.features(model, row, row['cells'], params, params['hbm_gbps'],
                      params['ops_per_s'], prices)


def rounded(value):
  """A fitted constant as printed: four significant digits."""
  if isinstance(value, dict):
    return {k: rounded(v) for k, v in value.items()}
  return float('%.4g' % value)


def fit(record) -> Tuple[Dict[str, object], List[Dict[str, object]]]:
  """(the constants, rounded as printed; per row the cell, label,
  measured and estimated microseconds)."""
  params = est.device_params(record['device']['device'])
  prices = rounded(probe_prices(record))
  rows = record['rows']
  feats = [row_features(r, prices, params) for r in rows]
  y = np.array([r['b2b_us'] * 1e-6 for r in rows])
  a = np.array([[f[name] for _, name in est.FITTED] for f in feats])
  coef = _nnls(a / y[:, None], np.ones(len(y)))
  prices.update({key: rounded(c) for (key, _), c in zip(est.FITTED, coef)})
  out = []
  for row, f in zip(rows, feats):
    e = sum(prices[key] * f[name] for key, name in est.FITTED)
    out.append({'cell': row['cell'], 'label': row['label'],
                'default': row['default'], 'tile': row['tile'],
                'measured_us': row['b2b_us'], 'est_us': e * 1e6})
  return prices, out


def median_log_error(residuals) -> float:
  return statistics.median(abs(math.log(r['est_us'] / r['measured_us']))
                           for r in residuals)


def constants_text(prices) -> str:
  """The constants as estimate.py spells them."""
  lines = []
  for key in est.PRICE_KEYS:
    value = prices[key]
    if isinstance(value, dict):
      lines.append('%s = {%s}' % (key, ', '.join(
          '%r: %r' % (k, v) for k, v in value.items())))
    else:
      lines.append('%s = %r' % (key, value))
  return '\n'.join(lines)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  group = parser.add_mutually_exclusive_group(required=True)
  group.add_argument('--measure', metavar='OUT',
                     help='measure on the card and write the record')
  group.add_argument('--fit', metavar='RECORD',
                     help='fit the prices to a record (CPU)')
  args = parser.parse_args(argv)
  if args.measure:
    return measure(args.measure)
  with open(args.fit) as f:
    record = json.load(f)
  prices, residuals = fit(record)
  print('# fitted to %s (%s, %s)' % (args.fit, record['device']['nvidia_smi'],
                                     record['date']))
  print(constants_text(prices))
  print()
  for r in residuals:
    print('# %-12s %-18s tile %-16s measured %9.2f us  estimate %9.2f us '
          '(%.3fx)%s' % (r['cell'], r['label'], tuple(r['tile']),
                         r['measured_us'], r['est_us'],
                         r['est_us'] / r['measured_us'],
                         '  <- default kernel' if r['default'] else ''))
  print('# median |log(est/measured)| over %d rows: %.4f' % (
      len(residuals), median_log_error(residuals)))
  return 0


if __name__ == '__main__':
  sys.exit(main())
