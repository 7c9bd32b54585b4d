"""Render the measured-performance table from the committed record.

The counterpart of soda_tpu/tools/perf_report.py. The table quotes the
recorded card run, never an in-process one: the record that ``python -m
soda_tpu_torch.model.fit --measure`` writes (by default the committed
soda_tpu_torch/model/h100_record.json). Per benchmark cell, from its
default kernel's row: the measured share of the bound (bound over the
back-to-back microseconds a call), the model's ceiling
(estimate.ceiling_frac, the upper bound tests/test_torch_estimate.py
holds every recorded row to) and its estimated share (the bound over
estimate.py's time for the row's recorded counts), the microseconds, the
unique traffic's GB/s, and the whole-grid executor's cold-L2 time over
the kernel's (the port's ``--backend xla``: the counterpart of the JAX
table's "vs XLA"). The geomean of the measured shares covers the 11
corpus cells; jacobi3d_256 is of record but not in it, as in the JAX
tool. No target is printed: no TPU number is one for the port.

Usage: python -m soda_tpu_torch.tools.perf_report [--json] [--record PATH]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

RECORD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'model', 'h100_record.json')
# benchmark cells of record that the geomean leaves out (an extra shape
# of a corpus kernel)
NOT_IN_GEOMEAN = ('jacobi3d_256',)


def build_report(record_path: str = RECORD) -> dict:
  from soda_tpu_torch import profiling, testing
  from soda_tpu_torch.model import estimate as est
  from soda_tpu_torch.model import fit
  with open(record_path) as f:
    record = json.load(f)
  device = record['device']['device']
  params = est.device_params(device)
  prices = {key: getattr(est, key) for key in est.PRICE_KEYS}
  rows = []
  for name, shape, overrides in testing.CELLS:
    entry = next((r for r in record['rows']
                  if r['cell'] == name and r['default']), None)
    if entry is None:
      continue
    stencil = testing.build_cell_stepped(name, overrides)
    in_b, out_b = profiling.stream_bytes(stencil, shape)
    feats = fit.row_features(entry, prices, params)
    est_s = sum(prices[key] * feats[col] for key, col in est.FITTED)
    bound_s = entry['bound_ms'] / 1e3
    seconds = entry['b2b_us'] / 1e6
    whole = entry.get('whole_grid_ms')
    rows.append({
        'kernel': name,
        'share': round(bound_s / seconds, 4),
        'ceiling': round(est.ceiling_frac(stencil, shape, device), 4),
        'est_share': round(bound_s / est_s, 4),
        'us': round(entry['b2b_us'], 2),
        'est_us': round(est_s * 1e6, 2),
        'gbps': round((in_b + out_b) / seconds / 1e9, 1),
        'whole_grid_over_kernel': (round(whole / entry['ms'], 2)
                                   if whole else None),
        'form': entry['form'],
        'in_geomean': name not in NOT_IN_GEOMEAN,
    })
  rows.sort(key=lambda r: -r['share'])
  shares = [r['share'] for r in rows if r['in_geomean']]
  geomean = (math.exp(sum(map(math.log, shares)) / len(shares)) if shares
             else 0.0)
  return {'date': record.get('date'), 'device': record['device']['nvidia_smi'],
          'record': os.path.relpath(record_path), 'geomean': round(geomean, 4),
          'geomean_cells': len(shares), 'rows': rows}


def render(report: dict) -> str:
  """The report as a markdown table with its heading and geomean."""
  lines = ['Measured performance (%s, %s, %s: back to back, the default '
           'kernel of each benchmark cell)' % (
               report['date'], report['device'], report['record']), '',
           '| kernel | measured share | model ceiling | estimated share | us '
           '| GB/s | whole grid / kernel |', '|---|---|---|---|---|---|---|']
  for r in report['rows']:
    whole = r['whole_grid_over_kernel']
    lines.append('| %s | %.3f | %.3f | %.3f | %.1f | %.0f | %s |' % (
        r['kernel'], r['share'], r['ceiling'], r['est_share'], r['us'],
        r['gbps'], '%.1fx' % whole if whole else '-'))
  lines += ['', 'Geomean of the measured shares over %d cells: %.4f' % (
      report['geomean_cells'], report['geomean'])]
  return '\n'.join(lines)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--json', action='store_true')
  parser.add_argument('--record', default=RECORD,
                      help='a fit --measure record (default: %(default)s)')
  args = parser.parse_args(argv)
  report = build_report(args.record)
  print(json.dumps(report, indent=1) if args.json else render(report))
  return 0


if __name__ == '__main__':
  sys.exit(main())
