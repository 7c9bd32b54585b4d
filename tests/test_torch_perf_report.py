"""``python -m soda_tpu_torch.tools.perf_report``: the table of the
committed record (soda_tpu_torch/model/h100_record.json), on the CPU.

One row per benchmark cell from its default kernel's row (12), the
geomean of the measured shares over the 11 corpus cells (jacobi3d_256
of record but not in it, as in the JAX tool), each row's measured share
under the model's ceiling, the estimated share beside it, and no target.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

from soda_tpu_torch import testing
from soda_tpu_torch.tools import perf_report

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module')
def report():
  return perf_report.build_report()


def test_json_has_12_rows_and_a_geomean_over_11():
  env = dict(os.environ, PYTHONPATH=str(REPO))
  out = subprocess.run([sys.executable, '-m',
                        'soda_tpu_torch.tools.perf_report', '--json'],
                       capture_output=True, text=True, cwd=str(REPO),
                       env=env, timeout=300, check=True).stdout
  got = json.loads(out)
  assert len(got['rows']) == 12
  assert got['geomean_cells'] == 11
  assert {r['kernel'] for r in got['rows']} == {c[0] for c in testing.CELLS}
  assert [r['kernel'] for r in got['rows'] if not r['in_geomean']] == [
      'jacobi3d_256']
  assert 'H100' in got['device']


def test_geomean_and_columns(report):
  shares = [r['share'] for r in report['rows'] if r['in_geomean']]
  assert report['geomean'] == round(
      math.exp(sum(map(math.log, shares)) / len(shares)), 4)
  assert [r['share'] for r in report['rows']] == sorted(
      (r['share'] for r in report['rows']), reverse=True)
  for row in report['rows']:
    assert 0 < row['share'] <= row['ceiling'] * 1.03
    assert 0 < row['est_share'] and row['us'] > 0 and row['gbps'] > 0
    assert 0.67 <= row['est_us'] / row['us'] <= 1.5
    assert row['whole_grid_over_kernel'] > 1
    assert row['form'] == ('many-stage' if row['kernel'] == 'contrast'
                           else 'short')


def test_table_prints_every_cell_and_no_target(report):
  out = perf_report.render(report)
  lines = [line for line in out.splitlines() if line.startswith('|')]
  assert len(lines) == 2 + 12
  assert 'target' not in out.lower()
  assert 'Geomean of the measured shares over 11 cells' in out


def test_another_record(tmp_path, report):
  with open(perf_report.RECORD) as f:
    record = json.load(f)
  record['rows'] = [r for r in record['rows'] if r['cell'] != 'blur']
  path = tmp_path / 'record.json'
  path.write_text(json.dumps(record))
  got = perf_report.build_report(str(path))
  assert len(got['rows']) == 11 and got['geomean_cells'] == 10
