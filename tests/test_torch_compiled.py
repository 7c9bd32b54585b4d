"""Tool and auxiliary tests of the port: calc-cost and compiled stats
(the counterparts of tests/test_tools.py).

On the CPU ``compiled_stats`` builds nothing: the card's fields are
None and the result says so; the plan's fields are filled. The card's
own numbers are read on the card (tests/test_torch_gpu.py).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from soda_tpu_torch import corpus, utils
from soda_tpu_torch.backend import build, get_executor
from soda_tpu_torch.model.compiled import CARD_FIELDS, compiled_stats
from soda_tpu_torch.testing import repeated_mesh

REPO = str(pathlib.Path(__file__).resolve().parent.parent)


def _calc_cost(module, payload):
  return subprocess.run(
      [sys.executable, '-m', module], input=json.dumps(payload),
      capture_output=True, text=True, cwd=REPO,
      env=dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO))


@pytest.mark.parametrize('payload', [
    {'schedule': {'distance': 10,
                  'left': {'distance': 1, 'left': 1, 'right': 1},
                  'right': {'distance': 1, 'left': 1, 'right': 1}},
     'aattrs': None},
    {'schedule': {'distance': 3, 'left': 1,
                  'right': {'distance': 2, 'left': 1, 'right': 1}},
     'aattrs': None},
])
def test_calc_cost_cli_matches_jax(payload):
  port = _calc_cost('soda_tpu_torch.tools.calc_cost', payload)
  jax = _calc_cost('soda_tpu.tools.calc_cost', payload)
  assert port.returncode == jax.returncode == 0, port.stderr + jax.stderr
  assert json.loads(port.stdout) == json.loads(jax.stdout)


def test_calc_cost_cli():
  """tests/test_tools.py:19-34 on the port's tool."""
  schedule = {'distance': 10,
              'left': {'distance': 1, 'left': 1, 'right': 1},
              'right': {'distance': 1, 'left': 1, 'right': 1}}
  r = _calc_cost('soda_tpu_torch.tools.calc_cost',
                 {'schedule': schedule, 'aattrs': None})
  assert r.returncode == 0, r.stderr
  out = json.loads(r.stdout)
  # (x0 + x1) reused at offsets 0 and 10 -> 2 unique ops
  assert out['num_ops'] == 2
  assert out['total_distance'] >= 10


def _check_plan_fields(stats, kernels):
  assert stats['device'] == 'cpu' and 'null' in stats['note']
  assert len(stats['kernels']) == kernels
  for kernel in stats['kernels']:
    assert all(kernel[field] is None for field in CARD_FIELDS)
    assert kernel['ctas'] > 0 and kernel['smem_plan_bytes'] > 0
    assert kernel['threads_per_cta'] == 512
    assert kernel['bytes_in'] > 0 and kernel['bytes_out'] > 0


def test_compiled_stats_reports_the_plan_on_the_cpu():
  stencil = corpus.build('blur')
  shape = (1024, 2048)
  ex = get_executor(stencil, shape, device='cpu')
  stats = compiled_stats(ex)
  _check_plan_fields(stats, 1)
  (kernel,) = stats['kernels']
  assert tuple(kernel['tile']) == ex.plan.tile
  assert kernel['ctas'] == ex.plan.n_tiles and kernel['steps_per_cta'] == 1
  assert kernel['mode'] == 'default'
  cells = int(np.prod(shape))
  assert (kernel['bytes_in'], kernel['bytes_out']) == (2 * cells, 2 * cells)


def test_compiled_stats_of_a_mode_kernel():
  stencil = corpus.build('blur')
  ex = get_executor(stencil, (8192, 2048), device='cpu', stream_loop='peel',
                    prefetch=3)
  (kernel,) = compiled_stats(ex)['kernels']
  assert kernel['mode'] == 'peel+prefetch3'
  assert kernel['steps_per_cta'] == ex.plan.steps > 1
  assert kernel['ctas'] == ex.plan.n_ctas


def test_compiled_stats_of_grouped_replicated_and_sharded():
  coarse = corpus.build('denoise2d', cluster='coarse')
  grouped = get_executor(coarse, (64, 64), device='cpu')
  _check_plan_fields(compiled_stats(grouped), len(grouped.executors))
  blur = corpus.build('blur')
  replicated = get_executor(blur, (64, 64), 'replicated', device='cpu',
                            replication_factor=3)
  stats = compiled_stats(replicated)
  _check_plan_fields(stats, 1)
  assert stats['kernels'][0]['bytes_in'] == 3 * 64 * 64 * 2
  sharded = get_executor(blur, (64, 64), 'sharded', device='cpu',
                         mesh=repeated_mesh('cpu', (2,)))
  _check_plan_fields(compiled_stats(sharded), 1)


def test_compiled_stats_of_the_whole_grid_executor_raises():
  ex = get_executor(corpus.build('blur'), (64, 64), 'xla', device='cpu')
  with pytest.raises(utils.InputError, match='no kernel'):
    compiled_stats(ex)


# the assembler's report of a mode kernel's two instantiations, as nvcc
# 12.9 printed it for sm_90a
PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z27soda_fused_5c5192c877a91cc4ILb1EEvPKtPt' for 'sm_90a'
ptxas info    : Function properties for _Z27soda_fused_5c5192c877a91cc4ILb1EEvPKtPt
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers
ptxas info    : Compile time = 95.994 ms
ptxas info    : Function properties for soda_stage_helper
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_Z27soda_fused_5c5192c877a91cc4ILb0EEvPKtPt' for 'sm_90a'
ptxas info    : Function properties for _Z27soda_fused_5c5192c877a91cc4ILb0EEvPKtPt
    0 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
"""


def test_parse_ptxas_reads_each_entry():
  """Registers and spills per entry function; a device function's
  properties are not its caller's."""
  report = build.parse_ptxas(PTXAS_LOG)
  assert report == {
      '_Z27soda_fused_5c5192c877a91cc4ILb1EEvPKtPt':
          {'registers': 38, 'spill_stores': 0, 'spill_loads': 0},
      '_Z27soda_fused_5c5192c877a91cc4ILb0EEvPKtPt':
          {'registers': 32, 'spill_stores': 4, 'spill_loads': 12},
  }
