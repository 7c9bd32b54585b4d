"""Experiment 9 on the H100: a hand-written 2.5-D jacobi walk against the
generated 2-D kernel.

The port of experiments/exp9_layout25d.py (its Pallas probe, build_25d
at :108): two fused jacobi2d sweeps over the grid seen as (h, W/128,
128), east and west wrapping at the row's ends, rows [2, h-2) stored. A
GPU has no sublane axis, so the reshape itself is free; the question
that carries over is the kernel's shape: a double-buffered walk of row
tiles with two fused sweeps in shared memory, against the port's own
generated jacobi2d kernel (the script's PallasExecutor rows). See
layout25d.jacobi25d.

    python -m soda_tpu_torch.experiments.exp9_layout25d [--device cpu]

As the script's main() (:126-182): the correctness line at (64, 16,
128), block 32 (the kernel against its plain version bit for bit on
rows [2, h-2), and against the port's NumPy oracle within 1e-4 on the
script's region); then at (8192, 16, 128) the 2.5-D kernel for each
block (256, 512, 1024) and the port's jacobi2d kernel (``tile_size=(2048,
0)``) at block_rows 256, 512 and its default: the cold-L2 ms, the share
of the byte bound (0.0401 ms), back-to-back device µs, registers and
spills, each held to its plain version; the plain version's time. No
single PyTorch call computes two sweeps with row-end wrap: library
none. ``--device cpu`` runs the plain versions: the correctness line,
each block's walk against the whole-grid function at (2048, 2, 128),
and the jacobi2d rows at (256, 2048).
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

import soda_tpu_torch
from soda_tpu_torch import corpus, profiling, testing
from soda_tpu_torch.backend import reference
from soda_tpu_torch.backend.fused import fused_stencil_plain
from soda_tpu_torch.experiments import layout25d, narrow, probes

ORACLE_TOL = 1e-4  # exp9_layout25d.py:149
JACOBI_TILE = (16 * layout25d.LANES, 0)  # the script's tile_size (:145, :162)
JACOBI_BLOCK_ROWS = (256, 512, None)  # the script's 256, 512, and the default
# the script's 2-D grid (:134-135)
JACOBI_SHAPE = (layout25d.SHAPE[0], layout25d.SHAPE[1] * layout25d.LANES)
CPU_SHAPE, CPU_JACOBI_SHAPE = (2048, 2, layout25d.LANES), (256, 2048)


def correctness(device, log=print):
  """The script's correctness line at (64, 16, 128), block 32: the kernel
  (on the CPU its walk) against the whole-grid function bit for bit on
  rows [2, h-2), and against the oracle (jacobi2d, ``iterate: 2``) within
  ORACLE_TOL on rows and columns [2, -2)."""
  x = layout25d.grid_input(layout25d.CHECK_SHAPE, device)
  got = layout25d.jacobi25d(x, layout25d.CHECK_BLOCK)
  exact = torch.equal(layout25d.stored(got),
                      layout25d.stored(layout25d.jacobi25d_plain(x)))
  h = x.shape[0]
  stencil = corpus.build('jacobi2d', tile_size=JACOBI_TILE)
  want = reference.run(stencil, {'t1': layout25d._flat(x).cpu().numpy()})['t0']
  region = (slice(2, h - 2), slice(2, -2))
  err = float(np.max(np.abs(layout25d._flat(got).cpu().numpy()[region] -
                            want[region])))
  ok = exact and err < ORACLE_TOL
  log('2.5-D correctness %s block %d: == plain on rows [2, h-2) %s; oracle '
      'max abs err %.3g %s' % (layout25d.CHECK_SHAPE, layout25d.CHECK_BLOCK,
                               'bit for bit' if exact else 'DIFFERS', err,
                               'OK' if ok else 'FAIL'))
  return {'case': '2.5-D correctness', 'ok': ok, 'oracle_err': err,
          'exact': exact}


def _stats():
  from soda_tpu_torch.backend import build
  report = build.ptxas_report(build.csrc_source(layout25d.SOURCE))
  entry, = report.values()
  return entry['registers'], entry['spill_stores'] + entry['spill_loads']


def run_25d(device, log=print):
  """Each block's 2.5-D kernel at SHAPE on the card (on the CPU each
  block's walk at CPU_SHAPE), held to the whole-grid function on rows
  [2, h-2) bit for bit. Returns a row per block."""
  rows = []
  shape = layout25d.SHAPE if device.type == 'cuda' else CPU_SHAPE
  x = layout25d.grid_input(shape, device)
  want = layout25d.stored(layout25d.jacobi25d_plain(x))
  bound = layout25d.bound_ms(shape)
  for block in layout25d.BLOCKS:
    ctas = []
    got = layout25d.jacobi25d(x, block, ctas)
    err = probes.max_error(layout25d.stored(got), want)[0]
    row = {'case': '2.5-D block %d' % block, 'block': block,
           'ok': err == 0, 'abs_err': err, 'bound_ms': bound}
    rows.append(row)
    if device.type == 'cpu':
      log('2.5-D block=%-5d %s: walk == whole-grid plain %s' % (
          block, shape, 'bit for bit' if err == 0 else 'DIFFERS'))
      continue
    ms = statistics.median(profiling.cuda_times_ms(
        lambda: layout25d.jacobi25d(x, block)))
    _, b2b = profiling.back_to_back_us(lambda: layout25d.jacobi25d(x, block))
    regs, spills = _stats()
    row.update(ms=ms, b2b_us=b2b, ctas=ctas[0], registers=regs,
               spills=spills, ok=err == 0 and narrow.within_bound(bound, ms))
    log('2.5-D block=%-5d %.4f ms  share %.3f of %.4f ms (bytes)  back to '
        'back %.2f us  %d CTAs  regs %d, spills %d B  max err %g  %s' % (
            block, ms, bound / ms, bound, b2b, ctas[0], regs, spills, err,
            'PASS' if row['ok'] else 'WRONG' if err else 'OVER ITS BOUND'))
  if device.type == 'cuda':
    plain_ms = profiling.cuda_times_ms(
        lambda: layout25d.jacobi25d_plain(x), reps=1, warmup=0)[0]
    for row in rows:
      row.update(plain_ms=plain_ms, library_ms=None)
    log('2.5-D plain (whole grid, torch) %.3f ms; library: none (no single '
        'PyTorch call computes two sweeps with row-end wrap)' % plain_ms)
  return rows


def run_2d(device, log=print):
  """The port's jacobi2d kernel (``tile_size=(2048, 0)``) at each of
  JACOBI_BLOCK_ROWS through ``get_executor``: one launch a call, held to
  its whole-grid plain version by the reference's rule; on the card its
  cold-L2 ms, share of ``profiling.bound_ms`` (at most
  narrow.MAX_SHARE), back-to-back µs, registers and spills, and the plain
  version's time. Returns a row per configuration."""
  from soda_tpu_torch.model.compiled import compiled_stats
  shape = JACOBI_SHAPE if device.type == 'cuda' else CPU_JACOBI_SHAPE
  stencil = corpus.build('jacobi2d', tile_size=JACOBI_TILE)
  inputs = reference.make_test_inputs(stencil, shape)
  rows = []
  for block_rows in JACOBI_BLOCK_ROWS:
    opts = {} if block_rows is None else {'block_rows': block_rows}
    ex = soda_tpu_torch.get_executor(stencil, shape, 'fused', device=device,
                                     **opts)
    args = ex.prepare(inputs)
    ex.launches = 0
    got = dict(zip(stencil.output_names, ex.fn(*args)))
    launches = ex.launches
    want = dict(zip(stencil.output_names, fused_stencil_plain(stencil, args)))
    err = testing.check_outputs(stencil, shape, got, want, '2-D jacobi2d')
    tag = '2-D    block_rows=%s' % (block_rows or 'default')
    # (check_outputs raised on a mismatch; the plain path launches none)
    row = {'case': tag, 'ok': launches == (device.type == 'cuda'),
           'launches': launches,
           'abs_err': err, 'tile': ex.plan.tile}
    rows.append(row)
    if device.type == 'cpu':
      log('%s %s: plain == whole-grid plain (max |err| %.3g)' % (tag, shape,
                                                                 err))
      continue
    ms = statistics.median(profiling.cuda_times_ms(lambda: ex.fn(*args)))
    _, b2b = profiling.back_to_back_us(lambda: ex.fn(*args))
    bound, _ = profiling.bound_ms(stencil, shape)
    kernel = compiled_stats(ex)['kernels'][0]
    plain_ms = profiling.cuda_times_ms(
        lambda: fused_stencil_plain(stencil, args), reps=1, warmup=0)[0]
    row.update(ms=ms, b2b_us=b2b, bound_ms=bound, plain_ms=plain_ms,
               library_ms=None, ok=launches == 1 and
               narrow.within_bound(bound, ms),
               registers=kernel['registers'],
               spills=kernel['spill_stores'] + kernel['spill_loads'])
    log('%s %.4f ms  share %.3f of %.4f ms (bytes)  back to back %.2f us  '
        'tile %s, %d CTAs  regs %d, spills %d B  plain %.3f ms  max err %.3g  '
        '%d launch' % (tag, ms, bound / ms, bound, b2b, ex.plan.tile,
                       ex.plan.n_ctas, row['registers'], row['spills'],
                       plain_ms, err, launches))
  return rows


def run(device='cuda', log=print):
  device = probes._device(device)
  return ([correctness(device, log)] + run_25d(device, log) +
          run_2d(device, log))


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv)
  return probes.entry(lambda: run(args.device))


if __name__ == '__main__':
  sys.exit(main())
