"""Experiment 32 on the H100: a shared-memory copy as a shift.

The port of experiments/exp32_dma_shift.py (its Pallas probes, _pallas
at :81, make_rot_chain at :153 and make_fan_chain at :226). Each case
runs n iterations in one launch on the script's (256, 1024) int32
block: a step stores v to slab a, copies a[d:d+CP] (rows, CP = 240, or
lanes, CP = 896) into slab b's start with the bulk-copy engine
(``cp.async.bulk`` shared::cta -> shared::cluster, ``mbarrier``
completion), waits, and takes v = min(v, b), b's tail stale. Controls:
store5 (store and reload, no copy) and the rotate baselines rot5_sub_d3
and rot5_lane_d8 (the threads' offset shared-memory reads, in the
narrow probe's strip kernel); dmaover5_d3 runs a register chain B
between each copy's issue and its wait; dmafan4_sub keeps four copies
in flight. See copyshift.copy_probe.

    python -m soda_tpu_torch.experiments.exp32_dma_shift [--device cpu]
        [--check] [--n-small 64] [--n-big 2048]

On the card each case prints µs per iteration (the slope between
n-small and n-big), ns per cell per step, the bound (shared-memory bytes
or operations) and its share, the plain version's time, the engine, the
largest error against the plain version at 1, 2, 5 and n-small
iterations and its kernel's registers, spills and main loop (the
overlap: chain B's instructions between the issue and the wait), then
the copy against the rotate at the same distance. ``--check`` runs the
script's check() cases instead (one distance an iteration, the fan, the
overlap, on its seed-7 block), checked at 3 iterations too.
``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import sys

import torch

from soda_tpu_torch import profiling
from soda_tpu_torch.experiments import copyshift, narrow, probes

N_SMALL, N_BIG = 64, 2048  # the script's slope (exp32_dma_shift.py:53)


def run(device='cuda', check=False, n_small=N_SMALL, n_big=N_BIG, log=print,
        reps=5):
  """The script's main() cases (``check``: its check() cases) on its
  block. A case fails where its kernel differs from its plain version or
  its share of the bound exceeds narrow.MAX_SHARE. Returns a row per
  case."""
  device = probes._device(device)
  cases = copyshift.CHECK_CASES if check else copyshift.MAIN_CASES
  x = copyshift.copy_input(7 if check else 0, device)
  cells = x.numel()
  rows = []
  if device.type == 'cuda':
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = profiling.max_sm_clock_hz()
  for case in cases:
    row = {'case': case.name, 'kind': case.kind, 'engine': case.engine}
    rows.append(row)
    if device.type == 'cpu':
      n = copyshift.CHECK_N if check else 1
      got = copyshift.copy_probe(case, x, n)
      row['ok'] = ok = tuple(got.shape) == copyshift.SHAPE and \
          got.dtype == x.dtype
      log('%-16s: plain %s (n=%d); on the card: %s' % (
          case.name, 'OK' if ok else 'WRONG', n, case.engine))
      continue
    ctas = []
    iters = ((copyshift.CHECK_N,) if check else ()) + probes.CHECK_ITERS + (
        n_small,)
    err = copyshift.copy_check(case, x, iters, ctas)
    us = probes.slope_us(lambda n: copyshift.copy_probe(case, x, n), n_small,
                         n_big, reps)
    bound, bound_by = copyshift.bound_ms(case, sms, clock_hz,
                                         tuple(x.shape))
    plain_ms = profiling.cuda_times_ms(
        lambda: copyshift.copy_plain(case, x, n_small), reps=1,
        warmup=0)[0] / n_small
    ok = err == 0 and narrow.within_bound(bound, us / 1e3)
    row.update(ok=ok, us=us, ms=us / 1e3, bound_ms=bound, bound_by=bound_by,
               plain_ms=plain_ms, library_ms=None, abs_err=err, ctas=ctas[0],
               ns_cell_step=us * 1e3 / cells / case.steps,
               sass=copyshift.sass_line(case))
    log('%-16s: %8.3f us/iter  %7.4f ns/cell/step  bound %.4f us (%s, '
        'share %.3f)  plain %.1f us/iter  %d CTAs  max err %g (n=%s)  %s  '
        '[%s]  %s' % (
            case.name, us, row['ns_cell_step'], bound * 1e3,
            'shared-memory bytes' if bound_by == 'bytes' else bound_by,
            bound * 1e3 / us, plain_ms * 1e3, ctas[0], err,
            ','.join(map(str, iters)), case.engine, row['sass'],
            'PASS' if ok else 'WRONG' if err else 'OVER ITS BOUND'))
  if device.type == 'cuda' and not check:
    us = {row['case']: row['us'] for row in rows}
    log('copy/rotate per iteration: sub d=3 %.2f, lane d=8 %.2f; overlap/'
        'copy (sub d=3) %.2f; fan per copy/copy step (sub d=3) %.2f' % (
            us['dma5_sub_d3'] / us['rot5_sub_d3'],
            us['dma5_lane_d8'] / us['rot5_lane_d8'],
            us['dmaover5_d3'] / us['dma5_sub_d3'],
            us['dmafan4_sub'] / 4 / (us['dma5_sub_d3'] / 5)))
  return rows


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv, ('--check',), chain=True,
                           n_small=N_SMALL, n_big=N_BIG)
  return probes.entry(lambda: run(args.device, args.check, args.n_small,
                                  args.n_big))


if __name__ == '__main__':
  sys.exit(main())
