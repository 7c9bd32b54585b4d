"""exp9's 2.5-D jacobi timed on the device alone.

At (8192, 16, 128) float32 each block's kernel moves 64 MiB in and 64 MiB
out in 50-95 µs, about as long as the host takes to enqueue a call
(``layout25d.jacobi25d``: its checks, a tensor, a ctypes call, for the
new kernel two tensor maps), so a time taken from Python reads the host
too. Here each block (``layout25d.BLOCKS``) is timed with no host between
its calls: both kernels (``KINDS``: the old one, ``_old=True``, and the
new bulk kernel, the default) first held bit for bit to
``jacobi25d_plain`` on rows [2, h-2) (on ``grid_input``'s seeded data),
then ``profiling.settle``, then ``profiling.replay_us`` (200 calls
recorded in one CUDA graph, replayed twice back to back) in turns,
``ORDER``: old, new, new, old.
Then two yardsticks the same way, neither the same function, so neither
is a library time: the port's jacobi2d default kernel at
``exp9_layout25d.JACOBI_SHAPE`` (the script's own comparison: the same
two sweeps, the corpus's border in place of the wrap) and
``torch.add(x, 1.0, out=y)`` on the same 64 MiB (a pure stream of the
same bytes). At 128 MiB a call every replay streams from device memory
(the L2 holds 50 MB). Beside each time: its share of
``layout25d.bound_ms``; each timed kernel's CTAs, CTAs an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), warps and ring
depth, registers and spills. These launches are not counted in
``probes.LAUNCHES``.

``--sass`` first prints, for each entry of ``csrc/probe_25d.cu``, its
registers and spills (``build.ptxas_report``), its copy, shared-load and
shuffle instructions as ``cuobjdump -sass`` gives them, and fails unless
the old entry copies by per-thread ``cp.async`` (LDGSTS) alone and the
new one by bulk tensor copies (UTMALDG) alone. The new entry's shared
loads are one tile's a lane (its tile's rows are straight-line code, its
walk over tiles a loop); the old entry's are its loop bodies'.

    python -m soda_tpu_torch.experiments.layout25d_replay [--sass]
        [--order old,new,new,old] [--json FILE] [BLOCK ...]

On the card only: it exits 1 without one, or when a kernel differs from
the plain version, or when the SASS check fails. One line per block,
then one for the yardsticks.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Callable, Dict, List, Sequence

import torch

from soda_tpu_torch import profiling, utils
from soda_tpu_torch.experiments import layout25d, probes

KINDS = tuple(layout25d.KINDS)  # the old kernel, the new one
ORDER = ('old', 'new', 'new', 'old')
CALLS = 200  # calls a replayed graph holds
REPLAYS = 2  # replays of the graph a time spans
SETTLE_S = 0.2  # seconds of a block's own work before its first time
# the SASS opcodes of a per-thread cp.async, a bulk copy, a tensor copy,
# a shared load and a shuffle
LDGSTS, UBLKCP, UTMALDG, LDS, SHFL = ('LDGSTS', 'UBLKCP', 'UTMALDG', 'LDS',
                                      'SHFL')
COPIES = (LDGSTS, UBLKCP, UTMALDG)
# the copies each kernel's entry issues, and no other
COPIES_OF = {'old': {LDGSTS}, 'new': {UTMALDG}}


def _check_kind(kind: str) -> str:
  if kind not in KINDS:
    raise utils.InputError('unknown kernel %r (of %s)' % (
        kind, ', '.join(KINDS)))
  return kind


def call(x: torch.Tensor, block: int, kind: str) -> Callable[[], object]:
  """One uncounted call of ``kind``'s kernel on ``x``."""
  old = _check_kind(kind) == 'old'

  def run():
    before = probes.LAUNCHES.copy()
    out = layout25d.jacobi25d(x, block, _old=old)
    probes.LAUNCHES.clear()
    probes.LAUNCHES.update(before)
    return out

  return run


def check(x: torch.Tensor, block: int, kinds: Sequence[str] = KINDS
          ) -> Dict[str, bool]:
  """Whether each kernel's rows [2, h-2) equal the whole-grid function's
  bit for bit (every kernel, timed or not)."""
  want = layout25d.stored(layout25d.jacobi25d_plain(x))
  return {kind: torch.equal(layout25d.stored(call(x, block, kind)()), want)
          for kind in kinds}


def times_us(fns: Dict[str, Callable[[], object]], order: Sequence[str]
             ) -> Dict[str, List[float]]:
  """Device µs a call of each of ``fns`` in ``order``, replayed back to
  back, after ``SETTLE_S`` seconds of the first one's calls."""
  out: Dict[str, List[float]] = collections.defaultdict(list)
  profiling.settle(fns[order[0]], SETTLE_S)
  for kind in order:
    out[kind].append(profiling.replay_us(fns[kind], calls=CALLS,
                                         replays=REPLAYS))
  return dict(out)


def yardsticks(x: torch.Tensor, order: Sequence[str] = ('jacobi2d', 'add',
                                                        'add', 'jacobi2d')
               ) -> Dict[str, List[float]]:
  """Device µs a call of the port's jacobi2d default kernel at the
  script's 2-D grid and of ``torch.add(x, 1.0, out=y)`` on ``x``,
  replayed in turns."""
  import soda_tpu_torch
  from soda_tpu_torch import corpus
  from soda_tpu_torch.backend import reference
  from soda_tpu_torch.experiments import exp9_layout25d
  shape = exp9_layout25d.JACOBI_SHAPE
  stencil = corpus.build('jacobi2d', tile_size=exp9_layout25d.JACOBI_TILE)
  ex = soda_tpu_torch.get_executor(stencil, shape, 'fused', device=x.device)
  args = ex.prepare(reference.make_test_inputs(stencil, shape))
  y = torch.empty_like(x)
  return times_us({'jacobi2d': lambda: ex.fn(*args),
                   'add': lambda: torch.add(x, 1.0, out=y)}, order)


def run(blocks: Sequence[int] = layout25d.BLOCKS, order: Sequence[str] =
        ORDER, log: Callable[[str], None] = print) -> List[Dict[str, object]]:
  """Each block at ``layout25d.SHAPE``: its kernels held to the plain
  version, then timed (``times_us``) beside the bound; then the
  yardsticks. One line per block and per yardstick; returns a row per
  block, then one row of the yardsticks."""
  for kind in order:
    _check_kind(kind)
  device = probes._device('cuda')
  smi = profiling.nvidia_smi_line()
  x = layout25d.grid_input(layout25d.SHAPE, device)
  bound_us = layout25d.bound_ms(layout25d.SHAPE) * 1e3
  kinds = sorted(set(order), key=KINDS.index)
  stats = {kind: layout25d.kernel_stats(kind) for kind in kinds}
  rows = []
  for block in blocks:
    equal = check(x, block)
    us = times_us({kind: call(x, block, kind) for kind in kinds}, order)
    best = {k: min(v) for k, v in us.items()}
    grid = {kind: layout25d.launch_config(layout25d.SHAPE, block, device,
                                          kind) for kind in kinds}
    row = {'case': '2.5-D block %d' % block, 'block': block, 'us': us,
           'bound_us': bound_us, 'equal': equal, 'ok': all(equal.values()),
           'share': {k: bound_us / v for k, v in best.items()},
           'grid': grid, 'stats': stats, 'card': smi}
    if 'old' in best:
      row['over_old'] = {k: v / best['old'] for k, v in best.items()
                         if k != 'old'}
    rows.append(row)
    log('2.5-D block=%-5d %s  bound %.2f us  share %s | %s | %s' % (
        block, '  '.join('%s %s' % (k, '/'.join('%.3f' % t for t in us[k]))
                         for k in KINDS if k in us), bound_us,
        ' '.join('%s %.3f' % (k, row['share'][k]) for k in KINDS
                 if k in best),
        ' '.join('%s %d CTAs (%d/SM, %d warps, depth %d; regs %d, spills %d '
                 'B)' % (k, grid[k]['ctas'], grid[k]['per_sm'],
                         grid[k]['warps'], grid[k]['depth'],
                         stats[k]['registers'], stats[k]['spills'])
                 for k in kinds),
        'bit for bit' if row['ok'] else 'DIFFERS %s' % equal))
  sticks = yardsticks(x)
  best = {k: min(v) for k, v in sticks.items()}
  rows.append({'case': 'yardsticks', 'us': sticks, 'bound_us': bound_us,
               'share': {k: bound_us / v for k, v in best.items()},
               'ok': True, 'card': smi})
  log('yardsticks: jacobi2d default kernel at %s %s us (share %.3f); '
      'torch.add(x, 1.0, out=y) on the same 64 MiB %s us (share %.3f); '
      'library: none (no PyTorch call computes two sweeps with row-end '
      'wrap) | %s' % (
          'x'.join(map(str, (layout25d.SHAPE[0], layout25d.SHAPE[1] *
                             layout25d.SHAPE[2]))),
          '/'.join('%.3f' % t for t in sticks['jacobi2d']),
          bound_us / best['jacobi2d'],
          '/'.join('%.3f' % t for t in sticks['add']),
          bound_us / best['add'], smi))
  return rows


def sass_rows() -> Dict[str, Dict[str, object]]:
  """Each entry of the source as built (``KINDS``): registers, spilled
  bytes, the count of each copy, shared-load and shuffle opcode (with
  its modifiers)."""
  from soda_tpu_torch.backend import build
  from soda_tpu_torch.experiments import narrow
  source = build.csrc_source(layout25d.SOURCE)
  listings = narrow.parse_listing(narrow.cuobjdump_sass(source))
  out = {}
  for kind in KINDS:
    listing = layout25d.entry_of(listings, kind)
    ops = collections.Counter(op for _, op, _ in listing
                              if op.split('.')[0] in COPIES + (LDS, SHFL))
    out[kind] = dict(layout25d.kernel_stats(kind), ops=dict(ops))
  return out


def sass_ok(kind: str, row: Dict[str, object]) -> bool:
  """The old entry copies by LDGSTS alone, the new one by UTMALDG
  alone."""
  return {op.split('.')[0] for op in row['ops']} & set(COPIES) == \
      COPIES_OF[kind]


def count(row: Dict[str, object], opcode: str) -> int:
  return sum(n for op, n in row['ops'].items()
             if op.split('.')[0] == opcode)


def sass_check(log: Callable[[str], None] = print
               ) -> Dict[str, Dict[str, object]]:
  """``sass_rows`` with one line per entry; raises RuntimeError unless
  each is ``sass_ok`` and none spills."""
  rows = sass_rows()
  for kind, row in rows.items():
    log('%-4s %s: registers %d, spills %d B; copies %s; shared loads %d (%s)%s;'
        ' shuffles %d; %.3f shared accesses an output by the source' % (
            kind, layout25d.ENTRIES[kind], row['registers'], row['spills'],
            ' '.join('%s %d' % kv for kv in sorted(row['ops'].items())
                     if kv[0].split('.')[0] in COPIES) or 'none',
            count(row, LDS), ' '.join('%s %d' % kv for kv in sorted(
                row['ops'].items()) if kv[0].split('.')[0] == LDS),
            ' in its loop bodies' if kind == 'old' else ' a tile a lane',
            count(row, SHFL),
            layout25d.shared_accesses_per_output(kind == 'old')))
  bad = [(kind, row['ops']) for kind, row in rows.items()
         if not sass_ok(kind, row) or row['spills']]
  if bad:
    raise RuntimeError('2.5-D jacobi: copies not as designed or spilling in '
                       '%s' % bad)
  return rows


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--order', default=','.join(ORDER),
                      help='kernels in turn, of %s (default %s)' % (
                          ', '.join(KINDS), ','.join(ORDER)))
  parser.add_argument('--sass', action='store_true',
                      help='the SASS and ptxas check of both entries first')
  parser.add_argument('--json', default=None,
                      help='write the rows (and the SASS rows) here')
  parser.add_argument('blocks', nargs='*', type=int,
                      help='blocks (default: %s)' % ' '.join(
                          map(str, layout25d.BLOCKS)))
  args = parser.parse_args(argv)
  try:
    probes._device('cuda')
    sass = sass_check() if args.sass else {}
    rows = run(tuple(args.blocks) or layout25d.BLOCKS,
               args.order.split(','))
  except utils.InputError as err:
    print('error: %s' % err, file=sys.stderr)
    return 1
  if args.json:
    with open(args.json, 'w') as f:
      json.dump({'rows': rows, 'sass': sass}, f, indent=1)
  return 0 if all(row['ok'] for row in rows) else 1


if __name__ == '__main__':
  sys.exit(main())
