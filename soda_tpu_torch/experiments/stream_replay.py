"""The streaming probe timed on the device alone.

The 13 cases of exp27 and exp30 (``probes.EXP27_CASES + EXP30_CASES``)
each move a 256^3 float32 array (64 MiB in, 64 MiB out) in about 50 µs,
as long as the host takes to enqueue a call (``probes.stream_probe``: its
checks, an occupancy lookup, a tensor, a ctypes call). Timed from Python,
cold (``profiling.cuda_times_ms``) or back to back, such a call reads the
host as much as the card. So each case is timed here with no host
between its calls: ``profiling.settle``, then ``profiling.replay_us``
(200 calls recorded in one CUDA graph, replayed twice back to back) in
turns, ``ORDER``: the old kernel (``stream_probe(..., _old=True)``), the
default kernel, the default, the old, then its library call
``torch.add(x, 1.0, out=y)``, which reads every input byte once and
writes every output byte once too. At 128 MiB a call every replay still
streams from device memory (the L2 holds 50 MB). Beside each time: its
share of the byte bound (``probes.stream_bound_ms``), the CTAs it ran on
and the CTAs an SM holds, and µs per step per CTA. ``--whole-rounds`` runs each case on as many seeded random
tiles as its CTAs walk in whole rounds (``whole_rounds``: 4752 tiles
of 16 KiB for loop db's 792 CTAs, where the scripts' 4096 leave 656
CTAs idle in the last round), beside the same library call. Before its
times each case's kernels are held bit for bit to ``stream_probe_plain``
(walking each kernel's own CTAs) and to x + 1. These launches and the
timed ones are not counted in ``probes.LAUNCHES``.

``--sass`` first prints, for every entry of ``csrc/probe_stream.cu``,
its registers and spills (``build.ptxas_report``) and its copy
instructions as ``cuobjdump -sass`` gives them, and fails unless every
bulk-kernel entry issues bulk copies (UBLKCP) and no per-thread
``cp.async`` (LDGSTS), and the old kernel the reverse.

    python -m soda_tpu_torch.experiments.stream_replay [--sass]
        [--order old,new,new,old,library] [--n 256] [--whole-rounds]
        [--json FILE] [CASE ...]

On the card only: it exits 1 without one, or when a kernel differs from
its plain version or from x + 1, or when the SASS check fails. One line
per case.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
from typing import Callable, Dict, List, Sequence

import torch

from soda_tpu_torch import profiling, utils
from soda_tpu_torch.experiments import probes

CASES = probes.EXP27_CASES + probes.EXP30_CASES
ORDER = ('old', 'new', 'new', 'old', 'library')
KINDS = ('old', 'new', 'library')
CALLS = 200  # calls a replayed graph holds
REPLAYS = 2  # replays of the graph a time spans
SETTLE_S = 0.1  # seconds of a case's own work before its first time
# an entry of the source: the kernel ('kernel' the old one, 'bulk') and
# its template arguments (kind, depth, split) in its mangled name
_ENTRY = re.compile(r'probe_stream_(kernel|bulk)ILi(\d)ELi(\d)ELi(\d)E')
# the SASS opcodes of a per-thread cp.async and of a bulk copy
LDGSTS, UBLKCP = 'LDGSTS', 'UBLKCP'


def _case(name: str) -> probes.StreamCase:
  for case in CASES:
    if case.name == name:
      return case
  raise utils.InputError('unknown case %r (of %s)' % (
      name, ', '.join(c.name for c in CASES)))


def _old(kind: str) -> bool:
  """``stream_probe``'s private ``_old`` for a kernel kind."""
  if kind not in ('old', 'new'):
    raise utils.InputError('unknown kernel %r (old or new)' % kind)
  return kind == 'old'


def call(case: probes.StreamCase, x: torch.Tensor, kind: str,
         y: torch.Tensor) -> Callable[[], torch.Tensor]:
  """One uncounted call of ``kind`` on ``x``: a kernel kind, or
  'library', ``torch.add`` into ``y``."""
  if kind == 'library':
    return lambda: torch.add(x, 1.0, out=y)
  old = _old(kind)

  def run():
    before = probes.LAUNCHES.copy()
    out = probes.stream_probe(x, *case.args, _old=old)
    probes.LAUNCHES.clear()
    probes.LAUNCHES.update(before)
    return out

  return run


def resident(case: probes.StreamCase, kind: str, device) -> int:
  """CTAs an SM holds of ``kind``'s kernel."""
  return probes.stream_resident(*case.args, device, old=_old(kind)) // (
      torch.cuda.get_device_properties(device).multi_processor_count)


def check(case: probes.StreamCase, x: torch.Tensor, kinds: Sequence[str]
          ) -> Dict[str, bool]:
  """Whether each kernel kind's output equals x + 1 and the plain walk
  over that kernel's CTAs, bit for bit."""
  want = x + 1
  tiles = x.numel() // probes._tile_floats(case.blk)
  plains: Dict[int, torch.Tensor] = {}
  out = {}
  for kind in kinds:
    ctas = probes.stream_ctas(*case.args, tiles, x.device, old=_old(kind))
    if ctas not in plains:
      plains[ctas] = probes.stream_probe_plain(x, *case.args, ctas=ctas)
    got = call(case, x, kind, want)()
    out[kind] = (torch.equal(got, want) and
                 torch.equal(got, plains[ctas]))
  return out


def times_us(case: probes.StreamCase, x: torch.Tensor,
             order: Sequence[str] = ORDER, calls: int = CALLS
             ) -> Dict[str, List[float]]:
  """Device µs a call of each kind in ``order``, replayed back to back,
  after ``SETTLE_S`` seconds of the first kind's calls."""
  y = torch.empty_like(x)
  out: Dict[str, List[float]] = collections.defaultdict(list)
  profiling.settle(call(case, x, order[0], y), SETTLE_S)
  for kind in order:
    out[kind].append(profiling.replay_us(call(case, x, kind, y),
                                         calls=calls, replays=REPLAYS))
  return dict(out)


def whole_rounds(case: probes.StreamCase, tiles: int, device) -> int:
  """The fewest tiles, at least ``tiles``, that the default kernel's
  CTAs walk in whole rounds (every CTA as many tiles as the busiest)."""
  ctas = probes.stream_ctas(*case.args, tiles, device)
  return ctas * probes.steps_per_cta(tiles, ctas, case.kind, case.depth)


def run(cases: Sequence[probes.StreamCase] = CASES, order: Sequence[str] =
        ORDER, n: int = 256, rounds: bool = False,
        log: Callable[[str], None] = print) -> List[Dict[str, object]]:
  """Each case on the scripts' input at ``n`` (``rounds``: on seeded
  random tiles made on the card, as many as ``whole_rounds`` of the
  scripts'): its kernels held to the plain walk and x + 1, then timed
  (``times_us``) beside the bound. One line per case; returns a row per
  case."""
  for kind in order:
    if kind not in KINDS:
      raise utils.InputError('unknown kind %r (of %s)' % (
          kind, ', '.join(KINDS)))
  device = probes._device('cuda')
  smi = profiling.nvidia_smi_line()
  cube = probes.stream_input(n, device)
  kernels = sorted({k for k in order if k != 'library'}, key=KINDS.index)
  rows = []
  for case in cases:
    size = probes._tile_floats(case.blk)
    x = cube
    if rounds:
      gen = torch.Generator(device=device).manual_seed(0)
      x = torch.randn(whole_rounds(case, cube.numel() // size, device) * size,
                      generator=gen, device=device)
    tiles = x.numel() // size
    bound_us = probes.stream_bound_ms(x) * 1e3
    equal = check(case, x, kernels)
    us = times_us(case, x, order)
    best = {k: min(v) for k, v in us.items()}
    ctas, per_sm, steps = {}, {}, {}
    for kind in kernels:
      ctas[kind] = probes.stream_ctas(*case.args, tiles, device,
                                      old=_old(kind))
      per_sm[kind] = resident(case, kind, device)
      steps[kind] = probes.steps_per_cta(tiles, ctas[kind], case.kind,
                                         case.depth)
    row = {'case': case.name, 'kind': case.kind, 'blk': case.blk,
           'split': case.split, 'depth': case.depth, 'n': n, 'tiles': tiles,
           'us': us, 'bound_us': bound_us, 'equal': equal,
           'ok': all(equal.values()), 'ctas': ctas, 'ctas_per_sm': per_sm,
           'steps': steps,
           'step_us': {k: best[k] / steps[k] for k in kernels},
           'share': {k: bound_us / v for k, v in best.items()},
           'card': smi}
    if 'library' in best:
      row['over_library'] = {k: v / best['library'] for k, v in best.items()
                             if k != 'library'}
    rows.append(row)
    log('%-18s %s  bound %.2f us (%d tiles)  share %s | %s | CTAs %s | per '
        'step %s | %s' % (
            case.name, '  '.join('%s %s' % (k, '/'.join(
                '%.3f' % t for t in us[k])) for k in KINDS if k in us),
            bound_us, tiles, ' '.join('%s %.3f' % (k, row['share'][k])
                                      for k in KINDS if k in best),
            ' '.join('%s/library %.3f' % (k, r) for k, r in sorted(
                row.get('over_library', {}).items())),
            ' '.join('%s %d (%d/SM)' % (k, ctas[k], per_sm[k])
                     for k in kernels),
            ' '.join('%s %.3f us x %d' % (k, row['step_us'][k], steps[k])
                     for k in kernels),
            'bit for bit' if row['ok'] else 'DIFFERS %s' % equal))
  return rows


def sass_rows() -> List[Dict[str, object]]:
  """Each entry of the source as built: the kernel ('old' or 'bulk'),
  kind, depth, split, registers, spilled bytes, and the
  count of each copy opcode (LDGSTS and UBLKCP, with their modifiers)."""
  from soda_tpu_torch.backend import build
  from soda_tpu_torch.experiments import narrow
  source = build.csrc_source(probes.SOURCES[0])
  listings = narrow.parse_listing(narrow.cuobjdump_sass(source))
  ptxas = build.ptxas_report(source)
  rows = []
  for entry, listing in sorted(listings.items()):
    found = _ENTRY.search(entry)
    if not found:
      continue
    kind, depth, split = (int(found.group(i)) for i in (2, 3, 4))
    regs = ptxas.get(entry, {})
    ops = collections.Counter(op for _, op, _ in listing
                              if op.split('.')[0] in (LDGSTS, UBLKCP))
    rows.append({
        'kernel': 'old' if found.group(1) == 'kernel' else 'bulk',
        'kind': [k for k, v in probes.KINDS.items() if v == kind][0],
        'depth': depth, 'split': split,
        'registers': regs.get('registers'),
        'spills': regs.get('spill_stores', 0) + regs.get('spill_loads', 0),
        'ops': dict(ops), 'opcodes': sorted({op for _, op, _ in listing})})
  return rows


def sass_ok(row: Dict[str, object]) -> bool:
  """An old entry copies by LDGSTS alone, a bulk entry by UBLKCP alone."""
  kinds = {op.split('.')[0] for op in row['ops']}
  return kinds == ({LDGSTS} if row['kernel'] == 'old' else {UBLKCP})


def sass_check(log: Callable[[str], None] = print) -> List[Dict[str, object]]:
  """``sass_rows`` with one line per kernel (the registers'
  range, spills, copy opcodes), and the opcodes the bulk entries have
  that no old entry has; raises RuntimeError unless every entry is
  ``sass_ok`` and none spills."""
  rows = sass_rows()
  old_ops = set().union(*[r['opcodes'] for r in rows
                          if r['kernel'] == 'old'])
  for kernel in ('old', 'bulk'):
    mine = [r for r in rows if r['kernel'] == kernel]
    if not mine:
      continue
    ops = collections.Counter()
    for r in mine:
      ops.update(r['ops'])
    log('%-8s %d entries: registers %d-%d, spills %d B; copy opcodes %s%s' % (
        kernel, len(mine), min(r['registers'] or 0 for r in mine),
        max(r['registers'] or 0 for r in mine),
        sum(r['spills'] for r in mine),
        ' '.join('%s %d' % kv for kv in sorted(ops.items())) or 'none',
        '' if kernel == 'old' else '; opcodes no old entry has: %s' % ' '.join(
            sorted(set().union(*[r['opcodes'] for r in mine]) - old_ops))))
  bad = [(r['kernel'], r['kind'], r['depth'], r['split'], r['ops'])
         for r in rows if not sass_ok(r) or r['spills']]
  if bad or len(rows) != 2 * 4 * 3 * 2:
    raise RuntimeError('stream probe: %d entries; copies not as designed or '
                       'spilling in %s' % (len(rows), bad))
  return rows


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--order', default=','.join(ORDER),
                      help='kinds in turn, of %s (default %s)' % (
                          ', '.join(KINDS), ','.join(ORDER)))
  parser.add_argument('--n', type=int, default=256,
                      help='grid edge (default 256, the scripts\')')
  parser.add_argument('--whole-rounds', action='store_true',
                      help='each case on seeded random tiles, as many as '
                      'its CTAs walk in whole rounds (at least the '
                      'scripts\' input): no CTA idles in a last round')
  parser.add_argument('--sass', action='store_true',
                      help='the SASS and ptxas check of every entry first')
  parser.add_argument('--json', default=None,
                      help='write the rows (and the SASS rows) here')
  parser.add_argument('cases', nargs='*',
                      help='case names (default: all 13)')
  args = parser.parse_args(argv)
  try:
    cases = tuple(_case(n) for n in args.cases) or CASES
    sass = sass_check() if args.sass else []
    rows = run(cases, args.order.split(','), args.n, args.whole_rounds)
  except utils.InputError as err:
    print('error: %s' % err, file=sys.stderr)
    return 1
  if args.json:
    with open(args.json, 'w') as f:
      json.dump({'rows': rows, 'sass': sass}, f, indent=1)
  return 0 if all(row['ok'] for row in rows) else 1


if __name__ == '__main__':
  sys.exit(main())
