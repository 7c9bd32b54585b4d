"""The chain probes' cluster kernels beside their grid-barrier forms.

exp24's bodies whose cross taps or chunks no CTA holds alone run, on
the card, in one thread-block cluster: ``strip_cluster``
(``csrc/probe_narrow.cu``: indep10, one independent phase with cross
taps) and ``chain_chunk_cluster`` (``csrc/probe_chain.cu``: chunk32,
chunk64x512). Their old kernels stay behind ``_old=True``: the strip
kernel with a grid barrier a phase and the first ``chain_chunk``. (Bodies
of chained phases, exp24's roll10 and exp16's, stay on the strip kernel:
on a cluster's 16 SMs they ran slower.)
Each body here: its kernel bit for bit against its plain version at
``probes.CHECK_ITERS`` and ``n_small`` iterations and against its old
kernel at ``n_small``; µs an iteration as slopes between ``n_small`` and
``n_big`` (``probes.slope_us``; the host's enqueue cancels) in turns old,
new, new, old; grid and cluster barriers an iteration, CTAs and cluster
size, registers and spills, and the bound's share on the card's SMs and
on the cluster's. ``sass_check``: the cluster barrier's opcodes in every
cluster entry, none of the grid barrier's there, no divergent branch, no
spilled bytes.

    python -m soda_tpu_torch.experiments.cluster_chain [--sass]
        [--n-small 64] [--n-big 2048]

On the card only (the default ``cuda`` exits 1 without one).
"""

from __future__ import annotations

import collections
import statistics
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from soda_tpu_torch import profiling, utils
from soda_tpu_torch.experiments import narrow, probes

ORDER = ('old', 'new', 'new', 'old')
N_SMALL, N_BIG = 64, 2048
# the SASS of barrier.cluster arrive and wait (cuobjdump -sass of the
# cluster entries on an H100, CUDA 12.8), and of what a cooperative
# grid.sync compiles to in the old entries: an atomic add on the barrier
# word and strong loads polling it (MEMBAR.ALL.GPU and CCTL.IVALL come
# with both: the cluster barrier's release and acquire compile to them
# too); a shuffle behind a convergence check branches on BRA.DIV
CLUSTER_OPS = ('UCGABAR_ARV', 'UCGABAR_WAIT')
GRID_SYNC_OPS = ('ATOM.E.ADD.STRONG.GPU', 'LD.E.STRONG.GPU')


# exp24's bodies on the cluster kernels (probes.ChainBody)
CASES = tuple(probes.CHAIN_BODIES[name]
              for name in ('indep10', 'chunk32', 'chunk64x512'))


def kernel(body: probes.ChainBody) -> str:
  """Its cluster kernel's name in the source."""
  return 'chain_chunk_cluster' if body.form == 'chunk' else narrow.CLUSTER


def call(body: probes.ChainBody, x: torch.Tensor, n: int, old: bool,
         ctas: Optional[List[int]] = None) -> torch.Tensor:
  """One launch of the body's cluster kernel (``old``: its old kernel)."""
  return probes.chain_probe(x, body, n, ctas, _old=old)


def check(body: probes.ChainBody, x: torch.Tensor, n_small: int
          ) -> Tuple[bool, int]:
  """(whether the cluster kernel equals the plain version bit for bit at
  CHECK_ITERS and n_small iterations, and its old kernel at n_small;
  the cluster kernel's CTAs)."""
  ctas: List[int] = []
  same = all(torch.equal(call(body, x, n, False, ctas),
                         probes.chain_probe_plain(x, body, n))
             for n in probes.CHECK_ITERS + (n_small,))
  same = same and torch.equal(call(body, x, n_small, False),
                              call(body, x, n_small, True))
  return same, ctas[0]


def entry_of(body: probes.ChainBody, listings) -> Tuple[str, str]:
  """(new, old) mangled entry names of the body's kernels."""
  if body.form == 'chunk':
    k, w = body.chunk
    new = [e for e in listings if 'chain_chunk_cluster' in e and
           'ILi%dELi%dE' % (k // 2, w) in e]  # (bands of half a chunk)
    old = [e for e in listings if '11chain_chunkILi%dELi%dE' % (k, w) in e]
  else:
    strip = narrow.EXP24_SHIFT[body.name]
    op = '%d%s' % (len(strip.op), strip.op)
    form = 'ILi%dELi%dE' % narrow.CLUSTER_FORMS[strip.op]
    new = [e for e in listings if '13strip_cluster' in e and form in e]
    old = [e for e in listings if '5stripI' in e and op in e]
  if len(new) != 1 or len(old) != 1:
    raise RuntimeError('cluster chain %s: %d new and %d old entries' % (
        body.name, len(new), len(old)))
  return new[0], old[0]


def sass_rows() -> List[Dict[str, object]]:
  """Per body: its new and old entries' opcode counts (with modifiers:
  BRA.DIV apart from BRA), registers and spills."""
  from soda_tpu_torch.backend import build
  out = []
  reports = {}
  for source in (narrow.SOURCE, probes.SOURCES[1]):
    ks = build.csrc_source(source)
    reports[source] = (narrow.parse_listing(narrow.cuobjdump_sass(ks)),
                       build.ptxas_report(ks))
  for body in CASES:
    source = (probes.SOURCES[1] if kernel(body) == 'chain_chunk_cluster'
              else narrow.SOURCE)
    listings, ptxas = reports[source]
    row = {'case': body.name}
    for kind, entry in zip(('new', 'old'), entry_of(body, listings)):
      ops = collections.Counter(op for _, op, _ in listings[entry])
      base = collections.Counter(op.split('.')[0] for _, op, _ in
                                 listings[entry])
      row[kind] = {'entry': entry, 'ops': ops, 'base': base,
                   'registers': ptxas[entry]['registers'],
                   'spills': ptxas[entry]['spill_stores'] +
                             ptxas[entry]['spill_loads']}
    out.append(row)
  return out


def sass_ok(row: Dict[str, object]) -> bool:
  """The cluster entry arrives at and waits on the cluster barrier, has
  none of the grid sync's opcodes, no divergent branch and no spilled
  bytes; the old entry has the grid sync's atomic."""
  new, old = row['new'], row['old']
  return (all(new['base'][op] for op in CLUSTER_OPS) and
          not any(new['ops'][op] for op in GRID_SYNC_OPS) and
          not new['ops']['BRA.DIV'] and not new['spills'] and
          all(old['ops'][op] for op in GRID_SYNC_OPS))


def sass_check(log: Callable[[str], None] = print
               ) -> List[Dict[str, object]]:
  """``sass_rows``, one line a body (registers, spills, the cluster and
  grid opcodes of each entry, the opcodes one has and the other not);
  raises RuntimeError unless every row is ``sass_ok``."""
  rows = sass_rows()
  for row in rows:
    new, old = row['new'], row['old']

    def ops(r):
      return ' '.join(['%s %d' % (k, r['base'][k]) for k in CLUSTER_OPS] +
                      ['%s %d' % (k, r['ops'][k]) for k in GRID_SYNC_OPS])

    log('%-22s new: regs %d, spills %d B, %s, BRA.DIV %d; old: regs %d, '
        'spills %d B, %s; opcodes the new entry alone has: %s; the old '
        'alone: %s' % (
            row['case'], new['registers'], new['spills'], ops(new),
            new['ops']['BRA.DIV'], old['registers'], old['spills'], ops(old),
            ' '.join(sorted(set(new['ops']) - set(old['ops']))) or 'none',
            ' '.join(sorted(set(old['ops']) - set(new['ops']))) or 'none'))
  bad = [row['case'] for row in rows if not sass_ok(row)]
  if bad:
    raise RuntimeError('cluster chain: SASS not as designed in %s' % bad)
  return rows


def run(cases: Sequence[probes.ChainBody] = CASES, n_small: int = N_SMALL,
        n_big: int = N_BIG, order: Sequence[str] = ORDER,
        log: Callable[[str], None] = print) -> List[Dict[str, object]]:
  """Each body on the card: ``check``, then its µs an iteration in the
  turns of ``order``, barriers, CTAs, the bound's shares. One line a
  body; a row each ('ok', 'us': kind -> readings, 'ctas', 'bound_ms',
  'barriers', 'old_barriers')."""
  device = probes._device('cuda')
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  clock_hz = profiling.max_sm_clock_hz()
  rows = []
  for case in cases:
    x = probes.chain_input(case.dtype, device)
    ok, ctas = check(case, x, n_small)
    us: Dict[str, List[float]] = {'old': [], 'new': []}
    for kind in order:
      us[kind].append(probes.slope_us(
          lambda n: call(case, x, n, kind == 'old'), n_small, n_big))
    bound = probes.chain_bound_ms(case.name, sms, clock_hz)[0]
    new = statistics.mean(us['new'])
    old = statistics.mean(us['old'])
    rows.append({'case': case.name, 'ok': ok, 'us': us, 'ctas': ctas,
                 'bound_ms': bound, 'barriers': case.barriers,
                 'old_barriers': case.old_barriers})
    log('%-22s %s  %s us/iter %s (new/old %.3f)  new: %d grid + %d cluster '
        'barriers/iter, %d CTAs (one cluster); old: %d grid barriers/iter  '
        'bound %.4f us, share %.4f (on the cluster\'s %d SMs %.3f)' % (
            case.name, 'bit for bit' if ok else 'WRONG',
            '/'.join(order), '/'.join(
                '%.3f' % us[k][order[:i].count(k)]
                for i, k in enumerate(order)), new / old,
            *case.barriers, ctas, case.old_barriers.grid, bound * 1e3,
            bound * 1e3 / new, ctas, bound * 1e3 * sms / ctas / new))
  return rows


def main(argv=None) -> int:
  import argparse
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--sass', action='store_true',
                      help='check the entries\' SASS first')
  parser.add_argument('--n-small', type=int, default=N_SMALL)
  parser.add_argument('--n-big', type=int, default=N_BIG)
  args = parser.parse_args(argv)
  try:
    probes._device('cuda')
  except utils.InputError as err:
    print('error: %s' % err, file=sys.stderr)
    return 1
  if args.sass:
    sass_check()
  rows = run(n_small=args.n_small, n_big=args.n_big)
  return 0 if all(row['ok'] for row in rows) else 1


if __name__ == '__main__':
  sys.exit(main())
