"""Computation-reuse schedulers — the DAC'20 search engine family.

Rebuild of the scheduler half of
reference src/soda/optimization/computation_reuse.py (the pass
entry lives in soda_tpu_torch.optimization.computation_reuse). The object of
search is a **commutative schedule**: a binary tree over the operands
of a reduction (`+`/`min`/`max`), where structurally identical subtrees
(same *relative* offsets and coefficient payloads) are computed once
and reused at several offsets. Cost = (number of unique operations,
total reuse distance), the latter an LP over produce/consume offsets
(reference computation_reuse.py:573-624).

Scheduler family (dispatch in Expression.best_schedule, mirroring
reference :1838-1857):
  CommSchedules      exact search over binary trees (memoized, pruned)
  GreedySchedules    pairwise-reuse greedy with conflict-parity
                     handling, dimension-aligned filtering, top-5 beam
  BeamSchedules      same candidate generator with a wider per-level
                     beam (top-16) and a longer budget
  GloreSchedules     GLORE-style axis/diagonal direction grouping
  ExternalSchedules  subprocess C++ scheduler, JSON protocol
                     (same protocol as the reference's soda-cr binary)
"""

from __future__ import annotations

import collections
import heapq
import itertools
import json
import logging
import os
import shutil
import subprocess
import time
from functools import cached_property
from typing import (Any, Dict, FrozenSet, Iterator, List, Optional, Sequence,
                    Set, Tuple, Union)

import numpy as np

from soda_tpu_torch import utils
from soda_tpu_torch.ir import arithmetic, mutator, nodes as ir
from soda_tpu_torch.ir import visitor as soda_visitor
from soda_tpu_torch.optimization.computation_reuse import (Linearizer,
                                                           assemble_attr,
                                                           extract_attr)

_logger = logging.getLogger().getChild(__name__)

Payload = Union[int, None, 'CommSchedule']  # leaf coefficient id / subtree


def _neg(idx: Sequence[int]) -> Tuple[int, ...]:
  return tuple(-x for x in idx)


# The measured TPU shift prices of roll mode: a copy of the 'roll' row of
# SHIFT_COST in soda_tpu/model/estimate.py:61-62, kept here so that
# `cr-cost: tpu` ranks schedules exactly as the JAX package does.
_ROLL_COST = {'free': 0.0, 'sublane_aligned': 2.1, 'sublane': 5.0,
              'lane_aligned': 2.0, 'lane': 6.5}


def tpu_shift_price(offset: int, linearizer: Optional[Linearizer]) -> float:
  """Measured VPU slots of ONE shifted read at linear ``offset``.

  SURVEY §7.3's deferred hard part: the reference minimizes
  (num_ops, FIFO reuse distance) (computation_reuse.py:573-624); on
  TPU the second term is the in-register shift price, which exp24
  measured varying ~3x with distance ALIGNMENT (roll mode: sublane
  d%8==0 ~2.1 slots vs ~5.0 misaligned; lane d%128==0 ~2.0 vs ~6.5).
  The table is ``_ROLL_COST`` (a copy of the JAX package's
  model/estimate.SHIFT_COST['roll']). DSL dim 0 is the lane
  axis, dim 1 the sublane axis (docs/data-layout.md); higher dims are
  the streaming/major axes, shifted by address arithmetic (free).
  """
  if linearizer is None:
    delta: Tuple[int, ...] = (offset,)
  else:
    delta = linearizer.delta(offset)
  slots = 0.0
  if delta[0]:
    slots += (_ROLL_COST['lane_aligned'] if delta[0] % 128 == 0
              else _ROLL_COST['lane'])
  if len(delta) >= 2 and delta[1]:
    slots += (_ROLL_COST['sublane_aligned'] if delta[1] % 8 == 0
              else _ROLL_COST['sublane'])
  return slots


class CommSchedule:
  """One schedule node: ``left + shift(right, distance)``.

  ``left``/``right`` are either CommSchedule subtrees or leaf payloads
  (an aattr id, or None when the expression has no coefficients).
  Equality and hashing use the normalized attribute set, so any two
  subtrees covering the same relative (offset, payload) multiset are
  the *same* operation (commutative reduction).
  """

  # `base` is only ever set on the root of a tree returned by an
  # external scheduler whose protocol re-sorts rattrs (the reference's
  # soda-cr anchors the tree at the RETURNED rattrs[0], reference
  # computation_reuse.py:1707); left unset elsewhere so that
  # ``getattr(sched, 'base', default)`` falls through to the default.
  __slots__ = ('left', 'right', 'distance', 'base', '_norm', '_hash',
               '_children', '_cost', '_dist', '_dep', '_uniq', '_nops',
               '_offs', '_tpu')

  def __init__(self, left: Payload, right: Payload, distance: int):
    self.left = left
    self.right = right
    self.distance = distance
    self._norm = None
    self._hash = None
    self._children = None
    self._cost = None
    self._dist = None
    self._dep = None
    self._uniq = None
    self._nops = None
    self._offs = None
    self._tpu = None

  # -- attrs -------------------------------------------------------------------
  def attrs_with_offset(self, offset: int = 0
                        ) -> Iterator[Tuple[int, Payload]]:
    if isinstance(self.left, CommSchedule):
      yield from self.left.attrs_with_offset(offset)
    else:
      yield offset, self.left
    offset += self.distance
    if isinstance(self.right, CommSchedule):
      yield from self.right.attrs_with_offset(offset)
    else:
      yield offset, self.right

  @property
  def norm_attrs(self) -> Iterator[Tuple[int, Payload]]:
    return self.attrs_with_offset(0)

  @property
  def norm_attr_set(self) -> FrozenSet[Tuple[int, Payload]]:
    if self._norm is None:
      # build from the children's cached sets (left sits at offset 0,
      # right at +distance) — the recursive-generator walk over leaves
      # dominated the exact search's profile
      left = (self.left.norm_attr_set if isinstance(self.left, CommSchedule)
              else frozenset(((0, self.left),)))
      d = self.distance
      if isinstance(self.right, CommSchedule):
        right = frozenset((o + d, p) for o, p in self.right.norm_attr_set)
      else:
        right = frozenset(((d, self.right),))
      self._norm = left | right
    return self._norm

  def __eq__(self, other) -> bool:
    if not isinstance(other, CommSchedule):
      return NotImplemented
    return self.norm_attr_set == other.norm_attr_set

  def __hash__(self) -> int:
    if self._hash is None:
      self._hash = hash(self.norm_attr_set)
    return self._hash

  def __str__(self) -> str:
    return self.to_str(0)

  def to_str(self, offset: int = 0) -> str:
    left = (self.left.to_str(offset) if isinstance(self.left, CommSchedule)
            else str(self.left))
    offset += self.distance
    right = (self.right.to_str(offset)
             if isinstance(self.right, CommSchedule) else str(self.right))
    return '(%s==%d=>%s)' % (left, self.distance, right)

  # -- cost --------------------------------------------------------------------
  @property
  def children(self) -> List['CommSchedule']:
    """All operation nodes in the tree (self included), with repeats."""
    if self._children is None:
      out = [self]
      for child in (self.left, self.right):
        if isinstance(child, CommSchedule):
          out.extend(child.children)
      self._children = out
    return self._children

  @property
  def num_ops(self) -> int:
    # hot in the search's branch-and-bound loop: build from the
    # children's cached sets instead of re-walking the whole tree
    if self._nops is None:
      self._nops = len(self.uniq_expr_set)
    return self._nops

  @property
  def uniq_expr_set(self) -> Set[FrozenSet[Tuple[int, Payload]]]:
    if self._uniq is None:
      out = {self.norm_attr_set}
      for child in (self.left, self.right):
        if isinstance(child, CommSchedule):
          out |= child.uniq_expr_set
      self._uniq = out
    return self._uniq

  @property
  def cost(self) -> Tuple[int, int]:
    if self._cost is None:
      self._cost = (self.num_ops, self.total_distance)
    return self._cost

  def __lt__(self, other: 'CommSchedule') -> bool:
    return self.cost < other.cost

  # -- reuse-distance LP (reference ILP #3, computation_reuse.py:573-624) -------
  def _dependency(self):
    """(dependers, dependees) over reused variables.

    var 0 = the input, var 1 = this (the output); other vars = subtrees
    appearing more than once. Single-use single-offset vars are inlined
    into their consumer (they need no buffer).
    """
    if self._dep is not None:
      return self._dep
    counts = collections.Counter(self.children)
    var_of: Dict[CommSchedule, int] = {self: 1}
    for sched, count in counts.items():
      if count > 1 and sched not in var_of:
        var_of[sched] = len(var_of) + 1
    table = {vid: s for s, vid in var_of.items()}
    # Offsets below are recorded in each variable's NORMALIZED frame
    # (least leaf at 0) so the cost is anchoring-invariant: external
    # schedulers may return trees rooted anywhere (e.g. at the largest
    # rattr), and the LP pins both the input's and the output's produce
    # offset at 0 — negative root-frame offsets would be infeasible.
    shifts = {s: min(off for off, _ in s.attrs_with_offset(0))
              for s in var_of}

    dependers: Dict[int, Dict[int, None]] = {}
    dependees: Dict[int, Dict[int, Tuple[int, int]]] = {}
    # full per-edge read-offset sets (the (lo, hi) pair above is all
    # the distance LP needs; the TPU shift pricing needs every
    # distinct offset — each is one shifted load in the lowered stage)
    offs: Dict[int, Dict[int, Set[int]]] = {}

    def accesses(sched: CommSchedule, offset=None):
      vid = var_of.get(sched)
      if vid is not None and offset is not None:
        yield offset + shifts[sched], vid
        return
      offset = -shifts.get(sched, 0) if offset is None else offset
      for child, off in ((sched.left, offset),
                         (sched.right, offset + sched.distance)):
        if isinstance(child, CommSchedule):
          yield from accesses(child, off)
        else:
          yield off, 0

    todo = collections.deque([self])
    done = {0}
    while todo:
      sched = todo.popleft()
      dst = var_of[sched]
      done.add(dst)
      for offset, src in accesses(sched):
        dependers.setdefault(src, {})[dst] = None
        lohi = dependees.setdefault(dst, {}).get(src)
        dependees[dst][src] = (offset, offset) if lohi is None else \
            (min(lohi[0], offset), max(lohi[1], offset))
        offs.setdefault(dst, {}).setdefault(src, set()).add(offset)
        if src not in done and table[src] not in todo:
          todo.append(table[src])

    # inline single-use single-offset vars
    changed = True
    while changed:
      changed = False
      for src, dsts in list(dependers.items()):
        if len(dsts) != 1 or src in (0, 1):
          continue
        (dst,) = dsts
        lo, hi = dependees[dst][src]
        if lo != hi:
          continue
        offset = lo
        for src_src, (mn, mx) in dependees[src].items():
          old = dependees[dst].get(src_src)
          new = (mn + offset, mx + offset)
          dependees[dst][src_src] = new if old is None else \
              (min(old[0], new[0]), max(old[1], new[1]))
          offs[dst].setdefault(src_src, set()).update(
              o + offset for o in offs[src][src_src])
          dependers[src_src][dst] = None
          dependers[src_src].pop(src, None)
        del dependers[src]
        del dependees[dst][src]
        del offs[dst][src]
        del dependees[src]
        del offs[src]
        del table[src]
        changed = True
        break
    self._offs = offs
    self._dep = (dependers, dependees, table)
    return self._dep

  @property
  def total_distance(self) -> int:
    if self._dist is not None:
      return self._dist
    dependers, dependees, _ = self._dependency()
    vids = sorted(set(dependers) | set(dependees) | {0, 1})
    if vids == [0, 1]:
      # no reused subtree survived inlining (e.g. a pure linear chain):
      # the only live range is the input's, p_0 = p_1 = 0 pinned, so
      # the optimum is its last consume offset — no LP needed. This is
      # the dominant case when the search floods through no-reuse trees
      # (every yielded tie paid a scipy linprog call before).
      self._dist = int(dependees[1][0][1])
      return self._dist
    from scipy.optimize import linprog
    index = {v: i for i, v in enumerate(vids)}
    n = len(vids)
    # x = [p_0..p_{n-1}, q_0..q_{n-1}]; p_0 = p_1 = 0 pinned
    c = np.zeros(2 * n)
    for src in dependers:
      c[index[src]] -= 1.0
      c[n + index[src]] += 1.0
    a_ub, b_ub = [], []

    def add_le(coeffs, bound):
      row = np.zeros(2 * n)
      for var, co in coeffs:
        row[var] += co
      a_ub.append(row)
      b_ub.append(float(bound))

    for src, dsts in dependers.items():
      for dst in dsts:
        mn, mx = dependees[dst][src]
        # p_src <= mn + p_dst ; q_src >= mx + p_dst
        add_le([(index[src], 1.0), (index[dst], -1.0)], mn)
        add_le([(index[dst], 1.0), (n + index[src], -1.0)], -mx)
    bounds = [(None, None)] * (2 * n)
    bounds[index[0]] = (0, 0)
    bounds[index[1]] = (0, 0)
    res = linprog(c, A_ub=np.array(a_ub), b_ub=np.array(b_ub),
                  bounds=bounds, method='highs')
    if not res.success:
      raise utils.InternalError('reuse-distance LP failed: %s' % res.message)
    self._dist = int(round(
        sum(res.x[n + index[s]] - res.x[index[s]] for s in dependers)))
    return self._dist

  def tpu_slots(self, linearizer: Optional[Linearizer]) -> float:
    """Measured-cost scalarization: VPU slots per cell of this tree.

    One slot per unique operation (each is one vector op per cell)
    plus the measured shift price of every distinct (consumer,
    producer, offset) read in the post-inlining dependency graph —
    the same distinct-(parent, delta) accounting the whole-kernel op
    model charges (model/estimate.op_model). Offsets are in each
    consumer's normalized frame (least leaf at 0, matching where the
    lowering anchors reuse-variable stores), which prices the reuse
    DISTANCES the schedule chose; the absolute window anchor adds a
    schedule-independent bias that comparison ignores.
    """
    if self._tpu is None or self._tpu[0] != id(linearizer):
      self._dependency()
      slots = float(self.num_ops)
      for srcs in self._offs.values():
        for oset in srcs.values():
          for off in oset:
            if off:
              slots += tpu_shift_price(off, linearizer)
      self._tpu = (id(linearizer), slots)
    return self._tpu[1]

  def to_json(self) -> Dict[str, Any]:
    j: Dict[str, Any] = {'distance': self.distance}
    for name in ('left', 'right'):
      child = getattr(self, name)
      j[name] = child.to_json() if isinstance(child, CommSchedule) else child
    return j


def schedule_from_json(j: Dict[str, Any], null_aattr: bool) -> CommSchedule:
  left, right = j['left'], j['right']
  if isinstance(left, dict):
    left = schedule_from_json(left, null_aattr)
  elif null_aattr:
    left = None
  if isinstance(right, dict):
    right = schedule_from_json(right, null_aattr)
  elif null_aattr:
    right = None
  return CommSchedule(left, right, j['distance'])


def idempotent_window_schedule(
    rattrs: Sequence[int]) -> Optional[CommSchedule]:
  """Overlapping doubling chain for min/max over an arithmetic run.

  Idempotent reductions tolerate overlapping covers, so a min over n
  contiguous taps folds in ceil(log2(n)) chained ops: double the span
  while it fits, then one final step whose cover overlaps the prefix
  (span 15 + distance 3 covers [0, 18] for n = 19). The exact-cover
  schedulers are bound to log2(n) + popcount(n) - 1 ops — the DAC'20
  formulation (reference computation_reuse.py) schedules sums, where
  covers must partition the window. Sums keep that bound; only bare
  min/max windows (identical aattrs) take this path. The large
  power-of-two distances are also what the TPU executors shift
  cheapest (an 8-aligned sublane roll is a vreg renumber,
  experiments/exp24_stage_tax.py).

  Returns None unless ``rattrs`` (sorted) is an arithmetic progression
  of at least 4 taps.
  """
  n = len(rattrs)
  if n < 4:
    return None
  w = rattrs[1] - rattrs[0]
  if w <= 0 or any(b - a != w for a, b in zip(rattrs, rattrs[1:])):
    return None
  sched: Payload = None
  span = 1
  while span < n:
    d = min(span, n - span)
    sched = CommSchedule(sched, sched, d * w)
    span += d
  return sched


def linear_schedule(operands: Sequence[Tuple[int, Payload]]) -> CommSchedule:
  """Left-deep chain with no reuse (the do-nothing baseline)."""
  operands = sorted(operands, key=lambda x: x[0])
  (r0, a0), (r1, a1) = operands[0], operands[1]
  sched = CommSchedule(a0, a1, r1 - r0)
  origin = r0
  for rattr, aattr in operands[2:]:
    sched = CommSchedule(sched, aattr, rattr - origin)
  return sched


class ScheduleBase:
  """Common operand container for all schedulers.

  ``cost_mode`` selects the comparison objective:
    'ops'  the reference tuple (num_ops, total reuse distance)
           (computation_reuse.py:573-624) — the default, interface-
           preserving ordering;
    'tpu'  measured-slot scalarization (CommSchedule.tpu_slots): ops
           cost ~1 VPU slot each while a misaligned shift costs up to
           6.5 measured slots, so schedules with equal op counts order
           by their shift alignment and a +1-op schedule may win when
           it buys a cheaper shift set; the reference tuple remains
           the tie-break.
  """

  def __init__(self, rattrs: Sequence[int],
               aattrs: Optional[Sequence[Payload]] = None,
               linearizer: Optional[Linearizer] = None,
               cache: Optional[Dict] = None,
               cost_mode: str = 'ops'):
    self.rattrs = tuple(rattrs)
    self.aattrs = None if aattrs is None else tuple(aattrs)
    self.linearizer = linearizer
    self.cache = cache
    if cost_mode not in ('ops', 'tpu'):
      raise utils.InputError('unknown cr-cost mode: %s' % cost_mode)
    self.cost_mode = cost_mode

  def schedule_key(self, sched: CommSchedule):
    """Comparison key of a candidate under the active cost model."""
    if self.cost_mode == 'tpu':
      return (round(sched.tpu_slots(self.linearizer), 6),) + sched.cost
    return sched.cost

  def __len__(self):
    return len(self.rattrs)

  def __iter__(self) -> Iterator[Tuple[int, Payload]]:
    yield from zip(self.rattrs, self.aattrs or itertools.repeat(None))

  def __getitem__(self, i) -> Tuple[int, Payload]:
    return self.rattrs[i], None if self.aattrs is None else self.aattrs[i]

  def print_stats(self, logger=None) -> None:
    pass


class _SearchTimeout(Exception):
  """Internal: unwinds the lazy enumeration when the deadline fires."""


class _Sub:
  """Memoized lazy enumeration state for one normalized sub-multiset.

  ``items`` is the materialized prefix; ``gen`` the live producer (None
  once exhausted or after a timeout unwound through it); ``complete``
  marks a finished enumeration; ``bound`` is the branch-and-bound cap
  (best num_ops seen for this subproblem, initialized to the linear
  op count)."""

  __slots__ = ('items', 'gen', 'complete', 'bound')

  def __init__(self, n_operands: int):
    self.items: List[CommSchedule] = []
    self.gen: Optional[Iterator[CommSchedule]] = None
    self.complete = False
    self.bound = n_operands  # >= any tree's num_ops (n-1 linear)


def middle_out(n: int) -> Iterator[int]:
  """0..n-1 ordered middle-first (balanced splits explored first).

  Role of reference computation_reuse.py:159-177 ``range_from_middle``:
  balanced left/right partitions maximize early subtree sharing, so the
  first schedules yielded are already good — which is what makes the
  timeout's best-so-far degrade useful on large windows."""
  yield from sorted(range(n), key=lambda m: (abs(2 * m - (n - 1)), m))


class CommSchedules(ScheduleBase):
  """Exact schedule search (lazy middle-out branch-and-bound DP).

  Enumerates binary trees over the operand multiset lazily: left
  subset sizes middle-out (balanced splits first), subproblems
  memoized on the normalized sub-multiset, duplicate trees pruned by
  unique-expression signature, pairings skipped when a subtree's op
  count already exceeds the subproblem's best-so-far (partial-cost
  branch-and-bound), and a global timeout that degrades to
  best-so-far. The reference search has the same shape
  (computation_reuse.py:959-1132: range_from_middle exploration,
  ``skip``/max_cost pruning, 300 s timeout degrading to best); this
  one additionally seeds the bound with the greedy scheduler's result
  on large inputs, so ``optimal`` never returns worse than greedy.

  After ``best``: ``result_mode`` is ``'exact'`` (enumeration
  completed) or ``'timeout-best-so-far'``; ``result_source`` is
  ``'search'`` or ``'greedy-seed'`` (large input, search did not beat
  the seed before the deadline).
  """

  timeout = 30.0
  # ablation toggles (interface role of reference :920-932): `caching`
  # = the sub-multiset memo table; `dedup` = signature-based candidate
  # pruning; `reorder-exploration` = middle-out split order;
  # `skip-with-partial-cost` = the branch-and-bound subtree filter
  # (the latter two use the reference's own knob names).
  memoize = True
  dedup = True
  reorder = True
  skip = True

  def __init__(self, rattrs, aattrs=None, linearizer=None, cache=None,
               cost_mode='ops'):
    super().__init__(rattrs, aattrs, linearizer, cache, cost_mode)
    self._memo: Dict = cache if cache is not None else {}
    self._deadline = None
    self.stat = {'cache_hit': 0, 'cache_miss': 0, 'schedules': 0}
    self.result_mode: Optional[str] = None
    self.result_source: Optional[str] = None
    # under measured-slot costing a schedule with MORE ops can still
    # win (+1 op that replaces a ~6.5-slot misaligned shift with a
    # ~2-slot aligned one nets ~3.5 slots), so the num_ops
    # branch-and-bound must keep a slack margin above the incumbent
    self.bound_slack = 2 if cost_mode == 'tpu' else 0

  @classmethod
  def set_optimizations(cls, opts) -> None:
    """Toggle search optimizations for ablation studies.

    Accepted (each with a ``no-`` prefix to disable): ``caching``,
    ``dedup``, ``reorder-exploration``, ``skip-with-partial-cost``.
    All ablations preserve the search result on inputs the search
    completes; tests assert that (the reference runs its scheduler
    test matrix the same way, test_computation_reuse.py:211-240).
    """
    for opt in opts:
      name = opt[3:] if opt.startswith('no-') else opt
      on = not opt.startswith('no-')
      if name == 'caching':
        cls.memoize = on
      elif name == 'dedup':
        cls.dedup = on
      elif name == 'reorder-exploration':
        cls.reorder = on
      elif name == 'skip-with-partial-cost':
        cls.skip = on
      else:
        raise utils.InputError('unknown optimization toggle: %s' % opt)

  def print_stats(self, logger=None) -> None:
    log = logger or _logger.info
    hit, miss = self.stat['cache_hit'], self.stat['cache_miss']
    rate = hit / (hit + miss) if hit + miss else 0.0
    log('cache: | hit: %d | miss: %d | hit rate: %2.3f %% | '
        'schedules: %d', hit, miss, rate * 100, self.stat['schedules'])
    if self.result_mode is not None:
      log('result: | mode: %s | source: %s |', self.result_mode,
          self.result_source)

  def _check_deadline(self) -> None:
    if self._deadline is not None and time.monotonic() > self._deadline:
      raise _SearchTimeout

  def _iter_sub(self, operands: Tuple[Tuple[int, Payload], ...]
                ) -> Iterator[CommSchedule]:
    """Replay-then-extend iterator over one memoized subproblem.

    Multiple consumers (the nested Cartesian loops) share one
    materialized prefix and one live producer; a timeout that kills
    the producer marks ``gen`` dead, and a later query (same shared
    cache) resumes with a fresh producer whose dedup set is pre-seeded
    from the materialized items, so already-yielded trees are not
    produced twice and a truncated run never poisons the cache."""
    sub = self._memo.get(operands) if self.memoize else None
    if sub is None:
      self.stat['cache_miss'] += 1
      sub = _Sub(len(operands))
      sub.gen = self._generate(operands, sub)
      if self.memoize:
        self._memo[operands] = sub
    else:
      self.stat['cache_hit'] += 1
    i = 0
    while True:
      while i < len(sub.items):
        yield sub.items[i]
        i += 1
      if sub.complete:
        return
      if sub.gen is None:  # producer was killed by an earlier timeout
        sub.gen = self._generate(operands, sub, resume=True)
      try:
        nxt = next(sub.gen)
      except StopIteration:
        sub.complete, sub.gen = True, None
        return
      except _SearchTimeout:
        sub.gen = None
        raise
      sub.items.append(nxt)

  def _generate(self, operands: Tuple[Tuple[int, Payload], ...],
                sub: _Sub, resume: bool = False) -> Iterator[CommSchedule]:
    """Produce structurally distinct schedules over normalized
    operands, balanced splits first, subtree-cost pruned.

    ``resume=True`` rebuilds a producer killed by a timeout: the dedup
    set is pre-seeded with the materialized items' signatures so only
    genuinely new trees are yielded (with dedup ablated off, a resumed
    producer may re-yield duplicates — harmless: candidates are only
    cost-compared)."""
    n = len(operands)
    if n < 2:
      raise utils.InternalError('cannot schedule a single operand')
    if n == 2:
      if resume and sub.items:
        return
      (r0, a0), (r1, a1) = operands
      self.stat['schedules'] += 1
      sub.bound = 1
      yield CommSchedule(a0, a1, r1 - r0)
      return
    sigs: Set[FrozenSet] = set()
    if resume and self.dedup:
      sigs = {frozenset(s.uniq_expr_set) for s in sub.items}
    sizes = middle_out(n - 1) if self.reorder else iter(range(n - 1))
    # left subset always contains operand 0 (fixes tree orientation);
    # m = how many of the remaining n-1 operands join it
    for m in sizes:
      for selection in itertools.combinations(range(1, n), m):
        self._check_deadline()
        left_idx = (0,) + selection
        left_set = set(left_idx)
        right_idx = tuple(i for i in range(n) if i not in left_set)
        left_ops = tuple(operands[i] for i in left_idx)
        right_ops = tuple(operands[i] for i in right_idx)
        l_origin = left_ops[0][0]
        r_origin = right_ops[0][0]
        lefts = ([left_ops[0][1]] if len(left_ops) == 1 else
                 self._iter_sub(tuple((r - l_origin, a)
                                      for r, a in left_ops)))
        for l in lefts:
          l_cost = 1 + (l.num_ops if isinstance(l, CommSchedule) else 0)
          if self.skip and l_cost > sub.bound + self.bound_slack:
            continue
          rights = ([right_ops[0][1]] if len(right_ops) == 1 else
                    self._iter_sub(tuple((r - r_origin, a)
                                         for r, a in right_ops)))
          for r in rights:
            r_cost = 1 + (r.num_ops if isinstance(r, CommSchedule)
                          else 0)
            if self.skip and r_cost > sub.bound + self.bound_slack:
              continue
            sched = CommSchedule(l, r, r_origin - l_origin)
            self.stat['schedules'] += 1
            if self.dedup:
              sig = frozenset(sched.uniq_expr_set)
              if sig in sigs:
                continue
              sigs.add(sig)
            sub.bound = min(sub.bound, sched.num_ops)
            yield sched

  # past this operand count, pre-seed the branch-and-bound cap (and
  # the best-so-far answer) with the greedy scheduler: exhaustive
  # enumeration cannot complete, so the timeout's best-so-far should
  # start no worse than the heuristic result
  seed_threshold = 10

  @cached_property
  def best(self) -> CommSchedule:
    origin = self.rattrs[0]
    operands = tuple((r - origin, a) for r, a in self)
    best = None
    best_key = None
    self.result_mode, self.result_source = 'exact', 'search'
    if len(operands) > self.seed_threshold:
      best = GreedySchedules(self.rattrs, self.aattrs, self.linearizer,
                             cost_mode=self.cost_mode).best
      best_key = self.schedule_key(best)
      self.result_source = 'greedy-seed'
    self._deadline = time.monotonic() + self.timeout
    if best is not None and self.memoize and len(operands) >= 2:
      # thread the seed's cost into the root's branch-and-bound cap
      # (prime the root subproblem: _iter_sub creates it lazily)
      root = self._memo.get(operands)
      if root is None:
        root = _Sub(len(operands))
        root.gen = self._generate(operands, root)
        self._memo[operands] = root
        self.stat['cache_miss'] += 1
        self.stat['cache_hit'] -= 1  # _iter_sub will re-count it as a hit
      root.bound = min(root.bound, best.num_ops)
    try:
      for sched in self._iter_sub(operands):
        key = self.schedule_key(sched)
        if best is None or key < best_key:
          best, best_key = sched, key
          self.result_source = 'search'
    except _SearchTimeout:
      self.result_mode = 'timeout-best-so-far'
      _logger.warning(
          'exact search timed out after %.1fs on %d operands; returning '
          'best-so-far (source: %s)', self.timeout, len(operands),
          self.result_source)
    if best is None:
      best = linear_schedule(tuple(self))
      self.result_source = 'linear-fallback'
    return best


class GreedySchedules(ScheduleBase):
  """Greedy pairwise-reuse scheduler (reference :1135-1318).

  Each round counts every (distance, payload-pair) operation over all
  operand pairs, resolves overlap conflicts by parity (odd chains take
  even positions; even chains take the side with the smaller span),
  optionally restricts to reuses aligned with a single grid dimension,
  then recurses on the reduced operand set for the top ``num_pruned``
  candidate operations.
  """

  timeout = 1.0
  num_pruned = 5

  def __lt__(self, other: 'GreedySchedules') -> bool:
    return (self.schedule_key(self.comparison_key) <
            other.schedule_key(other.comparison_key))

  @cached_property
  def comparison_key(self) -> CommSchedule:
    return linear_schedule(tuple(self))

  def _operation_pairs(self
                       ) -> Tuple[Dict[CommSchedule, List[Tuple[int, int]]],
                                  Set[CommSchedule]]:
    """Discover every reusable operation and its independent pair set.

    An *operation* is a (payload, payload, distance) triple; a *pair*
    (i, j) of operand indices can compute it when operand j sits
    exactly ``distance`` past operand i with the matching payloads.
    Pairs sharing an operand form arithmetic-progression chains; from
    each chain an independent subset is selected (alternate pairs —
    heads-first for odd chains; for even chains, whichever alternation
    keeps the overall rattr span smaller). Returns the per-operation
    selections (only operations usable at least twice) plus the set of
    operations whose chains overlapped.
    """
    pos = {attr: k for k, attr in enumerate(self)}
    n = len(self)
    selected: 'collections.OrderedDict[CommSchedule, List[Tuple[int, int]]]' \
        = collections.OrderedDict()
    contended: Set[CommSchedule] = set()
    for i in range(n):
      for j in range(i + 1, n):
        r_i, a_i = self[i]
        r_j, a_j = self[j]
        op = CommSchedule(a_i, a_j, r_j - r_i)
        if op in selected:
          continue
        # left-index -> right-index over all pairs computing `op`
        succ: Dict[int, int] = {}
        for k, (r_k, a_k) in enumerate(self):
          if a_k == a_i:
            mate = pos.get((r_k + op.distance, a_j))
            if mate is not None and mate != k:
              succ[k] = mate
        is_right = set(succ.values())
        chains = []
        for head in sorted(succ):
          if head in is_right:
            continue  # mid-chain; reached from its chain's head
          chain = []
          k = head
          while k in succ:
            chain.append((k, succ[k]))
            k = succ[k]
          chains.append(chain)
          if len(chain) > 1:
            contended.add(op)
        picks: List[Tuple[int, int]] = []
        for chain in chains:
          if len(chain) % 2:
            picks.extend(chain[::2])
        lo = min((p[0] for p in picks), default=0)
        hi = max((p[0] for p in picks), default=-1)
        for chain in chains:
          if len(chain) % 2 == 0:
            span = [self.rattrs[max(chain[s - 2][0], hi)] -
                    self.rattrs[min(chain[s][0], lo)] for s in (0, 1)]
            picks.extend(chain[1 if span[1] < span[0] else 0::2])
        selected[op] = sorted(picks)
    return ({op: v for op, v in selected.items() if len(v) > 1},
            contended)

  def _apply_operations(self, first: CommSchedule,
                        ops: Dict[CommSchedule, List[Tuple[int, int]]]
                        ) -> 'GreedySchedules':
    """Reduce the operand set: fold ``first``'s pairs into single
    operands, then every other operation's (most pairs first, shorter
    distances breaking ties), skipping any operation left with fewer
    than two disjoint pairs."""
    kept = collections.OrderedDict(enumerate(self))
    taken: Set[int] = set()
    if self.cost_mode == 'tpu':
      # among equally-reusable operations, fold the cheap-shift ones
      # first: their distances survive into the lowered kernel as
      # in-register rotates, and 8-aligned sublane / vreg-multiple
      # lane distances cost ~3x less (tpu_shift_price)
      order = [first] + sorted(
          ops, key=lambda s: (-len(ops[s]),
                              tpu_shift_price(s.distance, self.linearizer),
                              s.distance))
    else:
      order = [first] + sorted(ops,
                               key=lambda s: (-len(ops[s]), s.distance))
    for op in order:
      free = [(i, j) for i, j in ops[op]
              if i not in taken and j not in taken]
      if len(free) < 2:
        continue
      for i, j in free:
        kept[i] = (kept[i][0], op)
        del kept[j]
        taken.update((i, j))
    rattrs, aattrs = zip(*kept.values())
    return GreedySchedules(rattrs, aattrs, self.linearizer,
                           cost_mode=self.cost_mode)

  def _axis_aligned(self, distance: int, dim: int) -> bool:
    """True iff two points ``distance`` apart differ in exactly
    dimension ``dim``.

    ``distance`` is a RELATIVE offset, so it must be decoded with the
    balanced ``delta`` — the floor-based ``restore`` mis-reads negative
    components under tile radices (e.g. true delta (-2, +1) restores to
    (radix-2, 0), falsely classifying a diagonal reuse as dim-0
    aligned and degrading the single-dimension pruning filter)."""
    digits = self.linearizer.delta(distance)
    return all((d == dim) == (digit != 0) for d, digit in enumerate(digits))

  @property
  def generator(self) -> Iterator[CommSchedule]:
    ops, contended = self._operation_pairs()
    if not ops:
      yield linear_schedule(tuple(self))
      return

    # when operations outnumber operands, restrict the search to
    # reuses along a single grid dimension (prefer the streaming one)
    if self.linearizer is not None and len(ops) > len(self):
      for dim in reversed(self.linearizer.dims):
        if any(self._axis_aligned(op.distance, dim) for op in ops):
          ops = {
              op: [(i, j) for i, j in pairs if self._axis_aligned(
                  self.rattrs[j] - self.rattrs[i], dim)]
              for op, pairs in ops.items()
              if self._axis_aligned(op.distance, dim)
          }
          break

    candidates = [(op in contended, self._apply_operations(op, ops))
                  for op in ops]
    for _, schedule in heapq.nsmallest(self.num_pruned, candidates):
      yield from schedule.generator

  @cached_property
  def best(self) -> CommSchedule:
    generator = self.generator
    best = next(generator)
    best_key = self.schedule_key(best)
    deadline = time.monotonic() + self.timeout
    for schedule in generator:
      key = self.schedule_key(schedule)
      if key < best_key:
        best, best_key = schedule, key
      if time.monotonic() > deadline:
        _logger.warning('greedy scheduler timeout after %.1fs', self.timeout)
        break
    return best


class BeamSchedules(GreedySchedules):
  """Greedy search with a wider per-level pruning width and a longer
  budget: keeps the 16 best candidate operations at every recursion
  level (vs greedy's 5), exploring a genuinely larger schedule space at
  higher cost (role of reference computation_reuse.py:1318's best-first
  beam; same candidate generator here, widened rather than re-ordered
  because greedy's cost-sorted nsmallest already visits candidates
  best-first within a level)."""
  timeout = 5.0
  num_pruned = 16


class GloreSchedules(ScheduleBase):
  """GLORE-style heuristic: group operands along axis/diagonal
  directions, chain reuse within each direction group, then combine
  groups linearly (reference :1523-1689)."""

  def _directions(self) -> List[Tuple[int, ...]]:
    if self.linearizer is None:
      return [(1,)]
    dims = self.linearizer.num_dim
    dirs = []
    for d in range(dims):
      vec = [0] * dims
      vec[d] = 1
      dirs.append(tuple(vec))
    if dims >= 2:
      dirs.append(tuple([1] * dims))
      diag = [1] * dims
      diag[0] = -1
      dirs.append(tuple(diag))
    return dirs

  @cached_property
  def best(self) -> CommSchedule:
    operands = sorted(self, key=lambda x: x[0])
    best = linear_schedule(operands)
    if self.linearizer is None:
      return best
    for direction in self._directions():
      step = self.linearizer.apply(
          tuple(m + v for m, v in zip(self.linearizer.mins, direction)))
      if step <= 0:
        continue
      # group operands into chains along `direction`
      remaining = collections.OrderedDict(
          ((r, a), None) for r, a in operands)
      groups: List[List[Tuple[int, Payload]]] = []
      for (r, a) in list(remaining):
        if (r, a) not in remaining:
          continue
        chain = [(r, a)]
        del remaining[(r, a)]
        nxt = r + step
        while (nxt, a) in remaining:
          chain.append((nxt, a))
          del remaining[(nxt, a)]
          nxt += step
        groups.append(chain)
      # chains of equal length+payload pattern share one subschedule
      built: Dict[Tuple, CommSchedule] = {}
      new_operands: List[Tuple[int, Payload]] = []
      for chain in groups:
        if len(chain) == 1:
          new_operands.append(chain[0])
          continue
        sig = tuple((r - chain[0][0], a) for r, a in chain)
        sub = built.get(sig)
        if sub is None:
          sub = linear_schedule(sig)
          built[sig] = sub
        new_operands.append((chain[0][0], sub))
      if len(new_operands) == 1 and isinstance(new_operands[0][1],
                                               CommSchedule):
        candidate = new_operands[0][1]
      else:
        candidate = linear_schedule(new_operands)
      if self.schedule_key(candidate) < self.schedule_key(best):
        best = candidate
    return best


class ExternalSchedules(ScheduleBase):
  """Drive the external C++ scheduler over the JSON protocol.

  Protocol (same as the reference's soda-cr, :1704-1740): stdin gets
  {"rattrs": [...], "aattrs": [...], "num_pruned": N[, "linearizer":
  {"maxs": [...], "mins": [...], "sizes": [...]}]}; stdout returns the
  schedule tree as nested {"left": ..., "right": ..., "distance": d}.
  """

  BINARIES = ('soda-tpu-cr', 'soda-cr')

  def __init__(self, rattrs, aattrs=None, linearizer=None, cache=None,
               cost_mode='ops'):
    super().__init__(rattrs, aattrs, linearizer, cache, cost_mode)
    binary = find_external_cr()
    if binary is None:
      raise utils.InputError(
          'external computation-reuse scheduler requested but no %s '
          'binary is on PATH' % '/'.join(self.BINARIES))
    self.cmd = [binary]

  @cached_property
  def best(self) -> CommSchedule:
    attrs: Dict[str, Any] = {
        'rattrs': list(self.rattrs),
        'aattrs': list(self.aattrs or [1] * len(self.rattrs)),
    }
    n = len(self.rattrs)
    if self.linearizer is not None and (n >= 32 or self.cost_mode == 'tpu'):
      attrs['linearizer'] = {
          'maxs': list(self.linearizer.maxs),
          'mins': list(self.linearizer.mins),
          'sizes': list(self.linearizer.sizes),
      }
    if self.cost_mode == 'tpu':
      if os.path.basename(self.cmd[0]).startswith('soda-tpu-cr'):
        # extend the protocol with the measured shift-price table so
        # the native search orders candidates exactly like the
        # in-process schedulers (tpu_shift_price); prices are sent
        # rather than baked into the binary so the two cannot drift
        roll = _ROLL_COST
        attrs['cost_model'] = {
            'mode': 'tpu',
            'lane': roll['lane'],
            'lane_aligned': roll['lane_aligned'],
            'sublane': roll['sublane'],
            'sublane_aligned': roll['sublane_aligned'],
        }
      else:
        # the reference's soda-cr predates the key and exits on
        # unknown input — run it with its native (ops) objective
        _logger.warning('external binary %s does not speak the tpu '
                        'cost model; scheduling with cost=ops',
                        self.cmd[0])
    attrs['num_pruned'] = (64 if n < 32 else 4 if n < 64 else
                           3 if n < 128 else 2 if n < 256 else 1)
    result = json.loads(
        subprocess.run(self.cmd, input=json.dumps(attrs),
                       stdout=subprocess.PIPE, universal_newlines=True,
                       check=True).stdout)
    sched = schedule_from_json(result, self.aattrs is None)
    returned = result.get('rattrs')
    if returned:
      # reference soda-cr protocol: the tree is rooted at the RETURNED
      # rattrs[0] (which the binary may have re-sorted), reference
      # computation_reuse.py:1707; our own binary echoes no rattrs and
      # roots at the input origin
      sched.base = returned[0]
    return sched


def find_external_cr() -> Optional[str]:
  """Locate the external scheduler binary (repo build dir, then PATH)."""
  here = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  for name in ExternalSchedules.BINARIES:
    cand = os.path.join(here, 'native', 'build', name)
    if os.access(cand, os.X_OK):
      return cand
    found = shutil.which(name)
    if found:
      return found
  return None


# -- Expression: reduction <-> schedules <-> IR --------------------------------
class Expression:
  """A reduction expression eligible for computation reuse.

  Accepts reductions (+, min, max) whose operands each load exactly one
  tensor ref (reference :1792-1803); splits each operand into a
  relative attribute (linearized load index) and an absolute attribute
  (the coefficient subtree normalized to index 0).
  """

  class CannotHandle(Exception):

    def __init__(self, msg, details: str = ''):
      details = details or (': %s' % str(msg))
      super().__init__('cannot handle ' + str(msg) + ' ' + details)

  def __init__(self, node: ir.Node, stencil=None):
    reduction = ir.to_reduction(node)
    if reduction is None:
      raise Expression.CannotHandle('non-reduction node', str(node))
    self.operator, operands = reduction
    if len(operands) < 2:
      raise Expression.CannotHandle('single-operand reduction')
    rattrs: List[Tuple[int, ...]] = []
    aattr_nodes: List[ir.Node] = []
    tensor_name = None
    for operand in operands:
      loads = soda_visitor.get_load_set(operand)
      if len(loads) != 1:
        raise Expression.CannotHandle(
            'operand with multiple or no loads', str(operand))
      if tensor_name is None:
        tensor_name = loads[0].name
      elif loads[0].name != tensor_name:
        raise Expression.CannotHandle('multiple input tensors', str(operand))
      idx, norm = extract_attr(operand)
      rattrs.append(tuple(idx))
      aattr_nodes.append(norm)
    self.tensor_name = tensor_name
    tile_size = getattr(stencil, 'tile_size', ())
    try:
      self.linearizer = Linearizer(rattrs, tile_size)
    except utils.InputError:
      # tile extents smaller than a window's reach cannot serve as
      # decode radices (the balanced decode would alias); fall back to
      # span-derived radices — still a valid bijection, just no longer
      # directly comparable to serialized tile positions
      self.linearizer = Linearizer(rattrs)
    order = sorted(range(len(rattrs)),
                   key=lambda i: self.linearizer.apply(rattrs[i]))
    self.rattrs = tuple(self.linearizer.apply(rattrs[i]) for i in order)
    if len(set(self.rattrs)) != len(self.rattrs):
      raise Expression.CannotHandle('duplicate relative attributes')
    aattr_nodes = [aattr_nodes[i] for i in order]

    # dedupe aattrs into an id table; all-identical bare loads -> None
    self.aattr_table: Dict[Payload, ir.Node] = {}
    if all(isinstance(a, ir.Ref) for a in aattr_nodes) and \
        len({str(a) for a in aattr_nodes}) == 1:
      self.aattrs = None
      self.aattr_table[None] = aattr_nodes[0]
    else:
      ids: Dict[str, int] = {}
      aattrs = []
      for node_ in aattr_nodes:
        key = str(node_)
        if key not in ids:
          ids[key] = len(ids)
          self.aattr_table[ids[key]] = node_
        aattrs.append(ids[key])
      self.aattrs = tuple(aattrs)
    self.stencil = stencil

  # -- scheduler dispatch (reference :1838-1857) -------------------------------
  @cached_property
  def best_schedule(self) -> Optional[CommSchedule]:
    method = 'built-in'
    cost_mode = 'ops'
    if self.stencil is not None:
      method = self.stencil.optimizations.get('computation-reuse',
                                              'built-in')
      # 'cr-cost': 'tpu' re-weights the schedule objective with the
      # measured per-shift prices (SURVEY §7.3: keep the reference's
      # (ops, distance) interface, re-weight the second term for TPU)
      cost_mode = self.stencil.optimizations.get('cr-cost', 'ops')
    if method in ('yes', 'built-in'):
      external = find_external_cr()
      if external is not None:
        cls = ExternalSchedules
      else:
        cls = GreedySchedules if len(self.rattrs) > 6 else CommSchedules
    elif method in ('greedy', 'built-in:greedy'):
      cls = GreedySchedules
    elif method in ('optimal', 'built-in:optimal'):
      cls = CommSchedules
    elif method == 'beam':
      cls = BeamSchedules
    elif method == 'glore':
      cls = GloreSchedules
    elif method == 'external':
      if find_external_cr() is None:
        raise utils.InputError('external CR scheduler not found')
      cls = ExternalSchedules
    else:
      raise utils.InputError('unknown computation-reuse method: %s' % method)
    if self.operator in ('min', 'max') and self.aattrs is None and (
        self.stencil is None or
        self.stencil.optimizations.get('idempotent-window', 'yes') != 'no'):
      chain = idempotent_window_schedule(self.rattrs)
      if chain is not None and chain.num_ops < len(self.rattrs) - 1:
        return chain
    schedule = cls(self.rattrs, self.aattrs, self.linearizer,
                   cost_mode=cost_mode).best
    if schedule is None or schedule.num_ops >= len(self.rattrs) - 1:
      return None  # no reuse found; leave the expression alone
    return schedule

  # -- lowering back to IR -------------------------------------------------------
  def schedule_ir_node(self, sched, offset: int) -> ir.Node:
    """Fully inlined IR for a schedule instance at absolute linear
    ``offset`` (no reuse vars)."""
    if not isinstance(sched, CommSchedule):
      return assemble_attr(self.linearizer.index_of(offset),
                           self.aattr_table[sched])
    left = self.schedule_ir_node(sched.left, offset)
    right = self.schedule_ir_node(sched.right, offset + sched.distance)
    return ir.from_reduction(self.operator, (left, right))

  def lower(self, schedule: CommSchedule, stencil,
            cses: Dict[ir.Node, ir.Ref]) -> ir.Node:
    """Rewrite the expression using ``schedule``; reused subtrees become
    new variables recorded in ``cses`` (normalized expr -> write Ref),
    the relative-CSE half of reference get_ir_node_with_rcr (:755-813).
    """
    counts = collections.Counter(schedule.children)
    reused = [s for s, c in counts.items() if c > 1]
    # process reused vars bottom-up (smaller trees first)
    reused.sort(key=lambda s: len(s.children))
    var_refs: Dict[CommSchedule, ir.Ref] = {}

    def instance(sched, offset: int) -> ir.Node:
      """IR for an instance of ``sched`` at linear ``offset`` (absolute
      for the top-level call; subtree-relative inside var definitions —
      index_of/delta's balanced decode is correct for both, unlike
      restore's floor decode, which mis-reads negative components
      under tile-sized radices)."""
      if not isinstance(sched, CommSchedule):
        return assemble_attr(self.linearizer.index_of(offset),
                             self.aattr_table[sched])
      ref = var_refs.get(sched)
      if ref is not None:
        # Reuse variables store AT their least leaf's cell (write
        # index 0, definition normalized), so a read of the instance
        # at `offset` addresses the TRUE index of that instance's
        # least leaf. This is frame-independent: a var created by one
        # statement's Expression (its own Linearizer mins/anchor) is
        # read correctly by any other statement's rewrite — the
        # round-3 sym-contrast campaign caught the old frame-relative
        # convention producing cross-statement reads off by the
        # defining frame's mins.
        leaves = [self.linearizer.index_of(offset + rel)
                  for rel, _ in sched.attrs_with_offset(0)]
        idx = min(leaves, key=lambda t: tuple(reversed(t)))
        return ir.Ref(name=ref.name, idx=idx, lat=None, dtype=ref.dtype)
      left = instance(sched.left, offset)
      right = instance(sched.right, offset + sched.distance)
      return arithmetic.simplify(
          ir.from_reduction(self.operator, (left, right)))

    for var in reused:
      # the var's defining expression, normalized so its least load is 0
      raw = instance(var, 0)
      norm_idx = soda_visitor.get_normalize_index(raw)
      expr = mutator.shift(raw, norm_idx)
      norm_key = expr
      prev = cses.get(norm_key)
      if prev is not None:
        var_refs[var] = prev
        continue
      name = stencil.new_cr_var()
      ref = ir.Ref(name=name, idx=(0,) * self.linearizer.num_dim,
                   lat=None)
      stencil.symbol_table[name] = None  # filled by propagate_type later
      cses[norm_key] = ref
      var_refs[var] = ref

    top = instance(schedule, getattr(schedule, 'base', self.rattrs[0]))
    return arithmetic.simplify(top)

  def get_ir_node_with_cr(self, stencil, cses) -> ir.Node:
    node = self.lower(self.best_schedule, stencil, cses)
    return absolute_cse(node, stencil, cses)


def absolute_cse(node: ir.Node, stencil,
                 cses: Dict[ir.Node, ir.Ref]) -> ir.Node:
  """Pull repeated coefficient subtrees into shared variables.

  The second half of the DAC'20 lowering (reference
  computation_reuse.py:815-868, ``get_ir_node_with_cr`` on top of rcr):
  after relative CSE, the reduction operands still repeat *absolute*
  attribute computations — e.g. contrast's radially-symmetric table
  multiplies the input by the same coefficient at up to 8 offsets. Any
  compound operand whose normalized form occurs more than once (across
  the rewritten node AND every CSE definition) becomes one new variable
  computed once and read at shifted offsets.
  """
  norm_refs = {ref.name: ref.idx for ref in cses.values()}
  occurrences: Dict[ir.Node, List[Tuple[int, ...]]] = \
      collections.OrderedDict()

  def tally(expr: ir.Node, base_idx: Tuple[int, ...] = ()) -> None:
    reduction = ir.to_reduction(expr)
    if reduction is None:
      return
    for operand in reduction[1]:
      if not isinstance(operand, ir.CHAIN_CLASSES):
        continue  # plain loads have no computation to share
      idx = soda_visitor.get_normalize_index(operand, references=norm_refs)
      if base_idx:
        idx = tuple(x - y for x, y in zip(idx, base_idx))
      key = mutator.normalize(operand, references=norm_refs)
      occurrences.setdefault(key, []).append(idx)

  tally(node, soda_visitor.get_normalize_index(node, references=norm_refs))
  for definition in cses:
    tally(definition)  # definitions are already normalized

  acrs: Dict[ir.Node, ir.Ref] = {}
  for operand, indices in occurrences.items():
    if len(indices) < 2:
      continue
    name = stencil.new_cr_var()
    # write at the least occurrence index so every read looks backward
    least = min(indices, key=lambda idx: tuple(reversed(idx)))
    acrs[operand] = ir.Ref(name=name, idx=_neg(least), lat=None,
                           dtype=operand.dtype)
    # operand types were propagated before the pass ran, so the new
    # variable's type is simply the subtree's type
    stencil.symbol_table[name] = operand.dtype
  if not acrs:
    return node

  def rewrite(expr: ir.Node) -> ir.Node:
    return mutator.replace_expressions(expr, acrs, references=norm_refs)

  # existing definitions now read the shared variables
  for definition, ref in list(cses.items()):
    del cses[definition]
    cses[rewrite(definition)] = ref
  cses.update(acrs)
  reduction = ir.to_reduction(node)
  return arithmetic.simplify(
      ir.from_reduction(reduction[0], tuple(map(rewrite, reduction[1]))))
