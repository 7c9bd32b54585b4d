"""Computation-reuse (CSE) pass — the DAC'20 engine.

Rebuild of reference src/soda/optimization/computation_reuse.py.
This module currently provides the pass entry point, attribute
extraction, and the Linearizer; the scheduler family (exact DP, greedy,
beam, external C++ binary) lives in
``soda_tpu_torch.optimization.cr_schedules`` and is dispatched from
``Expression.best_schedule`` exactly as the reference does
(computation_reuse.py:1838-1857).
"""

from __future__ import annotations

import collections
import itertools
import logging
import operator
from typing import Dict, List, MutableMapping, Optional, Sequence, Tuple, Union

from soda_tpu_torch import utils
from soda_tpu_torch.ir import arithmetic, mutator, nodes as ir
from soda_tpu_torch.ir import visitor

RelativeAttr = int
AbsoluteAttr = int
Attr = Union[RelativeAttr, Tuple[RelativeAttr, Optional[AbsoluteAttr]]]

OrderedDict = collections.OrderedDict

_logger = logging.getLogger().getChild(__name__)


def extract_attr(node: ir.Node) -> Tuple[Tuple[int, ...], ir.Node]:
  """Decompose an operand into its (rattr, aattr) pair.

  The relative attribute is the index of the operand's unique tensor
  load; the absolute attribute is the operand with that load moved to
  the origin (role of reference computation_reuse.py:43-56; callers
  guarantee exactly one load per operand).
  """
  (ref,) = visitor.get_load_set(node)
  return ref.idx, mutator.shift(node, ref.idx)


def assemble_attr(rattr: Tuple[int, ...], aattr: ir.Node) -> ir.Node:
  """Place a normalized coefficient subtree back at index ``rattr`` —
  the inverse of :func:`extract_attr`."""
  return mutator.shift(aattr, rattr, op=operator.add)


class Linearizer:
  """Bijection between N-D relative indices and scalar offsets.

  Role of reference computation_reuse.py:75-156. Each dimension gets a
  radix of ``2 * span - 1`` so that *differences* of encoded offsets
  decode to unique index deltas (a distance can reach from -span+1 to
  span-1 per dim); with a tile size, every non-streaming dimension uses
  the tile extent as its radix instead, making encoded offsets directly
  comparable to serialized tile positions.

  Attributes ``maxs``/``mins``/``sizes`` are part of the external-CR
  JSON protocol; ``dims``/``weights``/``num_dim`` are used by the
  schedulers' dimension-alignment filters.
  """

  def __init__(self, rattrs: Sequence[Sequence[int]],
               tile_size: Sequence[int] = ()):
    per_dim = list(zip(*rattrs))  # transpose: one tuple per dimension
    self.mins = [min(vals) for vals in per_dim]
    self.maxs = [max(vals) for vals in per_dim]
    spans = [hi - lo + 1 for lo, hi in zip(self.mins, self.maxs)]
    if tile_size:
      self.sizes = tuple(tile_size)[:-1] + (2 * spans[-1] - 1,)
    else:
      self.sizes = tuple(2 * span - 1 for span in spans)
    # The balanced decode (``delta``) is unique only while every
    # per-dimension component satisfies |component| < radix / 2, i.e.
    # radix >= 2 * span - 1. The span-derived radices satisfy this by
    # construction; a caller-provided tile extent smaller than the
    # window's reach would make ``index_of`` silently alias in-box
    # offsets — refuse it up front.
    for d, (radix, span) in enumerate(zip(self.sizes, spans)):
      if radix < 2 * span - 1:
        raise utils.InputError(
            'tile size %d in dim %d cannot disambiguate a window '
            'spanning %d cells (needs >= %d)' % (radix, d, span,
                                                 2 * span - 1))
    strides = [1]
    for radix in self.sizes[:-1]:
      strides.append(strides[-1] * radix)
    self._strides = tuple(strides)

  @property
  def num_dim(self) -> int:
    return len(self.mins)

  @property
  def dims(self) -> Tuple[int, ...]:
    return tuple(range(self.num_dim))

  @property
  def weights(self) -> List[int]:
    return list(self._strides)

  def apply(self, rattr: Sequence[int]) -> int:
    return sum(stride * (val - lo) for stride, val, lo
               in zip(self._strides, rattr, self.mins))

  def restore(self, offset: int) -> Tuple[int, ...]:
    idx = [0] * self.num_dim
    for d in range(self.num_dim - 1, -1, -1):
      digit, offset = divmod(offset, self._strides[d])
      idx[d] = self.mins[d] + digit
    return tuple(idx)

  def delta(self, offset: int) -> Tuple[int, ...]:
    """Decode a RELATIVE linear offset into a signed index delta.

    ``restore`` floor-decodes, which is only correct for in-box
    absolute offsets: a difference like (dx=-8, dy=+1) encodes to
    dy*size - 8, which restore mis-reads as (size-8, 0) whenever the
    radix is a tile extent (no doubling headroom). Schedule lowering
    produces exactly such out-of-box relative offsets (reused-subtree
    instances sit anywhere), so deltas use a BALANCED decode: each
    digit is the centered residue in [-radix/2, radix/2). Unique for
    |component| < radix/2, which every per-dimension reach satisfies.
    """
    out = []
    for d in range(self.num_dim - 1):
      radix = self.sizes[d]
      digit = (offset + radix // 2) % radix - radix // 2
      out.append(digit)
      offset = (offset - digit) // radix
    out.append(offset)
    return tuple(out)

  def index_of(self, offset: int) -> Tuple[int, ...]:
    """True N-D index of a schedule-tree offset (balanced decode +
    mins). Agrees with ``restore`` on in-box absolute offsets and
    stays correct for out-of-box ones."""
    return tuple(d + m for d, m in zip(self.delta(offset), self.mins))

  def __call__(self, rattr):
    if isinstance(rattr, int):
      return self.restore(rattr)
    if isinstance(rattr, Sequence) and isinstance(rattr[0], int):
      return self.apply(rattr)
    raise TypeError('rattr needs to be an int or a Sequence of int')


def computation_reuse(stencil):
  """Pass entry: rewrite reductions with reused subexpressions.

  No-op unless ``stencil.optimizations['computation-reuse']`` selects a
  method (reference computation_reuse.py:202-204).
  """
  method = stencil.optimizations.get('computation-reuse')
  if method is None or method == 'no':
    return stencil
  _logger.debug('invoke stencil computation reuse')
  from soda_tpu_torch.optimization.cr_schedules import Expression
  from soda_tpu_torch.frontend import ast

  def cr_visitor(node: ir.Node, args) -> ir.Node:
    cses, env = args
    try:
      # Close over the statement's let bindings BEFORE scheduling: the
      # cses dict is shared across statements and its keys compare Var
      # reads by NAME, so a subtree mentioning `k` from a statement
      # with `let k = 3` must not unify with a same-shaped subtree from
      # a statement with `let k = 5`. Substituting the (recursively
      # closed, declared-type-cast) let expressions makes every stored
      # definition self-contained — sharing is then sound by
      # construction, and identical bindings still share.
      expression = Expression(mutator.substitute_vars(node, env), stencil)
      if expression.best_schedule is not None:
        _logger.debug('best schedule: (cost: %s)',
                      expression.best_schedule.cost)
        return expression.get_ir_node_with_cr(stencil, cses)
    except Expression.CannotHandle:
      pass
    return node

  def let_env(stmt) -> Dict[str, ir.Node]:
    """name -> let-closed defining expression (declared types kept)."""
    env: Dict[str, ir.Node] = {}
    for let in stmt.let:
      expr = mutator.substitute_vars(let.expr, env)
      if let.dtype is not None:
        expr = ir.Cast(dtype=let.dtype, expr=expr)
      env[let.name] = expr
    return env

  new_local_stmts = []
  cses: Dict[ir.Node, ir.Ref] = OrderedDict()
  emitted: Dict[str, object] = {}  # cr_var name -> its LocalStmt
  for stmt in itertools.chain(stencil.local_stmts, stencil.output_stmts):
    stmt.propagate_type()
    env = let_env(stmt)
    stmt.expr = stmt.expr.visit(cr_visitor, (cses, env))
    stmt.let = tuple(let.visit(cr_visitor, (cses, env)) for let in stmt.let)
    # one LocalStmt per cr_var NAME: a later statement's absolute CSE
    # may re-key an earlier definition (it then reads the shared
    # coefficient variables) or add a new variable whose definition
    # happens to equal an existing one — dedup by name, not expression
    for expr, ref in cses.items():
      prev = emitted.get(ref.name)
      if prev is not None and prev.expr == expr:
        continue
      expr = stencil.propagate_type(expr, stmt)
      if prev is not None:
        prev.expr = expr
        continue
      # declare reuse variables at the C-PROMOTED width: the original
      # (un-rewritten) reduction computed its partial sums in promoted
      # arithmetic with NO intermediate wraps, so a narrow cr_var
      # store would add wraps the source program never had — wrong
      # whenever the reduction feeds a non-ring consumer (e.g.
      # `(a+b+c+d)/256` over uint16 taps; caught by extended fuzzing)
      decl = expr.dtype
      if decl is not None and not decl.is_float:
        from soda_tpu_torch.backend.c_semantics import promote
        decl = promote(decl)
      # record the new variable's type so later vars / stmts referencing
      # it propagate correctly (bottom-up insertion order guarantees
      # dependees come first)
      stencil.symbol_table[ref.name] = decl
      new_local_stmts.append(
          ast.LocalStmt(ref=ref, dtype=decl, expr=expr, let=stmt.let,
                        stencil=stencil))
      emitted[ref.name] = new_local_stmts[-1]
      _logger.debug('computation reuse stmt: %s', new_local_stmts[-1])
  stencil.local_stmts.extend(new_local_stmts)

  stencil.__dict__.pop('symbol_table', None)
  stencil.__dict__.pop('local_names', None)
  stencil.__dict__.pop('local_types', None)

  for stmt in itertools.chain(stencil.local_stmts, stencil.output_stmts):
    stmt.expr = arithmetic.simplify(stmt.expr)
    stmt.let = arithmetic.simplify(stmt.let)
  _logger.info('stencil after CR: \n  %s', str(stencil).replace('\n', '\n  '))
  return stencil
