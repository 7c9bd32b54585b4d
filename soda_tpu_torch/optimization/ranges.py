"""Value-range analysis over the tensor DAG.

Interval arithmetic from the inputs' declared integer widths through
every stage expression. Its product is the ``div_f32_ok`` annotation on
MulDiv nodes: an integer division whose dividend and divisor provably
fit in float32's 24-bit mantissa can be computed as a float32 divide +
truncate with bit-exact C semantics — on TPU this turns the VPU's very
expensive integer divide into one multiply-class op (the blur kernel's
``/ 3`` costs ~3x its whole HBM budget otherwise).

Exactness argument: for |n|, |d| < 2^23, the correctly-rounded float32
quotient fl(n/d) never crosses an integer boundary away from n/d —
if d | n the quotient is an exactly-representable integer, otherwise
its distance to the nearest integer is >= 1/|d| > ulp(n/d)/2 — so
trunc(fl(n/d)) == C's truncating division, negatives included.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

from soda_tpu_torch.ir import nodes as ir
from soda_tpu_torch.ir.types import Type

_logger = logging.getLogger().getChild(__name__)

_LIMIT = 1 << 23  # float32 mantissa bound
_UNBOUNDED = (float('-inf'), float('inf'))

Range = Tuple[float, float]


def _type_range(dtype: Optional[Type]) -> Range:
  if dtype is None or dtype.is_float:
    return _UNBOUNDED
  n = dtype.width_in_bits
  if dtype.is_signed:
    return (-(1 << (n - 1)), (1 << (n - 1)) - 1)
  return (0, (1 << n) - 1)


def _clip_to_type(r: Range, dtype: Optional[Type]) -> Range:
  """Range after a wrap to ``dtype``: unchanged if it already fits,
  else the full type range (wrap-around loses all information)."""
  tr = _type_range(dtype)
  if tr[0] <= r[0] and r[1] <= tr[1]:
    return r
  return tr


def _add(a: Range, b: Range) -> Range:
  return (a[0] + b[0], a[1] + b[1])


def _sub(a: Range, b: Range) -> Range:
  return (a[0] - b[1], a[1] - b[0])


def _mul(a: Range, b: Range) -> Range:
  products = [x * y for x in a for y in b]
  return (min(products), max(products))


def _div(a: Range, b: Range) -> Range:
  if b[0] <= 0 <= b[1]:
    return _UNBOUNDED
  quotients = [x / y for x in a for y in b]
  return (min(quotients), max(quotients))


class _Analyzer:

  def __init__(self, stencil, tensor_ranges: Dict[str, Range]):
    self.stencil = stencil
    self.tensor_ranges = tensor_ranges
    self.env: Dict[str, Range] = {}

  def range_of(self, node: ir.Node) -> Range:
    if isinstance(node, ir.Num):
      return (node.value, node.value)
    if isinstance(node, ir.Ref):
      if node.name in self.stencil.param_names:
        return _type_range(self.stencil.symbol_table.get(node.name))
      return self.tensor_ranges.get(node.name, _UNBOUNDED)
    if isinstance(node, ir.Var):
      return self.env.get(node.name, _UNBOUNDED)
    if isinstance(node, ir.Cast):
      return _clip_to_type(self.range_of(node.expr), node.dtype)
    if isinstance(node, ir.Unary):
      r = self.range_of(node.operand)
      for op in node.operator:
        if op == '-':
          r = (-r[1], -r[0])
        elif op in ('~', '!'):
          r = _UNBOUNDED
      return r
    if isinstance(node, ir.Call):
      rs = [self.range_of(o) for o in node.operand]
      if node.name == 'min':
        return (min(r[0] for r in rs), min(r[1] for r in rs))
      if node.name == 'max':
        return (max(r[0] for r in rs), max(r[1] for r in rs))
      if node.name == 'abs':
        lo, hi = rs[0]
        m = max(abs(lo), abs(hi))
        return (0 if lo <= 0 <= hi else min(abs(lo), abs(hi)), m)
      return _UNBOUNDED
    if isinstance(node, (ir.EqCmp, ir.LtCmp, ir.Expr, ir.LogicAnd)):
      if len(node.operand) == 1:
        # bare chain wrapper (parenthesized subexpression), not a
        # comparison: the range passes through
        return self.range_of(node.operand[0])
      self._descend(node)
      return (0, 1)
    if isinstance(node, ir.AddSub):
      acc = self.range_of(node.operand[0])
      for op, opd in zip(node.operator, node.operand[1:]):
        r = self.range_of(opd)
        acc = _add(acc, r) if op == '+' else _sub(acc, r)
      return acc
    if isinstance(node, ir.MulDiv):
      acc = self.range_of(node.operand[0])
      any_float = _is_float_node(node.operand[0])
      flags = []
      for op, opd in zip(node.operator, node.operand[1:]):
        r = self.range_of(opd)
        any_float = any_float or _is_float_node(opd)
        if op == '*':
          acc = _mul(acc, r)
          flags.append(False)
        elif op == '/':
          ok = (not any_float and
                -_LIMIT < acc[0] and acc[1] < _LIMIT and
                -_LIMIT < r[0] and r[1] < _LIMIT and
                not (r[0] <= 0 <= r[1]))
          flags.append(bool(ok))
          acc = _div(acc, r)
        else:  # '%'
          flags.append(False)
          acc = _UNBOUNDED if r[0] <= 0 <= r[1] else \
              (-max(abs(r[0]), abs(r[1])), max(abs(r[0]), abs(r[1])))
      node.div_f32_ok = tuple(flags)
      return acc
    if isinstance(node, ir.CHAIN_CLASSES):
      self._descend(node)
      return _UNBOUNDED
    return _UNBOUNDED

  def _descend(self, node) -> None:
    for opd in getattr(node, 'operand', ()):
      self.range_of(opd)


def _is_float_node(node: ir.Node) -> bool:
  return node.dtype is not None and node.dtype.is_float


# -- wrap sinking -------------------------------------------------------------
#
# Wrapping an integer to width n is reduction mod 2^n, and Z/2^m -> Z/2^n
# (n <= m) is a ring homomorphism: +, -, *, unary -/~ and the bitwise
# chains commute with it, so an intermediate stage's store wrap can be
# SUNK into its consumers' wraps whenever every use of the value only
# passes through such ops before hitting another wrap of width <= n.
# (This is why the reference's CR rewrite of integer reductions into
# narrow local stmts is exact: per-partial-sum wraps compose to the
# same final value — computation_reuse.py:755-813 relies on it.)
# Division, %, comparisons, min/max and float casts need the true
# value, so any use through them pins the producer to an exact wrap.

_EXACT = 10**9  # "must be the true value" (congruence mod 2^inf)


def _chain_ctx(node: ir.Node, j: int, ctx: int) -> int:
  """Required congruence exponent for operand ``j`` of a chain node
  whose result must be correct mod 2^ctx."""
  if isinstance(node, (ir.BinaryOr, ir.Xor, ir.BinaryAnd, ir.AddSub)):
    return ctx  # bit-local / ring ops
  if isinstance(node, ir.MulDiv):
    # operand j joins via operator[j-1] and is then subject to
    # operator[j:]; any '/' or '%' there needs the exact value
    tail = node.operator[max(j - 1, 0):]
    return ctx if all(op == '*' for op in tail) else _EXACT
  if isinstance(node, (ir.Expr, ir.LogicAnd)) and len(node.operand) == 1:
    return ctx  # bare wrapper, no || / && applied
  return _EXACT  # comparisons, logical ops: truthiness is value-exact


def _walk_uses(node: ir.Node, ctx: int, out: Dict[str, int]) -> None:
  """Record, per referenced tensor, the strictest congruence exponent
  this expression demands of it when the expression's own result only
  needs to be correct mod 2^ctx."""
  if isinstance(node, ir.Ref):
    out[node.name] = max(out.get(node.name, 0), ctx)
    return
  if isinstance(node, ir.Num):
    return
  if isinstance(node, ir.Cast):
    if node.dtype is None or node.dtype.is_float:
      _walk_uses(node.expr, _EXACT, out)
    else:
      # an int cast wraps mod 2^k itself: correctness mod 2^k of the
      # input fully determines the output, so the cast LOWERS the
      # requirement (int32(x) of a sunk int16 is exact given mod 2^16)
      _walk_uses(node.expr, min(ctx, node.dtype.width_in_bits), out)
    return
  if isinstance(node, ir.Unary):
    sub = ctx if all(op in '-~' for op in node.operator) else _EXACT
    _walk_uses(node.operand, sub, out)
    return
  if isinstance(node, ir.CHAIN_CLASSES):
    for j, opd in enumerate(node.operand):
      _walk_uses(opd, _chain_ctx(node, j, ctx), out)
    return
  if isinstance(node, (ir.Call, ir.EqCmp, ir.LtCmp)):
    for opd in getattr(node, 'operand', ()):
      _walk_uses(opd, _EXACT, out)
    return
  # Var (let-bound), Let, or anything unrecognized: demand exactness
  for attr in getattr(node, 'ATTRS', ()):
    val = getattr(node, attr)
    if isinstance(val, ir.Node):
      _walk_uses(val, _EXACT, out)
    elif isinstance(val, tuple):
      for v in val:
        if isinstance(v, ir.Node):
          _walk_uses(v, _EXACT, out)


def _sink_wraps(stencil, wrap_free: Dict[str, bool]) -> Dict[str, bool]:
  """Mark stages whose store wrap is sunk into downstream wraps.

  Processes tensors in reverse topological order, so every consumer's
  effective wrap width is final before its producers are judged:
  effective(C) = width(C) when C actually wraps, else the strictest
  congruence C's own consumers demand of it (need(C)). A stage sinks
  when need <= its width; outputs always wrap (their HBM store narrows
  to storage width and must see the wrapped value).
  """
  outputs = set(stencil.output_names)
  need: Dict[str, int] = {}
  effective: Dict[str, int] = {}
  sunk: Dict[str, bool] = {}
  stencil._wrap_need = need  # consumed by the narrow-eval analysis
  for tensor in reversed(list(stencil.chronological_tensors)):
    if tensor.is_input():
      continue
    n = need.get(tensor.name, 0)
    w = tensor.dtype.width_in_bits
    ok = (not tensor.dtype.is_float and n <= w and
          tensor.name not in outputs)
    sunk[tensor.name] = ok
    if ok and not wrap_free.get(tensor.name, False):
      _logger.debug('wrap of %s sunk into consumers (need mod 2^%d)',
                    tensor.name, n)
    # the congruence producers must give US: our storage width when we
    # actually apply a wrap; otherwise (wrap skipped — by sinking OR by
    # the range-fit elision, which assumed exact producers) whatever
    # our own consumers demand passes straight through our ring expr
    if tensor.dtype.is_float:
      effective[tensor.name] = _EXACT
    elif tensor.name in outputs:
      # a wrapping output narrows exactly; a range-elided output's
      # astype-to-storage relies on the value being in range, which
      # needs exact producers
      effective[tensor.name] = (
          _EXACT if wrap_free.get(tensor.name, False) else w)
    elif ok or wrap_free.get(tensor.name, False):
      effective[tensor.name] = n
    else:
      effective[tensor.name] = w
    ctx = effective[tensor.name]
    uses: Dict[str, int] = {}
    _walk_uses(tensor.expr, ctx, uses)
    for let in tensor.lets:
      _walk_uses(let.expr, _EXACT, uses)
    for parent, req in uses.items():
      need[parent] = max(need.get(parent, 0), req)
  return sunk


# ops Mosaic legalizes on native 16-bit vectors (probed on v5e,
# experiments/exp12-13): add and the bitwise chains — NOT sub, shifts,
# mul, min/max, or any comparison
_NARROW_CHAIN_OK = (ir.AddSub, ir.BinaryAnd, ir.BinaryOr, ir.Xor)


def _narrow_expr_ok(node: ir.Node, int_tensors: set) -> bool:
  """True when ``node`` evaluates correctly mod 2^16 using only
  Mosaic-legal i16 vector ops: {+, &, |, ^} over integer tensor loads
  and literals. (+ carries propagate upward only and the bitwise chains
  are bit-local, so truncating every operand to 16 bits preserves the
  low 16 bits of the result — the Z/2^32 -> Z/2^16 homomorphism.)"""
  if isinstance(node, ir.Num):
    return isinstance(node.value, int)
  if isinstance(node, ir.Ref):
    return node.name in int_tensors
  if isinstance(node, ir.Cast):
    # an int wrap of width >= 16 preserves congruence mod 2^16 (the
    # narrow evaluator keeps the 16-bit representation through it)
    return (node.dtype is not None and not node.dtype.is_float and
            node.dtype.width_in_bits >= 16 and
            _narrow_expr_ok(node.expr, int_tensors))
  if isinstance(node, _NARROW_CHAIN_OK) or (
      isinstance(node, (ir.Expr, ir.LogicAnd)) and len(node.operand) == 1):
    if isinstance(node, ir.AddSub) and any(
        op != '+' for op in node.operator):
      return False  # Mosaic i16 sub crashes (exp13)
    return all(_narrow_expr_ok(o, int_tensors) for o in node.operand)
  return False


def narrow16_stages(stencil) -> set:
  """Stages evaluable at NATIVE 16-bit integer width (2x VPU lane
  density) with bit-exact results.

  A stage qualifies when (a) its expression is mod-2^16-exact and
  i16-legal on Mosaic (see _narrow_expr_ok), it has no lets, and (b)
  its value is only ever needed mod 2^16: either its declared width is
  16 (the store wrap discards the rest anyway), or the wrap-sinking
  analysis proved every consumer path tolerates congruence mod 2^16
  (``_wrap_need`` — this is what lets 32-bit-declared CR partial sums
  run narrow when they flow into a 16-bit-wrapped output).
  """
  annotate(stencil)
  need = getattr(stencil, '_wrap_need', {})
  int_tensors = {
      name for name, t in stencil.symbol_table.items()
      if t is not None and not t.is_float and t.width_in_bits <= 32
      and name not in stencil.param_names
  }
  out = set()
  for tensor in stencil.chronological_tensors:
    if tensor.is_input():
      continue
    t = tensor.dtype
    if t is None or t.is_float:
      continue
    narrow_enough = (t.width_in_bits == 16 or
                     (t.width_in_bits > 16 and
                      need.get(tensor.name, _EXACT) <= 16))
    if t.width_in_bits > 16 and tensor.name in stencil.output_names:
      # _wrap_need is driven by IN-GRAPH consumers only; a >16-bit
      # OUTPUT is also stored to HBM at full declared width, so a
      # 16-bit-needing in-graph consumer must not narrow it (the
      # store would sign-extend a truncated value)
      narrow_enough = False
    if not narrow_enough or tensor.lets:
      continue
    if _narrow_expr_ok(tensor.expr, int_tensors):
      out.add(tensor.name)
  return out


def annotate(stencil) -> Dict[str, Range]:
  """Annotate every tensor's expression tree; returns tensor ranges.

  Idempotent (cached on the stencil). Must run after all IR passes:
  the annotations live on the final tensor expression nodes.
  """
  cached = getattr(stencil, '_tensor_ranges', None)
  if cached is not None:
    return cached
  ranges: Dict[str, Range] = {}
  wrap_free: Dict[str, bool] = {}
  for name in stencil.input_names:
    ranges[name] = _type_range(stencil.symbol_table[name])
  for tensor in stencil.chronological_tensors:
    if tensor.is_input():
      continue
    analyzer = _Analyzer(stencil, ranges)
    for let in tensor.lets:
      r = analyzer.range_of(let.expr)
      if let.dtype is not None:
        r = _clip_to_type(r, let.dtype)
      analyzer.env[let.name] = r
    r = analyzer.range_of(tensor.expr)
    # the store wrap is a provable no-op when the computed range
    # already fits the declared type — executors can then keep the
    # value at its C-promoted width with no mask/convert at all
    tr = _type_range(tensor.dtype)
    wrap_free[tensor.name] = bool(tr[0] <= r[0] and r[1] <= tr[1])
    ranges[tensor.name] = _clip_to_type(r, tensor.dtype)
  # ...or when every consumer tolerates the unwrapped value (the ring
  # homomorphism argument above). Note the range-fit elision of a
  # consumer stays sound when a producer sinks: the producer only sank
  # because that consumer's own need() chain tolerated congruence.
  for name, ok in _sink_wraps(stencil, wrap_free).items():
    if ok:
      wrap_free[name] = True
  stencil._tensor_ranges = ranges
  stencil._wrap_free = wrap_free
  return ranges
