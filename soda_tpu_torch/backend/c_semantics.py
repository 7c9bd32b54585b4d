"""Shared evaluation semantics for stencil expressions.

The reference's correctness contract is "bit-exact vs the generated C++
scalar host" (reference src/soda/codegen/frt/host.py:558-660): the
host evaluates each statement expression with C arithmetic — integer
operands promoted to (u)int32 before arithmetic, truncating division,
wrap-around only at statement stores and explicit casts — while float
arithmetic runs at the operands' native precision.

This module implements exactly those semantics once, parameterized over
the array namespace, so every executor in the framework shares one
definition of "what a statement means".

The port's copy of soda_tpu/backend/semantics.py, NumPy side only: the
NumPy oracle (backend/reference.py) and the CUDA source printer's
constant folding evaluate with ``xp=np``. The JAX package's x64 gate
(``require_f64_support``) and its ``fast_rsqrt`` rewrite (``lax.rsqrt``)
are left out; the oracle never takes either. The torch Evaluator is
backend/semantics.py.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from soda_tpu_torch import utils
from soda_tpu_torch.ir import nodes as ir
from soda_tpu_torch.ir.types import Type

# C "usual arithmetic conversions": integer types narrower than int are
# promoted to int before any arithmetic. (C11 §6.3.1.1; the generated
# host code at reference frt/host.py:558-624 relies on this.)
_INT = Type('int32')


def promote(t: Type) -> Type:
  """C integer promotion: sub-int widths widen to int32."""
  if t.is_float:
    return t
  if t.width_in_bits < 32:
    return _INT
  # 33..64-bit widths compute in 64-bit storage
  if t.width_in_bits > 32:
    return Type('int64' if t.is_signed else 'uint64')
  return Type('int32' if t.is_signed else 'uint32')


def binary_type(a: Optional[Type], b: Optional[Type]) -> Type:
  """Result type of a C binary arithmetic op after promotion."""
  if a is None and b is None:
    return _INT
  if a is None:
    return promote(b)
  if b is None:
    return promote(a)
  a, b = promote(a), promote(b)
  if a.is_float or b.is_float:
    if not a.is_float:
      return b
    if not b.is_float:
      return a
    return a if a.width_in_bits >= b.width_in_bits else b
  if a.width_in_bits == b.width_in_bits:
    if a.is_signed == b.is_signed:
      return a
    return a if not a.is_signed else b  # unsigned wins at equal rank
  return a if a.width_in_bits > b.width_in_bits else b


def wrap(xp, value, dtype: Type):
  """Convert ``value`` to ``dtype`` with C wrap-around semantics.

  Equivalent to the implicit conversion at a C assignment / ap_int
  truncation at a store: modular wrap for integers (including
  non-power-of-two widths), ordinary conversion for floats.
  """
  if dtype.is_float:
    return xp.asarray(value).astype(dtype.np_dtype)
  value = xp.asarray(value)
  if value.dtype.kind == 'f':
    # C float->int conversion truncates toward zero
    value = xp.trunc(value)
  if dtype.needs_mask:
    n = dtype.width_in_bits
    mask = (1 << n) - 1
    wide = value.astype('int64' if n < 64 else dtype.np_dtype)
    wide = wide & mask
    if dtype.is_signed:
      sign = 1 << (n - 1)
      wide = (wide ^ sign) - sign
    return wide.astype(dtype.np_dtype)
  return value.astype(dtype.np_dtype)


def _as(xp, value, dtype: Type):
  return xp.asarray(value).astype(dtype.np_dtype)


def wrap_promoted(xp, value, dtype: Type, wrap_free: bool = False):
  """Like ``wrap`` but keeps integer results at their C-promoted width.

  A sub-32-bit stage value stored at width w and immediately re-promoted
  by every consumer (C's usual arithmetic conversions) is numerically
  identical to the promoted-width value wrapped into w's range — so an
  executor that keeps stage results in registers can skip the
  narrow/re-widen relayouts entirely: apply the modular wrap in the
  promoted type (3 cheap ALU ops), or nothing at all when the range
  analysis proved the value already fits (``wrap_free``,
  soda_tpu_torch.optimization.ranges). Floats behave exactly like ``wrap``.
  """
  if dtype.is_float:
    return wrap(xp, value, dtype)
  ptype = promote(dtype)
  value = xp.asarray(value)
  if value.dtype.kind == 'f':
    # C float->int conversion truncates toward zero (as does XLA's and
    # NumPy's float->signed-int convert)
    value = xp.trunc(value).astype(ptype.np_dtype)
  elif value.dtype != ptype.np_dtype:
    value = value.astype(ptype.np_dtype)
  n = dtype.width_in_bits
  if wrap_free or n >= ptype.width_in_bits:
    return value
  mask = xp.asarray((1 << n) - 1, dtype=ptype.np_dtype)
  value = value & mask
  if dtype.is_signed:
    sign = xp.asarray(1 << (n - 1), dtype=ptype.np_dtype)
    value = (value ^ sign) - sign
  return value


def _all_types(stencil):
  """Every type the program touches: declared tensors/params, in-expr
  casts, and typed lets (casts to half/double are invisible in the
  symbol table but hit the same backend limits)."""
  for t in stencil.symbol_table.values():
    yield t
  found = []

  def collect(node, _):
    if isinstance(node, ir.Cast) and node.dtype is not None:
      found.append(node.dtype)
    return node

  for stmt in stencil.local_stmts + stencil.output_stmts:
    stmt.expr.visit(collect)
    for let in stmt.let:
      if let.dtype is not None:
        found.append(let.dtype)
      let.visit(collect)
  yield from found


def has_half(stencil) -> bool:
  return any(t is not None and t.is_float and t.width_in_bits == 16
             for t in _all_types(stencil))


def _pow2_exponent(node) -> 'Optional[int]':
  """k if ``node`` is the positive integer literal 2^k (k >= 1)."""
  while isinstance(node, ir.CHAIN_CLASSES) and len(node.operand) == 1:
    node = node.operand[0]
  if isinstance(node, ir.Num) and isinstance(node.value, int):
    v = node.value
    if v >= 2 and (v & (v - 1)) == 0:
      return v.bit_length() - 1
  return None


def c_int_div(xp, a, b):
  """C integer division: truncation toward zero (ISO C99 §6.5.5)."""
  q = a // b
  r = a - q * b
  # floor and trunc differ iff remainder != 0 and signs differ
  fix = (r != 0) & ((a < 0) != (b < 0))
  return q + fix.astype(q.dtype)


def c_int_mod(xp, a, b):
  """C % : remainder with the sign of the dividend."""
  return a - c_int_div(xp, a, b) * b


class Evaluator:
  """Evaluate one statement expression under C semantics.

  Args:
    xp: array namespace (numpy).
    load: callback ``load(ref: ir.Ref) -> array`` producing the (already
      shifted/sliced) value of a tensor access. All arrays a single
      statement loads must be shape-broadcastable against each other.
    env: name -> value for ``let`` bindings and scalar vars.
    param: optional callback ``param(name, idx) -> array`` for kernel
      parameter element access.
    intrinsics: optional overrides for intrinsic call implementations.
  """

  def __init__(self, xp, load: Callable[[ir.Ref], Any],
               env: Optional[Dict[str, Tuple[Any, Optional[Type]]]] = None,
               param: Optional[Callable[[str, Tuple[int, ...]], Any]] = None,
               fast_int_div: bool = False,
               narrow: bool = False):
    self.xp = xp
    self.load = load
    self.env = dict(env or {})
    self.param = param
    # narrow: evaluate integer arithmetic at 16-bit width instead of
    # the C-promoted 32 (2x VPU lane density). ONLY sound for
    # expressions the narrow16_stages analysis admitted (+/&/|/^ over
    # int loads and literals, result needed mod 2^16 at most —
    # optimization/ranges.py): truncating every operand to 16 bits
    # preserves the result's low 16 bits under those ops.
    self.narrow = narrow
    # strength-reduce integer division to a float32 divide where the
    # range analysis proved it bit-exact (soda_tpu_torch.optimization.ranges);
    # the oracle keeps pure C division so tests differentially verify
    # the proof
    self.fast_int_div = fast_int_div

  def bind(self, name: str, value, dtype: Optional[Type]) -> None:
    self.env[name] = (value, dtype)

  def eval_stmt(self, tensor_or_stmt):
    """Evaluate lets then the expression; returns (value, dtype)."""
    lets = getattr(tensor_or_stmt, 'lets', None)
    if lets is None:
      lets = getattr(tensor_or_stmt, 'let', ())
    for let in lets:
      value, dtype = self.eval(let.expr)
      if let.dtype is not None:
        value = wrap(self.xp, value, let.dtype)
        dtype = let.dtype
      self.bind(let.name, value, dtype)
    return self.eval(tensor_or_stmt.expr)

  # -- expression dispatch ----------------------------------------------------
  def eval(self, node: ir.Node) -> Tuple[Any, Optional[Type]]:
    xp = self.xp
    if isinstance(node, ir.Num):
      # untyped int literals participate in promotion lazily (dtype None)
      return node.value, node.dtype
    if isinstance(node, ir.Ref):
      value = self.load(node)
      dtype = node.dtype
      if (dtype is not None and dtype.is_float and
          dtype.width_in_bits == 16):
        # half is a STORAGE format: arithmetic runs at float32 and
        # rounds to f16 at stage stores (TPU-native — the VPU has no
        # f16 arithmetic; same shape as the sub-32-bit int promotion).
        # The oracle applies the identical rule, so all executors
        # share one half-precision semantic.
        value = _as(xp, value, Type('float'))
        dtype = Type('float')
      return value, dtype
    if isinstance(node, ir.Var):
      if node.idx:
        if self.param is None:
          raise utils.InternalError('no param accessor for %s' % node)
        return self.param(node.name, tuple(node.idx)), node.dtype
      if node.name not in self.env:
        raise utils.InternalError('unbound variable: %s' % node.name)
      return self.env[node.name]
    if isinstance(node, ir.Cast):
      value, _ = self.eval(node.expr)
      if self.narrow and node.dtype is not None and \
          not node.dtype.is_float and node.dtype.width_in_bits >= 16:
        # narrow evaluation: an int wrap of width >= 16 is the
        # identity on the 16-bit representation (mod-2^16 congruence
        # passes through); a 16-bit target just fixes the signedness
        if node.dtype.width_in_bits == 16:
          value = _as(xp, value, node.dtype)
        return value, node.dtype
      return wrap(xp, value, node.dtype), node.dtype
    if isinstance(node, ir.Unary):
      value, dtype = self.eval(node.operand)
      if (dtype is not None and not dtype.is_float and
          any(op in '-~' for op in node.operator)):
        # C integer promotion applies to unary operands too
        # (C11 §6.5.3.3): -uint16(1) is -(int)1 == -1, not 65535
        ptype = promote(dtype)
        if ptype.width_in_bits != dtype.width_in_bits or \
            ptype.is_signed != dtype.is_signed:
          value = _as(xp, value, ptype)
          dtype = ptype
      for op in reversed(node.operator):
        if op == '-':
          value = -value
        elif op == '~':
          value = ~value
        elif op == '!':
          # C's ! yields int 0/1 (C11 §6.5.3.3); materialize it so a
          # following -/~ applies integer semantics, not bool ops
          value = _as(xp, xp.logical_not(value), _INT)
          dtype = _INT
        elif op == '+':
          pass
        else:
          raise utils.InternalError('unknown unary operator: %s' % op)
      return value, dtype
    if isinstance(node, ir.Call):
      return self._eval_call(node)
    if isinstance(node, ir.CHAIN_CLASSES):
      return self._eval_chain(node)
    raise utils.InternalError('cannot evaluate %r' % node)

  def _coerce_pair(self, av, at, bv, bt):
    """Bring two operands to their common C arithmetic type (or the
    16-bit narrow type when this evaluator runs narrow)."""
    xp = self.xp
    if self.narrow and (at is None or not at.is_float) and \
        (bt is None or not bt.is_float):
      # 16-bit rank rules: unsigned wins (C at equal rank); sign
      # extension differences vanish mod 2^16
      unsigned = any(t is not None and not t.is_signed for t in (at, bt))
      out = Type('uint16' if unsigned else 'int16')
      return _as(xp, av, out), _as(xp, bv, out), out
    out = binary_type(at, bt)
    return _as(xp, av, out), _as(xp, bv, out), out

  def _eval_chain(self, node) -> Tuple[Any, Optional[Type]]:
    xp = self.xp
    # operands are evaluated LAZILY, one per fold step: long reduction
    # chains (e.g. a 19-tap sum) then keep at most two slab-sized
    # temporaries live, which is what lets Mosaic bound VMEM stack usage
    div_ok = getattr(node, 'div_f32_ok', None) if self.fast_int_div \
        else None
    acc, acc_t = self.eval(node.operand[0])
    for pos, (opd, op) in enumerate(zip(node.operand[1:], node.operator)):
      val, val_t = self.eval(opd)
      acc, val, out = self._coerce_pair(acc, acc_t, val, val_t)
      if op == '+':
        acc = acc + val
      elif op == '-':
        acc = acc - val
      elif op == '*':
        acc = acc * val
      elif op == '/':
        k = _pow2_exponent(opd) if self.fast_int_div else None
        if out.is_float:
          acc = acc / val
        elif k is not None:
          # division by a constant 2^k: exact truncating shift (the
          # bias rounds negatives toward zero, ISO C99 §6.5.5) — the
          # VPU has no integer divider, so the general lowering is a
          # long op sequence; this is 1-3 cheap ALU ops
          if out.is_signed:
            bias = xp.right_shift(acc, out.width_in_bits - 1) & \
                ((1 << k) - 1)
            acc = xp.right_shift(acc + bias, k)
          else:
            acc = xp.right_shift(acc, k)
        elif div_ok is not None and pos < len(div_ok) and div_ok[pos]:
          # provably exact in float32 (see optimization/ranges.py)
          f32 = Type('float').np_dtype
          acc = (acc.astype(f32) / val.astype(f32)).astype(out.np_dtype)
        else:
          acc = c_int_div(xp, acc, val)
      elif op == '%':
        acc = c_int_mod(xp, acc, val)
      elif op == '&':
        acc = acc & val
      elif op == '|':
        acc = acc | val
      elif op == '^':
        acc = acc ^ val
      elif op == '==':
        acc, out = acc == val, Type('uint1')
      elif op == '!=':
        acc, out = acc != val, Type('uint1')
      elif op == '<':
        acc, out = acc < val, Type('uint1')
      elif op == '<=':
        acc, out = acc <= val, Type('uint1')
      elif op == '>':
        acc, out = acc > val, Type('uint1')
      elif op == '>=':
        acc, out = acc >= val, Type('uint1')
      elif op == '&&':
        acc, out = xp.logical_and(acc, val), Type('uint1')
      elif op == '||':
        acc, out = xp.logical_or(acc, val), Type('uint1')
      else:
        raise utils.InternalError('unknown operator: %s' % op)
      acc_t = out
    return acc, acc_t

  def _eval_call(self, node: ir.Call) -> Tuple[Any, Optional[Type]]:
    xp = self.xp
    name = node.name
    if name in ('min', 'max'):
      # lazy fold (see _eval_chain): bounds live temporaries.
      # NOTE: min/max would be bit-identical without integer promotion
      # (and 2x faster at 16 bits), but current Mosaic cannot legalize
      # sub-32-bit arith.minsi — so ints keep the C promotion.
      fn = xp.minimum if name == 'min' else xp.maximum
      acc, acc_t = self.eval(node.operand[0])
      for opd in node.operand[1:]:
        val, val_t = self.eval(opd)
        acc, val, acc_t = self._coerce_pair(acc, acc_t, val, val_t)
        acc = fn(acc, val)
      return acc, acc_t
    args = [self.eval(o) for o in node.operand]
    if name == 'select':
      cond = args[0][0]
      av, at = args[1]
      bv, bt = args[2]
      av, bv, out = self._coerce_pair(av, at, bv, bt)
      return xp.where(cond, av, bv), out
    if name == 'abs':
      val, t = args[0]
      if t is not None and not t.is_float:
        # C's abs promotes to int first: abs(int8 -128) is +128
        pt = promote(t)
        if pt.width_in_bits != t.width_in_bits:
          val, t = _as(xp, val, pt), pt
      return xp.abs(val), t
    if name == 'pow':
      (av, at), (bv, bt) = args
      out = binary_type(at, bt)
      if not out.is_float:
        out = Type('float')
      return xp.power(_as(xp, av, out), _as(xp, bv, out)), out
    # unary float intrinsics: ints promote to float32 (C float overload)
    val, t = args[0]
    out = t if (t is not None and t.is_float) else Type('float')
    val = _as(xp, val, out)
    table = {
        'sqrt': xp.sqrt, 'rsqrt': lambda x: 1 / xp.sqrt(x), 'exp': xp.exp,
        'log': xp.log, 'sin': xp.sin, 'cos': xp.cos, 'tan': xp.tan,
        'tanh': xp.tanh, 'floor': xp.floor, 'ceil': xp.ceil,
        'round': xp.round,
    }
    if name not in table:
      raise utils.InternalError('unknown intrinsic: %s' % name)
    return table[name](val), out
