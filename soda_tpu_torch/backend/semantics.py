"""C-semantics evaluation of stencil expressions on torch tensors.

The counterpart of soda_tpu/backend/semantics.py, whose ``Evaluator``
takes an array namespace (``numpy``/``jax.numpy``). The type rules are
not repeated: ``promote`` and ``binary_type`` are imported from the
port's copy of that module's NumPy side (backend/c_semantics.py), and
this Evaluator follows the same dispatch, so the NumPy oracle stays the
one definition of what a statement means.

What torch forces:

- torch has storage, but no arithmetic, for uint16/uint32/uint64
  (``add``, ``minimum``, ``//`` and comparisons raise). Values are
  therefore carried in a *representation* dtype: uint16 as int32,
  uint32 as int64 masked to 32 bits, uint64 as the int64 bit pattern
  (compared and divided as unsigned). ``to_repr``/``to_storage`` cross
  between the two with same-size views only.
- integer division by zero raises on the CPU and is undefined on CUDA,
  so ``c_int_div``/``c_int_mod`` reproduce what the oracle computes
  (numpy gives ``a // 0 == 0``; the C-truncation fix-up then makes it 1
  for negative signed ``a``; ``a % 0 == a``).
- the TPU-only rewrites ``fast_int_div`` and ``fast_rsqrt`` are not
  carried over: this Evaluator computes the oracle's form. ``narrow``
  is (c_semantics.Evaluator's): the packed 16-bit stages of the fused
  kernel's layout form L3 evaluate at 16-bit width.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.backend.c_semantics import binary_type, promote
from soda_tpu_torch.ir import nodes as ir
from soda_tpu_torch.ir.types import Type

__all__ = ['Evaluator', 'binary_type', 'c_int_div', 'c_int_mod', 'promote',
           'require_device_support', 'to_repr', 'to_storage', 'wrap',
           'wrap_promoted']

_INT = Type('int32')
_FLOAT = Type('float')
_I64_MIN = -(1 << 63)

_STORAGE = {
    'int8': torch.int8, 'int16': torch.int16, 'int32': torch.int32,
    'int64': torch.int64, 'uint8': torch.uint8, 'uint16': torch.uint16,
    'uint32': torch.uint32, 'uint64': torch.uint64,
    'float16': torch.float16, 'float32': torch.float32,
    'float64': torch.float64, 'bool': torch.bool,
}
# storage dtype -> (representation dtype, same-size signed view)
_UNSIGNED = {
    'uint16': (torch.int32, torch.int16),
    'uint32': (torch.int64, torch.int32),
    'uint64': (torch.int64, torch.int64),
}


def storage_dtype(dtype: Type) -> torch.dtype:
  """torch storage dtype of a stencil type (numpy's np_dtype)."""
  return _STORAGE[dtype.np_dtype.name]


def repr_dtype(dtype: Type) -> torch.dtype:
  """torch dtype that carries values of ``dtype`` through arithmetic."""
  name = dtype.np_dtype.name
  if name in _UNSIGNED:
    return _UNSIGNED[name][0]
  return _STORAGE[name]


def _is_u64(dtype: Optional[Type]) -> bool:
  return (dtype is not None and not dtype.is_float and
          not dtype.is_signed and dtype.storage_width == 64)


def _mask_bits(dtype: Type) -> Optional[int]:
  """Mask keeping a representation in range (uint16/uint32 only)."""
  if dtype.is_float or dtype.is_signed:
    return None
  w = dtype.storage_width
  return (1 << w) - 1 if w in (16, 32) else None


def to_repr(tensor: torch.Tensor, dtype: Type) -> torch.Tensor:
  """Storage tensor of ``dtype`` -> its representation."""
  name = dtype.np_dtype.name
  if name in _UNSIGNED:
    rep, view = _UNSIGNED[name]
    value = tensor.view(view).to(rep)
    mask = _mask_bits(dtype)
    return value & mask if mask is not None else value
  return tensor.to(_STORAGE[name])


def to_storage(tensor: torch.Tensor, dtype: Type) -> torch.Tensor:
  """Representation (already wrapped to ``dtype``) -> storage tensor."""
  name = dtype.np_dtype.name
  if name in _UNSIGNED:
    _, view = _UNSIGNED[name]
    return tensor.to(view).view(_STORAGE[name])
  return tensor.to(_STORAGE[name])


def require_device_support(device: torch.device) -> None:
  """The generated kernel targets ``sm_90a`` (Hopper), where f64 and
  i64 arithmetic are native, so every stencil type runs there; the CPU
  runs every type through torch. Other devices are refused."""
  if device.type == 'cpu':
    return
  if device.type != 'cuda':
    raise utils.InputError('unsupported device %s (cpu or cuda)' % device)
  if not torch.cuda.is_available():
    raise utils.InputError('device %s requested, but no CUDA device is '
                           'available' % device)
  cap = torch.cuda.get_device_capability(device)
  if cap != (9, 0):
    raise utils.InputError(
        'the fused kernel is built for sm_90a (Hopper), but %s has '
        'compute capability %d.%d' % (torch.cuda.get_device_name(device),
                                      cap[0], cap[1]))


# (device, how, numpy dtype, bytes) -> 0-d tensor. A scalar crosses to a
# CUDA device as a copy the host waits for, so each constant crosses
# once per process, not once per use. Nothing writes into these.
_SCALARS: Dict[tuple, torch.Tensor] = {}


class _Ctx:
  """Device on which Python constants become tensors."""

  def __init__(self, device):
    self.device = torch.device(device)

  def _cached(self, arr: np.ndarray, how: str, make) -> torch.Tensor:
    if arr.ndim:
      return make()
    key = (self.device, how, arr.dtype.str, arr.tobytes())
    if key not in _SCALARS:
      _SCALARS[key] = make()
    return _SCALARS[key]

  def const(self, value, dtype: Type) -> torch.Tensor:
    """A Python or numpy scalar converted exactly as numpy's
    ``asarray(value).astype(dtype)`` converts it."""
    arr = np.asarray(value).astype(dtype.np_dtype)
    name = dtype.np_dtype.name

    def make():
      if name not in _UNSIGNED:
        return torch.as_tensor(arr, device=self.device)
      rep, _ = _UNSIGNED[name]
      out = torch.as_tensor(arr.view(np.dtype('int%d' % (arr.itemsize * 8))),
                            device=self.device).to(rep)
      mask = _mask_bits(dtype)
      return out & mask if mask is not None else out

    return self._cached(arr, 'const', make)

  def tensor(self, value) -> torch.Tensor:
    """A value as numpy's ``asarray`` would type it."""
    if isinstance(value, torch.Tensor):
      return value
    arr = np.asarray(value)
    return self._cached(arr, 'tensor',
                        lambda: torch.as_tensor(arr, device=self.device))


def _to_int(value: torch.Tensor, dtype: Type) -> torch.Tensor:
  """Integer/bool/float tensor -> representation of integer ``dtype``
  with C (modular) conversion; floats truncate toward zero."""
  if value.is_floating_point():
    value = torch.trunc(value).to(torch.int64)
  rep = repr_dtype(dtype)
  mask = _mask_bits(dtype)
  if mask is not None:
    return (value.to(torch.int64) & mask).to(rep)
  return value.to(rep)


def _as(ctx: _Ctx, value, dtype: Type, src: Optional[Type] = None):
  """numpy's ``asarray(value).astype(dtype)`` on representations."""
  if not isinstance(value, torch.Tensor):
    return ctx.const(value, dtype)
  if dtype.is_float:
    fdt = repr_dtype(dtype)
    if _is_u64(src):
      wide = value.to(torch.float64) + torch.where(
          value < 0, 2.0 ** 64, 0.0).to(torch.float64)
      return wide.to(fdt)
    return value.to(fdt)
  return _to_int(value, dtype)


def wrap(value, dtype: Type, src: Optional[Type] = None,
         device='cpu') -> torch.Tensor:
  """C conversion to ``dtype``: modular wrap for integers (including
  widths that are not a power of two), truncation of floats, ordinary
  conversion to floats. Mirrors c_semantics.wrap."""
  ctx = _Ctx(device)
  if dtype.is_float:
    return _as(ctx, value, dtype, src)
  value = ctx.tensor(value)
  if value.is_floating_point():
    value = torch.trunc(value).to(torch.int64)
  if dtype.needs_mask:
    n = dtype.width_in_bits
    wide = value.to(torch.int64) & ((1 << n) - 1)
    if dtype.is_signed:
      sign = 1 << (n - 1)
      wide = (wide ^ sign) - sign
    return wide.to(repr_dtype(dtype))
  return _to_int(value, dtype)


def wrap_promoted(value, dtype: Type, device='cpu') -> torch.Tensor:
  """Like ``wrap`` but keeps integers at their C-promoted width: the
  value wrapped into ``dtype``'s range, carried as ``promote(dtype)``
  (c_semantics.wrap_promoted, without the range-proof
  shortcut)."""
  if dtype.is_float:
    return wrap(value, dtype, device=device)
  return _as(_Ctx(device), wrap(value, dtype, device=device),
             promote(dtype), dtype)


def _u64_lt(a, b):
  return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def _u64_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Unsigned 64-bit division on int64 bit patterns (b != 0)."""
  big = b < 0  # b >= 2**63: the quotient is 0 or 1
  one = torch.ones_like(b)
  bs = torch.where(big, one, b)
  half = (a >> 1) & ((1 << 63) - 1)  # logical shift right
  q = torch.div(half, bs, rounding_mode='trunc') * 2
  r = a - q * bs  # in [0, 2b): one correction
  q = q + (~_u64_lt(r, bs)).to(q.dtype)
  return torch.where(big, (~_u64_lt(a, b)).to(q.dtype), q)


def c_int_div(a: torch.Tensor, b: torch.Tensor, dtype: Type) -> torch.Tensor:
  """C integer division (truncation toward zero, ISO C99 §6.5.5) of
  two representations of ``dtype``, with the oracle's results where C
  has none: ``a / 0`` is 1 for negative signed ``a`` and 0 otherwise,
  and ``MIN / -1`` wraps to MIN."""
  zero = b == 0
  if _is_u64(dtype):
    q = _u64_div(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(q), q)
  neg1 = (b == -1) if dtype.is_signed else torch.zeros_like(zero)
  safe = torch.where(zero | neg1, torch.ones_like(b), b)
  q = torch.div(a, safe, rounding_mode='trunc')
  q = torch.where(neg1, -a, q)
  if dtype.is_signed:
    by_zero = (a < 0).to(q.dtype)
  else:
    by_zero = torch.zeros_like(q)
  return torch.where(zero, by_zero, q)


def c_int_mod(a: torch.Tensor, b: torch.Tensor, dtype: Type) -> torch.Tensor:
  """C ``%``: remainder with the sign of the dividend (``a % 0 == a``)."""
  r = a - c_int_div(a, b, dtype) * b
  mask = _mask_bits(dtype)
  return r & mask if mask is not None else r


def _sqrt(x: torch.Tensor) -> torch.Tensor:
  """IEEE square root. torch's vectorized CPU float32 sqrt is off by an
  ulp at times; through float64 it rounds correctly (53 >= 2 * 24 + 2
  bits, so the double rounding is exact), as numpy's and CUDA's do."""
  if x.dtype in (torch.float16, torch.float32):
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)
  return torch.sqrt(x)


def _truth(value: torch.Tensor) -> torch.Tensor:
  return value if value.dtype == torch.bool else value != 0


class Evaluator:
  """Evaluate one statement expression under C semantics on tensors.

  The torch counterpart of c_semantics.Evaluator; values
  are ``(tensor or Python scalar, Type)`` pairs, tensors in the
  representation dtype of their type (see the module docstring).

  Args:
    load: ``load(ref) -> tensor`` giving the shifted value of a tensor
      access (representation dtype of ``ref.dtype``).
    env: name -> (value, dtype) for ``let`` bindings and scalar vars.
    param: ``param(name, idx) -> tensor`` for parameter elements.
    device: where Python constants are materialized.
    narrow: evaluate integer arithmetic at 16-bit width (only sound for
      the expressions optimization.ranges.narrow16_stages admits: + & |
      ^ over integer loads and literals, needed mod 2^16 at most).
  """

  def __init__(self, load: Callable[[ir.Ref], Any],
               env: Optional[Dict[str, Tuple[Any, Optional[Type]]]] = None,
               param: Optional[Callable[[str, Tuple[int, ...]], Any]] = None,
               device='cpu', narrow: bool = False):
    self.load = load
    self.env = dict(env or {})
    self.param = param
    self.narrow = narrow
    self._ctx = _Ctx(device)

  def _as(self, value, dtype: Type, src: Optional[Type] = None):
    return _as(self._ctx, value, dtype, src)

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
        value = wrap(value, let.dtype, dtype, self._ctx.device)
        dtype = let.dtype
      self.bind(let.name, value, dtype)
    return self.eval(tensor_or_stmt.expr)

  def eval(self, node: ir.Node) -> Tuple[Any, Optional[Type]]:
    if isinstance(node, ir.Num):
      return node.value, node.dtype
    if isinstance(node, ir.Ref):
      value = self.load(node)
      dtype = node.dtype
      if dtype is not None and dtype.is_float and dtype.width_in_bits == 16:
        # half is a storage format: arithmetic runs at float32
        return self._as(value, _FLOAT), _FLOAT
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
      value, src = self.eval(node.expr)
      if self.narrow and not node.dtype.is_float and \
          node.dtype.width_in_bits >= 16:
        # an int wrap of width >= 16 keeps the 16-bit representation (a
        # 16-bit target fixes its signedness)
        if node.dtype.width_in_bits == 16:
          value = self._as(value, node.dtype, src)
        return value, node.dtype
      return wrap(value, node.dtype, src, self._ctx.device), node.dtype
    if isinstance(node, ir.Unary):
      return self._eval_unary(node)
    if isinstance(node, ir.Call):
      return self._eval_call(node)
    if isinstance(node, ir.CHAIN_CLASSES):
      return self._eval_chain(node)
    raise utils.InternalError('cannot evaluate %r' % node)

  def _eval_unary(self, node) -> Tuple[Any, Optional[Type]]:
    value, dtype = self.eval(node.operand)
    if (dtype is not None and not dtype.is_float and
        any(op in '-~' for op in node.operator)):
      # C integer promotion applies to unary operands (C11 §6.5.3.3)
      ptype = promote(dtype)
      if ptype != dtype:
        value = self._as(value, ptype, dtype)
        dtype = ptype
    for op in reversed(node.operator):
      if op == '-':
        value = -value
      elif op == '~':
        value = ~value
      elif op == '!':
        if isinstance(value, torch.Tensor):
          value = self._as(~_truth(value), _INT)
        else:
          value = self._as(not value, _INT)
        dtype = _INT
      elif op != '+':
        raise utils.InternalError('unknown unary operator: %s' % op)
      mask = None if dtype is None else _mask_bits(dtype)
      if mask is not None and isinstance(value, torch.Tensor):
        value = value & mask
    return value, dtype

  def _coerce_pair(self, av, at, bv, bt):
    if self.narrow and (at is None or not at.is_float) and \
        (bt is None or not bt.is_float):
      # 16-bit rank rules: unsigned wins at equal rank
      unsigned = any(t is not None and not t.is_signed for t in (at, bt))
      out = Type('uint16' if unsigned else 'int16')
    else:
      out = binary_type(at, bt)
    return self._as(av, out, at), self._as(bv, out, bt), out

  def _eval_chain(self, node) -> Tuple[Any, Optional[Type]]:
    acc, acc_t = self.eval(node.operand[0])
    for opd, op in zip(node.operand[1:], node.operator):
      val, val_t = self.eval(opd)
      acc, val, out = self._coerce_pair(acc, acc_t, val, val_t)
      acc, acc_t = self._binary(op, acc, val, out)
    return acc, acc_t

  def _binary(self, op: str, a, b, out: Type):
    u64 = _is_u64(out)
    mask = _mask_bits(out)
    if op in '+-*':
      if op == '+':
        r = a + b
      elif op == '-':
        r = a - b
      else:
        r = a * b
      return (r & mask if mask is not None else r), out
    if op == '/':
      if out.is_float:
        return a / b, out
      return c_int_div(a, b, out), out
    if op == '%':
      return c_int_mod(a, b, out), out
    if op == '&':
      return a & b, out
    if op == '|':
      return a | b, out
    if op == '^':
      return a ^ b, out
    bit = Type('uint1')
    if op in ('==', '!='):
      return (a == b if op == '==' else a != b), bit
    if op in ('<', '<=', '>', '>='):
      if u64:
        a, b = a ^ _I64_MIN, b ^ _I64_MIN
      if op == '<':
        return a < b, bit
      if op == '<=':
        return a <= b, bit
      if op == '>':
        return a > b, bit
      return a >= b, bit
    if op == '&&':
      return _truth(a) & _truth(b), bit
    if op == '||':
      return _truth(a) | _truth(b), bit
    raise utils.InternalError('unknown operator: %s' % op)

  def _eval_call(self, node: ir.Call) -> Tuple[Any, Optional[Type]]:
    name = node.name
    if name in ('min', 'max'):
      acc, acc_t = self.eval(node.operand[0])
      for opd in node.operand[1:]:
        val, val_t = self.eval(opd)
        acc, val, acc_t = self._coerce_pair(acc, acc_t, val, val_t)
        if _is_u64(acc_t):
          pick_a = _u64_lt(acc, val) if name == 'min' else _u64_lt(val, acc)
          acc = torch.where(pick_a | (acc == val), acc, val)
        else:
          acc = (torch.minimum if name == 'min' else torch.maximum)(acc, val)
      return acc, acc_t
    args = [self.eval(o) for o in node.operand]
    if name == 'select':
      cond = self._ctx.tensor(args[0][0])
      av, bv, out = self._coerce_pair(*args[1], *args[2])
      return torch.where(_truth(cond), av, bv), out
    if name == 'abs':
      val, t = args[0]
      if t is not None and not t.is_float:
        pt = promote(t)
        if pt != t:
          val, t = self._as(val, pt, t), pt
        if not t.is_signed:
          return self._ctx.tensor(val), t
      return torch.abs(self._ctx.tensor(val)), t
    if name == 'pow':
      (av, at), (bv, bt) = args
      out = binary_type(at, bt)
      if not out.is_float:
        out = _FLOAT
      return torch.pow(self._as(av, out, at), self._as(bv, out, bt)), out
    val, t = args[0]
    out = t if (t is not None and t.is_float) else _FLOAT
    val = self._as(val, out, t)
    table = {
        'sqrt': _sqrt,
        'rsqrt': lambda x: torch.reciprocal(_sqrt(x)),
        'exp': torch.exp, 'log': torch.log, 'sin': torch.sin,
        'cos': torch.cos, 'tan': torch.tan, 'tanh': torch.tanh,
        'floor': torch.floor, 'ceil': torch.ceil,
        'round': torch.round,  # half to even, like numpy's round
    }
    if name not in table:
      raise utils.InternalError('unknown intrinsic: %s' % name)
    return table[name](val), out

