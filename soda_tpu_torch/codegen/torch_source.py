"""Print a standalone PyTorch or NumPy program for a stencil.

The counterpart of soda_tpu/codegen/jax_source.py, whose 'jax' target
becomes 'torch' here; its 'numpy' target is kept. The printed module
depends on nothing of this package, and contains:

  * the DSL and the stencil's window and distance as a header docstring,
  * one ``compute(...)`` over full grids by shifted slices, each output
    zero outside its valid region,
  * ``forward``, and a ``main()`` self-test that fills ramp or random
    inputs from a seed and prints a checksum for each output.

Both targets print each stage by running the port's NumPy-side
C-semantics Evaluator (backend/c_semantics.py, the oracle's own)
against a symbolic namespace that writes a line of source for every
operation instead of computing it, as jax_source does.

'numpy' writes numpy's own operations: jax_source's 'numpy' target, the
printed oracle, with plain C division.

'torch' writes, for each value the Evaluator computes as a numpy array
of some dtype, torch code that computes the same numbers in the
representation the port's torch Evaluator (backend/semantics.py) uses:
uint16 carried as int32, uint32 as int64 masked to 32 bits, uint64 as
its int64 bit pattern (compared and divided as unsigned); integer
division by zero and ``MIN // -1`` give numpy's results (C's division
by zero then follows from the Evaluator's ``c_int_div``, as in the
oracle); square roots round through float64; a double converted to
half, and a uint64 to any float, rounds once, as numpy's ``astype``
rounds it (semantics.half_of_double, float_of_u64). The torch Evaluator
is not traced instead: it branches on the dtypes of real tensors and
keeps constants as cached device tensors, which a trace would freeze
into the program, while the symbolic namespace knows each value's dtype
as it prints and prints only the branch taken. Neither target has the
JAX package's ``fast_int_div`` or ``fast_rsqrt``.
"""

from __future__ import annotations

import io
import keyword
from typing import Optional, Tuple

import numpy as np

from soda_tpu_torch.backend import c_semantics
from soda_tpu_torch.backend.plan import make_plan
from soda_tpu_torch.core.stencil import window_extent
from soda_tpu_torch.ir import nodes as ir

TARGETS = ('torch', 'numpy')
# representation masks of the unsigned types torch computes in a wider one
_MASKS = {'uint16': 0xFFFF, 'uint32': 0xFFFFFFFF}
_UNSIGNED = ('uint8', 'uint16', 'uint32', 'uint64')

# the torch program's helpers, printed into it verbatim
_PRELUDE = '''\
_STORAGE = {
    'bool': torch.bool, 'int8': torch.int8, 'int16': torch.int16,
    'int32': torch.int32, 'int64': torch.int64, 'uint8': torch.uint8,
    'uint16': torch.uint16, 'uint32': torch.uint32, 'uint64': torch.uint64,
    'float16': torch.float16, 'float32': torch.float32,
    'float64': torch.float64,
}
# torch has storage but no arithmetic for these: each is computed in a
# wider (or same-size signed) dtype, viewed from its same-size signed one
_REPR = {'uint16': torch.int32, 'uint32': torch.int64, 'uint64': torch.int64}
_VIEW = {'uint16': torch.int16, 'uint32': torch.int32, 'uint64': torch.int64}
_MASK = {'uint16': 0xFFFF, 'uint32': 0xFFFFFFFF}
_MIN64 = -(1 << 63)
_CONSTANTS = {}


def _rep(name):
  return _REPR.get(name, _STORAGE[name])


def _load(x, name):
  """A storage tensor of type ``name`` -> its representation."""
  if name not in _REPR:
    return x
  x = x.view(_VIEW[name]).to(_REPR[name])
  return x & _MASK[name] if name in _MASK else x


def _store(x, name):
  """A representation of type ``name`` -> its storage tensor."""
  if name in _REPR:
    return x.to(_VIEW[name]).view(_STORAGE[name])
  return x.to(_STORAGE[name])


def _c(value, name, device):
  """A 0-d constant of type ``name`` (``value`` is its representation)."""
  key = (type(value), value, name, str(device))
  if key not in _CONSTANTS:
    _CONSTANTS[key] = torch.tensor(value, dtype=_rep(name), device=device)
  return _CONSTANTS[key]


def _half_of_double(x):
  """float64 -> float16 rounded once, as numpy rounds it (torch rounds
  twice, through float32): the float32 step rounds to odd instead."""
  f = x.to(torch.float32)
  wide = f.to(torch.float64)
  bits = f.view(torch.int32)
  bits = bits - (wide.abs() > x.abs()).to(torch.int32)
  bits = bits | ((wide != x) & torch.isfinite(x)).to(torch.int32)
  return bits.view(torch.float32).to(torch.float16)


def _float_of_u64(x, dtype):
  """uint64 bit patterns -> float ``dtype`` rounded once: a pattern of
  2**63 or more halved with its lowest bit kept, converted, doubled."""
  big = x < 0
  halved = ((x >> 1) & ((1 << 63) - 1)) | (x & 1)
  wide = torch.where(big, halved, x).to(dtype)
  return torch.where(big, wide * 2, wide)


def _trunc_int64(x):
  """Floats truncated toward zero into int64: a value in [2**63, 2**64)
  as its uint64 bit pattern (torch gives -2**63 there)."""
  t = torch.trunc(x)
  big = t >= 2.0 ** 63
  low = torch.where(big, t - 2.0 ** 63, t).to(torch.int64)
  return torch.where(big, low | -2**63, low)


def _cast(x, src, dst):
  """numpy's ``x.astype(dst)`` for a representation of type ``src``."""
  if dst == 'bool':
    return x != 0
  if dst.startswith('float'):
    if src == 'uint64':
      return _float_of_u64(x, _STORAGE[dst])
    if dst == 'float16' and x.dtype == torch.float64:
      return _half_of_double(x)
    return x.to(_STORAGE[dst])
  if x.is_floating_point():
    x = _trunc_int64(x)
  if dst in _MASK:
    return (x.to(torch.int64) & _MASK[dst]).to(_REPR[dst])
  return x.to(_rep(dst))


def _flip(x):
  """A uint64 bit pattern that compares as signed as the unsigned value
  compares."""
  return x ^ _MIN64


def _u64_div(a, b):
  """Unsigned 64-bit division on int64 bit patterns (b != 0)."""
  big = b < 0  # b >= 2**63: the quotient is 0 or 1
  bs = torch.where(big, torch.ones_like(b), b)
  q = torch.div((a >> 1) & ((1 << 63) - 1), bs, rounding_mode='trunc') * 2
  r = a - q * bs  # in [0, 2b): one correction
  q = q + (_flip(r) >= _flip(bs)).to(q.dtype)
  return torch.where(big, (_flip(a) >= _flip(b)).to(q.dtype), q)


def _floordiv(a, b, name):
  """numpy's ``a // b`` for representations of integer type ``name``:
  0 where ``b`` is 0, and ``MIN // -1`` wraps to MIN."""
  zero = b == 0
  if name == 'uint64':
    q = _u64_div(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(q), q)
  neg1 = (b == -1) if name.startswith('int') else torch.zeros_like(zero)
  q = torch.div(a, torch.where(zero | neg1, torch.ones_like(b), b),
                rounding_mode='floor')
  q = torch.where(neg1, -a, q)
  return torch.where(zero, torch.zeros_like(q), q)


def _umin(a, b):
  return torch.where(_flip(a) <= _flip(b), a, b)


def _umax(a, b):
  return torch.where(_flip(a) >= _flip(b), a, b)


def _sqrt(x):
  """IEEE square root: torch's vectorised float32 one is off by an ulp at
  times; through float64 it rounds as numpy's and CUDA's do."""
  if x.dtype == torch.float16:
    return _half_of_double(torch.sqrt(x.to(torch.float64)))
  if x.dtype == torch.float32:
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)
  return torch.sqrt(x)


def _grid(x, shape):
  """A 0-d value as a grid of ``shape``."""
  return x.expand(shape).contiguous()
'''


def _literal(value) -> str:
  """Python source of a scalar."""
  if isinstance(value, np.generic):
    value = value.item()
  if isinstance(value, float) and not np.isfinite(value):
    return "float('%s')" % value
  return repr(value)


def _representation(arr: np.ndarray) -> str:
  """Python source of a 0-d numpy value's torch representation."""
  if arr.dtype == np.uint64:
    return _literal(arr.view(np.int64).item())
  return _literal(arr.item())


class _Sym:
  """Symbolic array value: every operation writes a line of source.

  ``const``: the numpy value where it is a printed constant; ``scalar``:
  whether the value is 0-d (constants, param elements and what is
  computed from them alone)."""

  __slots__ = ('b', 'name', 'dtype', 'const', 'scalar')

  def __init__(self, builder: '_SourceXp', name: str, dtype,
               const: Optional[np.ndarray] = None, scalar: bool = False):
    self.b = builder
    self.name = name
    self.dtype = np.dtype(dtype) if dtype is not None else None
    self.const = const
    self.scalar = scalar

  def _bin(self, op, other, dtype=None):
    return self.b.binary(self, op, other, dtype or self.dtype)

  def _rbin(self, op, other):
    return self.b.binary(self, op, other, self.dtype, reflected=True)

  def __add__(self, o):
    return self._bin('+', o)

  def __radd__(self, o):
    return self._rbin('+', o)

  def __sub__(self, o):
    return self._bin('-', o)

  def __rsub__(self, o):
    return self._rbin('-', o)

  def __mul__(self, o):
    return self._bin('*', o)

  def __rmul__(self, o):
    return self._rbin('*', o)

  def __truediv__(self, o):
    return self._bin('/', o)

  def __rtruediv__(self, o):
    # the rsqrt intrinsic evaluates as ``1 / sqrt(x)``
    return self._rbin('/', o)

  def __floordiv__(self, o):
    return self._bin('//', o)

  def __and__(self, o):
    return self._bin('&', o)

  def __or__(self, o):
    return self._bin('|', o)

  def __xor__(self, o):
    return self._bin('^', o)

  def __neg__(self):
    return self.b.unary('-', self)

  def __invert__(self):
    return self.b.unary('~', self)

  def __eq__(self, o):  # noqa: intentional symbolic comparison
    return self._bin('==', o, np.dtype(bool))

  def __ne__(self, o):
    return self._bin('!=', o, np.dtype(bool))

  def __lt__(self, o):
    return self._bin('<', o, np.dtype(bool))

  def __le__(self, o):
    return self._bin('<=', o, np.dtype(bool))

  def __gt__(self, o):
    return self._bin('>', o, np.dtype(bool))

  def __ge__(self, o):
    return self._bin('>=', o, np.dtype(bool))

  def __hash__(self):
    return id(self)

  def astype(self, dtype):
    return self.b.astype(self, np.dtype(dtype))

  @property
  def shape(self):  # only used by wrap() via asarray round-trips
    return ()


class _SourceXp:
  """A numpy-workalike namespace that writes numpy source (the printed
  text is jax_source's with ``prefix='np'``)."""

  def __init__(self, prefix: str = 'np'):
    self.lines = []
    self.counter = 0
    self.prefix = prefix

  def temp(self, expr: str, dtype, const=None, scalar=False) -> _Sym:
    name = '_t%d' % self.counter
    self.counter += 1
    self.lines.append('%s = %s' % (name, expr))
    return _Sym(self, name, dtype, const, scalar)

  def sym(self, expr: str, dtype, scalar=False) -> _Sym:
    return _Sym(self, expr, np.dtype(dtype) if dtype is not None else None,
                scalar=scalar)

  @staticmethod
  def operand(v) -> str:
    return v.name if isinstance(v, _Sym) else repr(v)

  def binary(self, a: _Sym, op: str, other, dtype, reflected=False) -> _Sym:
    x, y = a.name, self.operand(other)
    if reflected:
      x, y = y, x
    return self.temp('%s %s %s' % (x, op, y), dtype)

  def unary(self, op: str, a: _Sym) -> _Sym:
    return self.temp('%s%s' % (op, a.name), a.dtype)

  def astype(self, a: _Sym, dtype) -> _Sym:
    return self.temp('%s.astype(np.%s)' % (a.name, dtype.name), dtype)

  # -- numpy API surface used by c_semantics.Evaluator -----------------------
  def asarray(self, v, dtype=None):
    if isinstance(v, _Sym):
      if dtype is not None and np.dtype(dtype) != v.dtype:
        return v.astype(dtype)
      return v
    if dtype is not None:
      return self.temp('%s.asarray(%r, np.%s)' % (self.prefix, v,
                                                  np.dtype(dtype).name),
                       dtype)
    dt = np.dtype(type(v)) if isinstance(v, (int, float)) else None
    return self.temp('%s.asarray(%r)' % (self.prefix, v), dt)

  def trunc(self, v):
    return self.temp('%s.trunc(%s)' % (self.prefix, v.name), v.dtype)

  def where(self, c, a, b):
    dt = a.dtype if isinstance(a, _Sym) else b.dtype
    return self.temp('%s.where(%s, %s, %s)' % (
        self.prefix, self.operand(c), self.operand(a), self.operand(b)), dt)

  def call(self, fn: str, v) -> _Sym:
    if not isinstance(v, _Sym):  # a literal's abs or logical_not
      return self.temp('%s.%s(%r)' % (self.prefix, fn, v),
                       np.asarray(getattr(np, fn)(v)).dtype)
    return self.temp('%s.%s(%s)' % (self.prefix, fn, v.name), v.dtype)

  def sqrt(self, v):
    return self.call('sqrt', v)

  def exp(self, v):
    return self.call('exp', v)

  def log(self, v):
    return self.call('log', v)

  def sin(self, v):
    return self.call('sin', v)

  def cos(self, v):
    return self.call('cos', v)

  def tan(self, v):
    return self.call('tan', v)

  def tanh(self, v):
    return self.call('tanh', v)

  def floor(self, v):
    return self.call('floor', v)

  def ceil(self, v):
    return self.call('ceil', v)

  def round(self, v):
    return self.call('round', v)

  def abs(self, v):
    return self.call('abs', v)

  def logical_not(self, v):
    return self.call('logical_not', v)

  def pair(self, fn: str, a: _Sym, b: _Sym, dtype) -> _Sym:
    return self.temp('%s.%s(%s, %s)' % (self.prefix, fn, a.name, b.name),
                     dtype)

  def minimum(self, a, b):
    return self.pair('minimum', a, b, a.dtype)

  def maximum(self, a, b):
    return self.pair('maximum', a, b, a.dtype)

  def logical_and(self, a, b):
    return self.pair('logical_and', a, b, np.dtype(bool))

  def logical_or(self, a, b):
    return self.pair('logical_or', a, b, np.dtype(bool))

  def power(self, a, b):
    return self.pair('power', a, b, a.dtype)


class _TorchXp(_SourceXp):
  """The same namespace writing torch source over representations."""

  def __init__(self):
    super().__init__('torch')

  @staticmethod
  def operand(v) -> str:
    return v.name if isinstance(v, _Sym) else _literal(v)

  def const(self, arr: np.ndarray) -> _Sym:
    arr = np.asarray(arr)
    return self.temp('_c(%s, %r, _dev)' % (_representation(arr),
                                          arr.dtype.name),
                     arr.dtype, const=arr, scalar=True)

  def binary(self, a: _Sym, op: str, other, dtype, reflected=False) -> _Sym:
    name = a.dtype.name if a.dtype is not None else None
    x, y = a.name, self.operand(other)
    if reflected:
      x, y = y, x
    scalar = a.scalar and (not isinstance(other, _Sym) or other.scalar)
    if op in ('<', '<=', '>', '>=') and name == 'uint64':
      expr = '_flip(%s) %s _flip(%s)' % (x, op, y)
    elif op == '//':
      expr = '_floordiv(%s, %s, %r)' % (x, y, name)
    elif op in '+-*' and name in _MASKS:
      expr = '(%s %s %s) & %#x' % (x, op, y, _MASKS[name])
    elif op == '/' and a.dtype.kind != 'f':
      raise NotImplementedError('true division of %s' % name)
    else:
      expr = '%s %s %s' % (x, op, y)
    return self.temp(expr, dtype, scalar=scalar)

  def unary(self, op: str, a: _Sym) -> _Sym:
    name = a.dtype.name if a.dtype is not None else None
    expr = '%s%s' % (op, a.name)
    if name in _MASKS:
      expr = '(%s) & %#x' % (expr, _MASKS[name])
    return self.temp(expr, a.dtype, scalar=a.scalar)

  def astype(self, a: _Sym, dtype) -> _Sym:
    if a.const is not None:
      with np.errstate(all='ignore'):
        return self.const(np.asarray(a.const).astype(dtype))
    if dtype == a.dtype:
      return a
    return self.temp('_cast(%s, %r, %r)' % (
        a.name, a.dtype.name if a.dtype is not None else None, dtype.name),
                     dtype, scalar=a.scalar)

  def asarray(self, v, dtype=None):
    if isinstance(v, _Sym):
      if dtype is not None and np.dtype(dtype) != v.dtype:
        return v.astype(dtype)
      return v
    return self.const(np.asarray(v, dtype))

  def trunc(self, v):
    return self.call('trunc', v)

  def where(self, c, a, b):
    if not isinstance(c, _Sym):  # a constant condition picks its branch
      return self.asarray(a if c else b)
    cond = c.name if c.dtype == np.dtype(bool) else '(%s != 0)' % c.name
    scalar = all(not isinstance(v, _Sym) or v.scalar for v in (c, a, b))
    dt = a.dtype if isinstance(a, _Sym) else b.dtype
    return self.temp('torch.where(%s, %s, %s)' % (
        cond, self.operand(a), self.operand(b)), dt, scalar=scalar)

  def call(self, fn: str, v) -> _Sym:
    if not isinstance(v, _Sym):  # a literal's abs or logical_not, folded
      return self.const(np.asarray(getattr(np, fn)(v)))
    if fn == 'abs' and v.dtype is not None and v.dtype.name in _UNSIGNED:
      return v  # numpy's abs of an unsigned value is the value
    dtype = np.dtype(bool) if fn == 'logical_not' else v.dtype
    return self.temp('torch.%s(%s)' % (fn, v.name), dtype, scalar=v.scalar)

  def sqrt(self, v):
    return self.temp('_sqrt(%s)' % v.name, v.dtype, scalar=v.scalar)

  def pair(self, fn: str, a: _Sym, b: _Sym, dtype) -> _Sym:
    if fn in ('minimum', 'maximum') and a.dtype == np.uint64:
      fn = '_umin' if fn == 'minimum' else '_umax'
    else:
      fn = 'torch.' + fn
    return self.temp('%s(%s, %s)' % (fn, a.name, b.name), dtype,
                     scalar=a.scalar and b.scalar)


def _slice_str(slices) -> str:
  return ', '.join('%s:%s' % (s[0], s[1]) for s in slices)


def _py_name(name: str) -> str:
  """Tensor name -> valid Python identifier (DSL allows keywords)."""
  return name + '_' if keyword.iskeyword(name) else name


def _print_stages(stencil, plan, target: str, w) -> None:
  """``compute``'s body: every stage, in the plan's order. The torch
  program deletes each stage's temporaries after it and each stage or
  input after its last reader, so that the grids alive at once stay
  few (contrast has 114 stages)."""
  dim = plan.dim
  evaluated = []
  for stage in plan.stages:
    xp = _TorchXp() if target == 'torch' else _SourceXp('np')
    st_idx = stage.tensor.st_idx
    lo, hi = stage.lo, stage.hi
    loaded = set()

    def load(ref: ir.Ref, _lo=lo, _hi=hi, _st=st_idx, _xp=xp, _read=loaded):
      _read.add(ref.name)
      if ref.name in stencil.param_names:
        return _xp.sym(
            '%s[%s]' % (_py_name(ref.name), ', '.join(map(str, ref.idx))),
            stencil.symbol_table[ref.name].np_dtype, scalar=True)
      slices = []
      for a in range(dim):
        d = dim - 1 - a
        delta = ref.idx[d] - _st[d]
        start = _lo[d] + delta  # >= 0 by the margin propagation
        stop_off = delta - _hi[d]
        stop = '_shape[%d]%s' % (a, '%+d' % stop_off if stop_off else '')
        slices.append((start, stop))
      dtype = None
      if ref.dtype is not None:
        dtype = ref.dtype.np_dtype
      elif ref.name in stencil.symbol_table:
        t = stencil.symbol_table[ref.name]
        dtype = t.np_dtype if t is not None else None
      return _xp.sym('%s[%s]' % (_py_name(ref.name), _slice_str(slices)),
                     dtype)

    def param(name, idx, _xp=xp):
      return _xp.sym('%s[%s]' % (_py_name(name), ', '.join(map(str, idx))),
                     stencil.symbol_table[name].np_dtype, scalar=True)

    # plain C division: these are printed oracles
    evaluator = c_semantics.Evaluator(xp, load, param=param)
    value, _ = evaluator.eval_stmt(stage.tensor)
    value = c_semantics.wrap(xp, value, stage.dtype)
    evaluated.append((stage, xp, value, loaded))

  last_reader = {}
  for k, (_, _, _, loaded) in enumerate(evaluated):
    for name in loaded - set(stencil.param_names):
      last_reader[name] = k
  for k, (stage, xp, value, _) in enumerate(evaluated):
    lo, hi = stage.lo, stage.hi
    w('\n  # %s: %s = %s\n' % (stage.name, stage.tensor.st_ref,
                               stage.tensor.expr))
    for line in xp.lines:
      w('  %s\n' % line)
    name = _py_name(stage.name)
    padded = any(l or h for l, h in zip(lo, hi))
    if target == 'numpy':
      pads = ', '.join('(%d, %d)' % (lo[dim - 1 - a], hi[dim - 1 - a])
                       for a in range(dim))
      if padded:
        w('  %s = np.pad(%s, (%s))\n' % (name, value.name, pads))
      else:
        w('  %s = %s\n' % (name, value.name))
      continue
    expr = value.name
    if value.scalar:
      expr = '_grid(%s, (%s,))' % (expr, ', '.join(
          '_shape[%d] - %d' % (a, lo[dim - 1 - a] + hi[dim - 1 - a])
          for a in range(dim)))
    if padded:  # constant_pad_nd pads the last axis first
      expr = 'torch.constant_pad_nd(%s, (%s))' % (expr, ', '.join(
          '%d, %d' % (lo[d], hi[d]) for d in range(dim)))
    w('  %s = %s\n' % (name, expr))
    dead = ['_t%d' % i for i in range(xp.counter)] + [
        _py_name(n) for n, last in sorted(last_reader.items())
        if last == k and n not in stencil.output_names]
    if dead:
      w('  del %s\n' % ', '.join(dead))


def _print_fill(stencil, w) -> None:
  """``main``'s seeded inputs and params as numpy arrays (jax_source's)."""
  for name in stencil.input_names:
    t = stencil.symbol_table[name]
    name = _py_name(name)
    if t.is_float:
      w('  %s = rng.random(shape).astype(np.%s)\n' % (name, t.np_dtype.name))
    else:
      w('  %s = sum(np.arange(s, dtype=np.int64).reshape(\n'
        '      [-1 if i == a else 1 for i in range(len(shape))])\n'
        '      for a, s in enumerate(shape))\n' % name)
      if t.needs_mask:
        # widths that are not a power of two: wrap into the declared
        # range like every executor's input wrap (semantics.wrap)
        w('  %s = %s & %d\n' % (name, name, (1 << t.width_in_bits) - 1))
        if t.is_signed:
          sign = 1 << (t.width_in_bits - 1)
          w('  %s = (%s ^ %d) - %d\n' % (name, name, sign, sign))
      w('  %s = %s.astype(np.%s)\n' % (name, name, t.np_dtype.name))
  for stmt in stencil.param_stmts:
    if stmt.dtype.is_float:
      w('  %s = rng.random(%r).astype(np.%s)\n' %
        (_py_name(stmt.name), tuple(stmt.size), stmt.dtype.np_dtype.name))
    else:
      # integer params as ramps (uniform [0,1) floats truncate to 0)
      w('  %s = (np.arange(np.prod(%r)).reshape(%r) %% 7 + 1)'
        '.astype(np.%s)\n' %
        (_py_name(stmt.name), tuple(stmt.size), tuple(stmt.size),
         stmt.dtype.np_dtype.name))


def print_code(stencil, file, shape: Optional[Tuple[int, ...]] = None,
               target: str = 'torch') -> None:
  """Write a standalone module computing ``stencil`` on grids of
  ``shape`` (array-axis order; ``compute`` takes any extents, ``main``
  uses ``shape``: default 512 along the streaming axis and the tile
  size's other extents). ``target``: 'torch' (the default: torch and
  numpy; ``main`` runs on ``--device cuda``, or ``cpu``) or 'numpy'
  (numpy alone: the printed oracle)."""
  if target not in TARGETS:
    raise ValueError('unknown codegen target: %s' % target)
  plan = make_plan(stencil, 'full')
  if shape is None:
    shape = (512,) + tuple(reversed(stencil.tile_size[:-1]))
  w = file.write
  torch = target == 'torch'

  w('"""Generated by soda-tpu; standalone %s stencil program.\n\n'
    % ('PyTorch' if torch else 'NumPy'))
  w('This program was generated from the following SODA DSL\n')
  w('(stencil window %s, stencil distance %d):\n\n' %
    (tuple(window_extent(stencil.stencil_window)),
     stencil.stencil_distance))
  w(str(stencil))
  w('\n"""\n\n')
  if torch:
    w('import argparse\n\nimport numpy as np\nimport torch\n\n')
    w(_PRELUDE)
    w('\n\n')
  else:
    w('import numpy as np\n\n\n')

  in_args = ', '.join(map(_py_name,
                          stencil.input_names + stencil.param_names))
  w('def compute(%s):\n' % in_args)
  w('  """All stencil stages over full grids; outputs zero outside\n'
    '  their valid regions."""\n')
  w('  _shape = %s.shape\n' % _py_name(stencil.input_names[0]))
  if torch:
    w('  _dev = %s.device\n' % _py_name(stencil.input_names[0]))
    for name in stencil.input_names + stencil.param_names:
      w('  %s = _load(%s, %r)\n' % (_py_name(name), _py_name(name),
                                    stencil.symbol_table[name].np_dtype.name))
  _print_stages(stencil, plan, target, w)
  if torch:
    w('\n  return {%s}\n\n\n' % ', '.join(
        "'%s': _store(%s, %r)" % (n, _py_name(n),
                                  stencil.symbol_table[n].np_dtype.name)
        for n in stencil.output_names))
    w('_TYPES = {%s}\n' % ', '.join(
        '%r: %r' % (n, stencil.symbol_table[n].np_dtype.name)
        for n in stencil.output_names))
    w('forward = compute\n\n\n')
  else:
    w('\n  return {%s}\n\n\n' % ', '.join(
        "'%s': %s" % (n, _py_name(n)) for n in stencil.output_names))
    w('forward = compute\n\n\n')

  # self-test main (the SODA_TEST_MAIN analog)
  if torch:
    w('def main(argv=None):\n')
    w("  parser = argparse.ArgumentParser(description='Self-test: seeded "
      "inputs, one checksum per output.')\n")
    w("  parser.add_argument('--device', choices=('cpu', 'cuda'), "
      "default='cuda')\n")
    w('  device = parser.parse_args(argv).device\n')
    w("  if device == 'cuda' and not torch.cuda.is_available():\n")
    w("    raise RuntimeError('--device cuda: no CUDA device is available "
      "(pass --device cpu)')\n")
  else:
    w('def main():\n')
  w('  shape = %r\n' % (tuple(int(x) for x in shape),))
  w('  rng = np.random.default_rng(0)\n')
  _print_fill(stencil, w)
  if torch:
    w('  outs = forward(*[torch.from_numpy(np.ascontiguousarray(v)).to('
      'device)\n                 for v in (%s,)])\n' % in_args)
    w('  for name, arr in outs.items():\n')
    w("    print(name, 'checksum', float(_cast(_load(arr, _TYPES[name]),\n"
      "                                        _TYPES[name], 'float64')"
      '.sum()))\n')
  else:
    w('  outs = forward(%s)\n' % in_args)
    w('  for name, arr in outs.items():\n')
    w("    print(name, 'checksum', float(np.sum("
      'arr.astype(np.float64))))\n')
  w('\n\nif __name__ == "__main__":\n  main()\n')


def generate(stencil, shape=None, target: str = 'torch') -> str:
  """``print_code``'s text."""
  buf = io.StringIO()
  print_code(stencil, buf, shape, target)
  return buf.getvalue()
