"""Generate the fused CUDA C++ stencil kernel for one TilePlan.

Two parts:

- ``StagePrinter`` prints one stage (its ``let`` bindings and
  expression) as a C++ function with the oracle's semantics
  (backend/c_semantics.py ``Evaluator``): the same promotion
  (``binary_type``), lazily-typed literals, truncating division, wraps at
  casts and stores, half rounded at every half-typed result. Constant
  subtrees are folded by the oracle's own Evaluator, so literals carry
  exactly the oracle's values. Floats print as hex literals.
- ``generate`` wraps the stage functions in the kernel (one CTA per
  output tile, all buffers in shared memory, see tile_plan.py; the grid's
  second axis runs over replicas, independent grids laid out one after
  another), a ``soda_launch_<hash>`` entry point with a plain C
  interface that takes the replica count (one grid launches the
  kernel's instantiation without the replica offset, which cost up to
  7% of a one-grid call's device time on an H100), and, behind
  ``#ifndef __CUDACC__``, ``soda_host_<hash>``: a whole-grid host loop
  over the same stage functions and replicas, so a host C++ compiler can
  check the printed arithmetic against the oracle where no ``nvcc``
  exists.

The kernel computes what soda_tpu/backend/pallas_kernel.py
``PallasExecutor._build`` computes; the source names that in its first
comment. The generated text depends only on (stencil, shape, tile): the
replica count is a launch argument, so one build serves every count.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from soda_tpu_torch import utils
from soda_tpu_torch.backend import c_semantics as oracle
from soda_tpu_torch.backend.c_semantics import binary_type, promote
from soda_tpu_torch.ir import nodes as ir
from soda_tpu_torch.ir.types import Type

from soda_tpu_torch.backend.tile_plan import TilePlan

# Threads per CTA: every stage loop strides its tile extent by this.
THREADS = 512
# What the kernel replaces, for the source note and the run's report.
REPLACES = 'soda_tpu/backend/pallas_kernel.py:1543'
# The most replicas one launch takes (CUDA's limit on gridDim.y).
MAX_REPLICAS = 65535

_INT = Type('int32')
_FLOAT = Type('float')
_BIT = Type('uint1')

_CTYPE = {
    'int8': 'int8_t', 'int16': 'int16_t', 'int32': 'int32_t',
    'int64': 'int64_t', 'uint8': 'uint8_t', 'uint16': 'uint16_t',
    'uint32': 'uint32_t', 'uint64': 'uint64_t', 'float16': 'float',
    'float32': 'float', 'float64': 'double',
}


def _is_half(t: Optional[Type]) -> bool:
  return t is not None and t.is_float and t.storage_width == 16


def _is_double(t: Optional[Type]) -> bool:
  return t is not None and t.is_float and t.storage_width == 64


def ctype(t: Type) -> str:
  """C type that carries values of ``t`` through arithmetic (half is a
  float rounded to half precision)."""
  return _CTYPE[t.np_dtype.name]


def storage_ctype(t: Type) -> str:
  """C type of ``t`` in memory (half as its 16 bits)."""
  return 'uint16_t' if _is_half(t) else ctype(t)


def _same_repr(a: Optional[Type], b: Type) -> bool:
  return (a is not None and a.np_dtype == b.np_dtype and
          a.is_signed == b.is_signed)


def literal(value, t: Type) -> str:
  """C literal of ``value`` converted to ``t`` exactly as numpy's
  ``asarray(value).astype(t.np_dtype)`` converts it."""
  v = np.asarray(value).astype(t.np_dtype)
  if t.is_float:
    f = float(v)
    suffix = '' if _is_double(t) else 'f'
    if np.isnan(f):
      body = 'NAN'
    elif np.isinf(f):
      body = 'INFINITY' if f > 0 else '-INFINITY'
    else:
      mant, exp = f.hex().split('p')
      return '(%sp%s%s)' % (mant.rstrip('0'), exp, suffix)
    return '((%s)%s)' % (ctype(t), body)
  n = int(v)
  c = ctype(t)
  bits = t.np_dtype.itemsize * 8
  if t.np_dtype.kind == 'u':
    return '((%s)%dull)' % (c, n)
  if n == -(1 << (bits - 1)):  # the most negative value has no literal
    return '((%s)(-%dll - 1))' % (c, (1 << (bits - 1)) - 1)
  return '((%s)%dll)' % (c, n)


@dataclasses.dataclass
class _Val:
  """A printed value: C code (a temporary's name) or a folded constant
  (as the oracle's Evaluator holds it), with its stencil type."""
  dtype: Optional[Type]
  code: Optional[str] = None
  const: object = None

  @property
  def is_const(self) -> bool:
    return self.code is None


class StagePrinter:
  """Print one stage as a C++ function body under C semantics.

  Args:
    stencil: the core.Stencil (symbol table, params).
    deltas: ref -> array-axis load offsets for tensor refs.
  """

  def __init__(self, stencil, deltas):
    self.stencil = stencil
    self.deltas = deltas
    self.lines: List[str] = []
    self.env: Dict[str, _Val] = {}
    self._n = 0

  # -- emission ---------------------------------------------------------------
  def _tmp(self, t: Type, code: str) -> _Val:
    name = 'v%d' % self._n
    self._n += 1
    self.lines.append('const %s %s = %s;' % (ctype(t), name, code))
    return _Val(t, code=name)

  def coerce(self, v: _Val, t: Type) -> str:
    """numpy's ``_as(value, t)``: C code of ``v`` converted to ``t``."""
    if v.is_const:
      return literal(v.const, t)
    src = v.dtype
    if _same_repr(src, t) and _is_half(src) == _is_half(t):
      return v.code
    if _is_half(t):
      if _is_double(src):
        return 'soda::rh((double)(%s))' % v.code
      return 'soda::rh((float)(%s))' % v.code
    if not t.is_float and src is not None and src.is_float:
      return 'soda::f2i<%s, %d>(%s)' % (ctype(t), t.storage_width, v.code)
    return '((%s)(%s))' % (ctype(t), v.code)

  def wrap(self, v: _Val, t: Type) -> _Val:
    """numpy's ``wrap(value, t)`` (casts, typed lets, stage stores)."""
    if v.is_const:
      return _Val(t, const=oracle.wrap(np, v.const, t))
    if t.is_float:
      return self._tmp(t, self.coerce(v, t))
    n = t.width_in_bits
    if v.dtype is not None and v.dtype.is_float:
      return self._tmp(t, 'soda::f2i<%s, %d>(%s)' % (ctype(t), n, v.code))
    return self._tmp(t, 'soda::wrap_int<%s, %d>(%s)' % (ctype(t), n, v.code))

  # -- constant folding ---------------------------------------------------------
  def _fold(self, node) -> Optional[_Val]:
    """The oracle's value of a subtree that loads nothing, else None."""
    consts = {}
    found = [True]

    def check(n, _):
      if isinstance(n, ir.Ref):
        found[0] = False
      elif isinstance(n, ir.Var):
        bound = self.env.get(n.name)
        if n.idx or bound is None or not bound.is_const:
          found[0] = False
        else:
          consts[n.name] = (bound.const, bound.dtype)
      return n

    node.visit(check)
    if not found[0]:
      return None
    ev = oracle.Evaluator(np, load=None, env=consts)
    with np.errstate(all='ignore'):
      value, t = ev.eval(node)
    return _Val(t, const=value)

  # -- statements ---------------------------------------------------------------
  def stage(self, tensor) -> str:
    """Lets, then the expression wrapped to the stage type; returns the
    C code of the stored value (storage C type)."""
    for let in tensor.lets:
      v = self.eval(let.expr)
      if let.dtype is not None:
        v = self.wrap(v, let.dtype)
      if not v.is_const:
        name = 'l_%s' % let.name
        self.lines.append('const %s %s = %s;' % (ctype(v.dtype), name,
                                                 v.code))
        v = _Val(v.dtype, code=name)
      self.env[let.name] = v
    v = self.eval(tensor.expr)
    t = tensor.dtype
    if _is_half(t):
      if v.is_const:
        bits = np.asarray(oracle.wrap(np, v.const, t)).view(np.uint16)
        return '((uint16_t)%du)' % int(bits)
      if _is_double(v.dtype):
        return 'soda::d2h(%s)' % v.code
      return 'soda::f2h((float)(%s))' % v.code
    v = self.wrap(v, t)
    return v.code if not v.is_const else literal(v.const, t)

  # -- expressions --------------------------------------------------------------
  def eval(self, node) -> _Val:
    folded = self._fold(node)
    if folded is not None:
      return folded
    if isinstance(node, ir.Ref):
      if node.name in self.stencil.param_names:
        return self._param(node.name, node.idx, node.dtype, as_ref=True)
      deltas = ', '.join(str(d) for d in self.deltas(node))
      t = node.dtype
      raw = 'ld_%s(%s)' % (node.name, deltas)
      if _is_half(t):
        return self._tmp(_FLOAT, 'soda::h2f(%s)' % raw)
      return self._tmp(t, raw)
    if isinstance(node, ir.Var):
      if node.idx:
        return self._param(node.name, node.idx, node.dtype, as_ref=False)
      if node.name not in self.env:
        raise utils.InternalError('unbound variable: %s' % node.name)
      return self.env[node.name]
    if isinstance(node, ir.Cast):
      return self.wrap(self.eval(node.expr), node.dtype)
    if isinstance(node, ir.Unary):
      return self._unary(node)
    if isinstance(node, ir.Call):
      return self._call(node)
    if isinstance(node, ir.CHAIN_CLASSES):
      acc = self.eval(node.operand[0])
      for opd, op in zip(node.operand[1:], node.operator):
        acc = self._binary(op, acc, self.eval(opd))
      return acc
    raise utils.InternalError('cannot print %r' % node)

  def _param(self, name, idx, t, as_ref) -> _Val:
    stmt = next(s for s in self.stencil.param_stmts if s.name == name)
    size = tuple(stmt.size)
    if len(idx) != len(size) or any(not 0 <= i < s
                                    for i, s in zip(idx, size)):
      raise utils.InputError('param %s%s out of bounds %s' %
                             (name, tuple(idx), size))
    flat = 0
    for i, s in zip(idx, size):
      flat = flat * s + i
    raw = 'p_%s[%d]' % (name, flat)
    if _is_half(t):
      # a Ref of half reads as float (the oracle's rule for loads); a
      # param element Var keeps its half type
      return self._tmp(_FLOAT if as_ref else t, 'soda::h2f(%s)' % raw)
    return self._tmp(t, raw)

  def _unary(self, node) -> _Val:
    v = self.eval(node.operand)
    t = v.dtype
    if (t is not None and not t.is_float and
        any(op in '-~' for op in node.operator)):
      pt = promote(t)
      if not _same_repr(t, pt):
        v = self._tmp(pt, self.coerce(v, pt))
    for op in reversed(node.operator):
      t = v.dtype
      if op == '+':
        continue
      if op == '!':
        v = self._tmp(_INT, '((int32_t)!(%s))' % v.code)
      elif op == '-':
        if t.is_float:
          v = self._tmp(t, '(-(%s))' % v.code)
        else:
          v = self._tmp(t, 'soda::neg(%s)' % v.code)
      elif op == '~':
        v = self._tmp(t, '((%s)~(%s))' % (ctype(t), v.code))
      else:
        raise utils.InternalError('unknown unary operator: %s' % op)
    return v

  def _binary(self, op: str, a: _Val, b: _Val) -> _Val:
    out = binary_type(a.dtype, b.dtype)
    x, y = self.coerce(a, out), self.coerce(b, out)
    half = _is_half(out)

    def arith(code):
      if half:
        return self._tmp(out, 'soda::rh(%s)' % code)
      return self._tmp(out, code)

    if op in ('+', '-', '*'):
      if out.is_float or not out.is_signed:
        return arith('(%s %s %s)' % (x, op, y))
      fn = {'+': 'add', '-': 'sub', '*': 'mul'}[op]
      return self._tmp(out, 'soda::%s(%s, %s)' % (fn, x, y))
    if op == '/':
      if out.is_float:
        return arith('(%s / %s)' % (x, y))
      return self._tmp(out, 'soda::div(%s, %s)' % (x, y))
    if op == '%':
      if out.is_float:
        raise utils.InputError('%% on floating-point operands')
      return self._tmp(out, 'soda::mod(%s, %s)' % (x, y))
    if op in ('&', '|', '^'):
      return self._tmp(out, '((%s)(%s %s %s))' % (ctype(out), x, op, y))
    if op in ('==', '!=', '<', '<=', '>', '>=', '&&', '||'):
      return self._tmp(_BIT, '((uint8_t)(%s %s %s))' % (x, op, y))
    raise utils.InternalError('unknown operator: %s' % op)

  def _call(self, node) -> _Val:
    name = node.name
    if name in ('min', 'max'):
      acc = self.eval(node.operand[0])
      for opd in node.operand[1:]:
        b = self.eval(opd)
        out = binary_type(acc.dtype, b.dtype)
        acc = self._tmp(out, 'soda::%s_(%s, %s)' % (
            name, self.coerce(acc, out), self.coerce(b, out)))
      return acc
    args = [self.eval(o) for o in node.operand]
    if name == 'select':
      cond, a, b = args
      out = binary_type(a.dtype, b.dtype)
      c = cond.code if not cond.is_const else \
          ('true' if bool(np.asarray(cond.const)) else 'false')
      return self._tmp(out, '((%s) ? %s : %s)' % (
          c, self.coerce(a, out), self.coerce(b, out)))
    if name == 'abs':
      v = args[0]
      t = v.dtype
      if t is not None and not t.is_float:
        pt = promote(t)
        if not _same_repr(t, pt):
          v = self._tmp(pt, self.coerce(v, pt))
        return self._tmp(pt, 'soda::iabs(%s)' % v.code)
      fn = 'fabs' if _is_double(t) else 'fabsf'
      return self._tmp(t, '%s(%s)' % (fn, v.code))
    if name == 'pow':
      a, b = args
      out = binary_type(a.dtype, b.dtype)
      if not out.is_float:
        out = _FLOAT
      fn = 'pow' if _is_double(out) else 'powf'
      code = '%s(%s, %s)' % (fn, self.coerce(a, out), self.coerce(b, out))
      return self._tmp(out, 'soda::rh(%s)' % code if _is_half(out) else code)
    v = args[0]
    t = v.dtype
    out = t if (t is not None and t.is_float) else _FLOAT
    x = self.coerce(v, out)
    f = '' if _is_double(out) else 'f'
    one = '1.0' if _is_double(out) else '1.0f'
    table = {
        'sqrt': 'sqrt%s(%%s)' % f, 'exp': 'exp%s(%%s)' % f,
        'log': 'log%s(%%s)' % f, 'sin': 'sin%s(%%s)' % f,
        'cos': 'cos%s(%%s)' % f, 'tan': 'tan%s(%%s)' % f,
        'tanh': 'tanh%s(%%s)' % f, 'floor': 'floor%s(%%s)' % f,
        'ceil': 'ceil%s(%%s)' % f,
        'round': 'rint%s(%%s)' % f,  # half to even, as numpy rounds
    }
    if name == 'rsqrt':  # the oracle's 1 / sqrt(x), each rounded
      root = 'sqrt%s(%s)' % (f, x)
      if _is_half(out):
        return self._tmp(out, 'soda::rh(1.0f / soda::rh(%s))' % root)
      return self._tmp(out, '(%s / %s)' % (one, root))
    if name not in table:
      raise utils.InternalError('unknown intrinsic: %s' % name)
    code = table[name] % x
    return self._tmp(out, 'soda::rh(%s)' % code if _is_half(out) else code)


# -- the kernel -------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KernelSource:
  """Generated source plus what a caller needs to bind it."""
  text: str
  digest: str  # names the entry points and the build directory

  @property
  def launch_symbol(self) -> str:
    return 'soda_launch_%s' % self.digest

  @property
  def host_symbol(self) -> str:
    return 'soda_host_%s' % self.digest

  @property
  def error_symbol(self) -> str:
    return 'soda_error_string_%s' % self.digest


def _delta_fn(stage):
  st = stage.tensor.st_idx

  def deltas(ref):
    return tuple(reversed([i - s for i, s in zip(ref.idx, st)]))

  return deltas


def _stage_parents(stage) -> List[str]:
  return sorted(stage.tensor.ld_refs)


def _stage_function(plan: TilePlan, k: int, stage) -> str:
  stencil = plan.stencil
  printer = StagePrinter(stencil, _delta_fn(stage))
  result = printer.stage(stage.tensor)
  tparams = ', '.join('class L_%s' % p for p in _stage_parents(stage))
  args = ['const L_%s& ld_%s' % (p, p) for p in _stage_parents(stage)]
  for stmt in stencil.param_stmts:
    args.append('const %s* __restrict__ p_%s' % (storage_ctype(stmt.dtype),
                                                 stmt.name))
  head = 'template <%s>\n' % tparams if tparams else ''
  body = '\n'.join('  ' + line for line in printer.lines)
  return ('// stage %s: %s %s\n%sSODA_STAGE %s soda_stage_%d(%s) {\n%s%s'
          '  return %s;\n}\n' % (
              stage.name, stage.dtype, tuple(stage.tensor.st_idx), head,
              storage_ctype(stage.dtype), k, ', '.join(args), body,
              '\n' if body else '', result))


def _strides(shape) -> List[int]:
  out = [1] * len(shape)
  for a in range(len(shape) - 2, -1, -1):
    out[a] = out[a + 1] * shape[a + 1]
  return out


def _flat(vars_, strides) -> str:
  terms = []
  for v, s in zip(vars_, strides):
    terms.append('(long long)%s * %dll' % (v, s) if s != 1 else
                 '(long long)%s' % v)
  return ' + '.join(terms)


def _coords(ext, prefix='l') -> List[str]:
  """Lines decomposing the flat cell index ``i`` (minor axis fastest)."""
  dim = len(ext)
  lines = ['int r = i;']
  for a in range(dim - 1, 0, -1):
    lines.append('const int %s%d = r %% %d;' % (prefix, a, ext[a]))
    lines.append('r /= %d;' % ext[a])
  lines.append('const int %s0 = r;' % prefix)
  return lines


def _io_args(plan: TilePlan, void: bool) -> Tuple[List[str], List[str]]:
  """(declarations, names) of the kernel arguments: inputs, params,
  outputs."""
  st = plan.stencil
  decls, names = [], []
  for name in st.input_names:
    t = storage_ctype(st.symbol_table[name])
    decls.append('const %s* __restrict__ g_%s' % ('void' if void else t, name))
    names.append('g_%s' % name)
  for stmt in st.param_stmts:
    t = storage_ctype(stmt.dtype)
    decls.append('const %s* __restrict__ p_%s' % ('void' if void else t,
                                                  stmt.name))
    names.append('p_%s' % stmt.name)
  for name in st.output_names:
    t = storage_ctype(st.symbol_table[name])
    decls.append('%s* __restrict__ o_%s' % ('void' if void else t, name))
    names.append('o_%s' % name)
  return decls, names


def _kernel(plan: TilePlan) -> str:
  st = plan.stencil
  dim = plan.dim
  shape, tile, grid = plan.shape, plan.tile, plan.grid
  strides = _strides(shape)
  decls, _ = _io_args(plan, void=False)
  # kReplicas: blockIdx.y picks one of several grids laid out one after
  # another. A single grid launches the instantiation without that
  # offset, whose pointers stay kernel parameters.
  out = ['template <bool kReplicas>',
         '__global__ void __launch_bounds__(%d) soda_fused_@H@(%s) {' %
         (THREADS, ', '.join(decls)),
         '  extern __shared__ __align__(16) unsigned char soda_smem[];',
         '  if (kReplicas) {',
         '    const long long rep = blockIdx.y;']
  cells = int(np.prod(shape))
  for name in st.input_names:
    out.append('    g_%s += rep * %dll;' % (name, cells))
  for name in st.output_names:
    out.append('    o_%s += rep * %dll;' % (name, cells))
  out.append('  }')
  out.append('  long long bid = blockIdx.x;')
  for a in range(dim - 1, 0, -1):
    out.append('  const int o%d = (int)(bid %% %d) * %d;' % (a, grid[a],
                                                            tile[a]))
    out.append('  bid /= %d;' % grid[a])
  out.append('  const int o0 = (int)bid * %d;' % tile[0])
  params = ', '.join('p_%s' % s.name for s in st.param_stmts)

  def buf(name, const):
    t = storage_ctype(plan.dtype(name))
    return '%s%s* s_%s = reinterpret_cast<%s%s*>(soda_smem + %d);' % (
        'const ' if const else '', t, name, 'const ' if const else '', t,
        plan.offsets[name])

  def cell_loop(name, body):
    ext = plan.extent(name)
    neg = plan.spans[name][0]
    cells = int(np.prod(ext))
    lines = ['  for (int i = threadIdx.x; i < %d; i += %d) {' %
             (cells, THREADS)]
    lines += ['    ' + s for s in _coords(ext)]
    for a in range(dim):
      lines.append('    const int g%d = o%d - %d + l%d;' % (a, a, neg[a], a))
    lines += ['    ' + s for s in body]
    lines.append('  }')
    return lines

  # inputs: halo tiles, zero outside the array
  for name in st.input_names:
    if not plan.buffered(name):
      continue
    t = storage_ctype(plan.dtype(name))
    inside = ' && '.join('g%d >= 0 && g%d < %d' % (a, a, shape[a])
                         for a in range(dim))
    out.append('  {  // input %s' % name)
    out.append('    ' + buf(name, const=False))
    out += ['  ' + s for s in cell_loop(name, [
        '%s v = 0;' % t,
        'if (%s) v = g_%s[%s];' % (inside, name,
                                   _flat(['g%d' % a for a in range(dim)],
                                         strides)),
        's_%s[i] = v;' % name])]
    out.append('  }')
  out.append('  __syncthreads();')

  outputs = set(st.output_names)
  for k, stage in enumerate(plan.stages):
    name = stage.name
    t = storage_ctype(stage.dtype)
    lo, hi = plan.margins[name]
    neg = plan.spans[name][0]
    valid = ' && '.join('g%d >= %d && g%d < %d' % (a, lo[a], a,
                                                   shape[a] - hi[a])
                        for a in range(dim))
    body = ['%s v = 0;' % t, 'const bool ok = %s;' % valid, 'if (ok) {']
    loaders = []
    for p in _stage_parents(stage):
      pext = plan.extent(p)
      pneg = plan.spans[p][0]
      pt = storage_ctype(plan.dtype(p))
      args = ', '.join('int d%d' % a for a in range(dim))
      idx = ['l%d + d%d + %d' % (a, a, pneg[a] - neg[a]) for a in range(dim)]
      flat = '(' + idx[0] + ')'
      for a in range(1, dim):
        flat = '(%s) * %d + (%s)' % (flat, pext[a], idx[a])
      body.append('  auto ld_%s = [&](%s) -> %s { return s_%s[%s]; };' % (
          p, args, pt, p, flat))
      loaders.append('ld_%s' % p)
    call_args = ', '.join(loaders + ([params] if params else []))
    body.append('  v = soda_stage_%d(%s);' % (k, call_args))
    body.append('}')
    if plan.buffered(name):
      body.append('s_%s[i] = v;' % name)
    if name in outputs:
      own = ' && '.join('l%d >= %d && l%d < %d' % (a, neg[a], a,
                                                    neg[a] + tile[a])
                        for a in range(dim))
      body.append('if (ok && %s) o_%s[%s] = v;' % (
          own, name, _flat(['g%d' % a for a in range(dim)], strides)))
    out.append('  {  // stage %s' % name)
    for p in _stage_parents(stage):
      out.append('    ' + buf(p, const=True))
    if plan.buffered(name):
      out.append('    ' + buf(name, const=False))
    out += ['  ' + s for s in cell_loop(name, body)]
    out.append('  }')
    if k + 1 < len(plan.stages):
      out.append('  __syncthreads();')
  out.append('}')
  return '\n'.join(out)


def _launcher(plan: TilePlan) -> str:
  decls, names = _io_args(plan, void=True)
  st = plan.stencil
  casts = []
  for name in st.input_names:
    casts.append('(const %s*)g_%s' % (storage_ctype(st.symbol_table[name]),
                                       name))
  for stmt in st.param_stmts:
    casts.append('(const %s*)p_%s' % (storage_ctype(stmt.dtype), stmt.name))
  for name in st.output_names:
    casts.append('(%s*)o_%s' % (storage_ctype(st.symbol_table[name]), name))
  return '\n'.join([
      'extern "C" int soda_launch_@H@(%s, long long replicas, void* stream) {' %
      ', '.join(decls),
      '  const size_t smem = %d;' % plan.smem_bytes,
      '  if (smem > 48 * 1024) {',
      '    cudaError_t err = cudaFuncSetAttribute(soda_fused_@H@<false>,',
      '        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);',
      '    if (err == cudaSuccess)',
      '      err = cudaFuncSetAttribute(soda_fused_@H@<true>,',
      '          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);',
      '    if (err != cudaSuccess) return (int)err;',
      '  }',
      '  if (replicas == 1)',
      '    soda_fused_@H@<false><<<%d, %d, smem, (cudaStream_t)stream>>>(%s);'
      % (plan.n_tiles, THREADS, ', '.join(casts)),
      '  else',
      '    soda_fused_@H@<true><<<dim3(%d, (unsigned)replicas), %d, smem,'
      % (plan.n_tiles, THREADS),
      '                           (cudaStream_t)stream>>>(%s);' %
      ', '.join(casts),
      '  return (int)cudaGetLastError();',
      '}',
      '',
      'extern "C" const char* soda_error_string_@H@(int err) {',
      '  return cudaGetErrorString((cudaError_t)err);',
      '}',
  ])


def _host_loop(plan: TilePlan) -> str:
  st = plan.stencil
  dim = plan.dim
  shape = plan.shape
  strides = _strides(shape)
  decls, _ = _io_args(plan, void=False)
  cells = int(np.prod(shape))
  out = ['extern "C" int soda_host_@H@(%s, long long replicas) {' %
         ', '.join(decls)]
  bases = {name: 'g_%s' % name for name in st.input_names}
  params = ', '.join('p_%s' % s.name for s in st.param_stmts)
  outputs = set(st.output_names)
  for stage in plan.stages:
    if plan.buffered(stage.name):
      out.append('  std::vector<%s> h_%s(%d);' % (
          storage_ctype(stage.dtype), stage.name, cells))
      bases[stage.name] = 'h_%s.data()' % stage.name
  gvars = ['g%d' % a for a in range(dim)]
  out.append('  for (long long rep = 0; rep < replicas; ++rep) {')
  for k, stage in enumerate(plan.stages):
    name = stage.name
    lo, hi = plan.margins[name]
    indent = '    '
    out.append('    // stage %s' % name)
    for a in range(dim):
      out.append('%sfor (int g%d = %d; g%d < %d; ++g%d) {' % (
          indent, a, lo[a], a, shape[a] - hi[a], a))
      indent += '  '
    loaders = []
    for p in _stage_parents(stage):
      pt = storage_ctype(plan.dtype(p))
      args = ', '.join('int d%d' % a for a in range(dim))
      idx = _flat(['(%s + d%d)' % (g, a) for a, g in enumerate(gvars)],
                  strides)
      out.append('%sauto ld_%s = [&](%s) -> %s { return %s[%s]; };' % (
          indent, p, args, pt, bases[p], idx))
      loaders.append('ld_%s' % p)
    call_args = ', '.join(loaders + ([params] if params else []))
    out.append('%sconst %s v = soda_stage_%d(%s);' % (
        indent, storage_ctype(stage.dtype), k, call_args))
    flat = _flat(gvars, strides)
    if plan.buffered(name):
      out.append('%sh_%s[%s] = v;' % (indent, name, flat))
    if name in outputs:
      out.append('%so_%s[%s] = v;' % (indent, name, flat))
    for a in range(dim):
      indent = indent[:-2]
      out.append('%s}' % indent)
  for name in st.input_names:
    out.append('    g_%s += %dll;' % (name, cells))
  for name in st.output_names:
    out.append('    o_%s += %dll;' % (name, cells))
  out.append('  }')
  out.append('  return 0;')
  out.append('}')
  return '\n'.join(out)


def _note(plan: TilePlan) -> str:
  st = plan.stencil
  return '\n'.join([
      '// Fused SODA stencil kernel for `%s` at shape %s, tile %s.' % (
          st.app_name, plan.shape, plan.tile),
      '// Generated by soda_tpu_torch/backend/cuda_source.py; replaces the',
      '// TPU kernel soda_tpu/backend/pallas_kernel.py PallasExecutor._build',
      '// (pl.pallas_call at :1543).',
      '// Bound on this card: bytes. The unique traffic is each input read',
      '// once and each output written once (profiling.stream_bytes);',
      '// a stencil does a few operations per byte, far below the H100\'s',
      '// balance point. The design therefore makes one pass over device',
      '// memory for all %d stages and all iterate sweeps: one CTA per' %
      len(plan.stages),
      '// output tile loads its input halo tile into shared memory once and',
      '// keeps every intermediate stage there (%d bytes per CTA, buffers' %
      plan.smem_bytes,
      '// reused by liveness); only the outputs return to device memory.',
      '// Replicas (blockIdx.y) replace the TPU\'s sequential lax.map over the',
      '// compiled kernel (soda_tpu/parallel/replicate.py:55-69): R grids',
      '// take one launch; one grid launches the instantiation without the',
      '// replica offset.',
  ])


def generate(plan: TilePlan) -> KernelSource:
  """CUDA C++ source of the fused kernel for ``plan``."""
  funcs = [_stage_function(plan, k, stage)
           for k, stage in enumerate(plan.stages)]
  text = '\n'.join([
      _note(plan),
      '#include "soda_stencil.cuh"',
      '',
      '#ifdef __CUDACC__',
      '#define SODA_STAGE static __device__ __forceinline__',
      '#else',
      '#define SODA_STAGE static inline',
      '#include <vector>',
      '#endif',
      '',
      '\n'.join(funcs),
      '#ifdef __CUDACC__',
      _kernel(plan),
      '',
      _launcher(plan),
      '#else',
      _host_loop(plan),
      '#endif',
      '',
  ])
  digest = hashlib.sha256(text.encode()).hexdigest()[:16]
  return KernelSource(text=text.replace('@H@', digest), digest=digest)
