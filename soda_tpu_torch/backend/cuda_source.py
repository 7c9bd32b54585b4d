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
comment. A mode plan's kernel (``_mode_kernel``) walks runs of tiles
with a ``cp.async`` ring; the layout keys build the short form with a
region of stages in registers (``_short_kernel``'s ``region_block``,
with ``soda_pstage_<k>`` for packed 16-bit stages), and with
``_short=()`` the old layout forms: per-warp register windows
(``_value_blocks``, L1-L3) or chunked stage loops (L4). The generated text depends only on (stencil, shape, tile): the
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

from soda_tpu_torch.backend.tile_plan import (SMS, WARPS, TilePlan,
                                               copy_width, last_readers,
                                               register_rows, value_closure,
                                               walk_rows)

# Threads per CTA: every stage loop strides its tile extent by this.
THREADS = 32 * WARPS
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


def _cell_loop(plan: TilePlan, name: str, body: List[str],
               chunk: Optional[int] = None) -> List[str]:
  """A CTA's threads over the cells of ``name``'s extent around the tile
  at ``o0, o1, ...``: local ``l<a>`` and global ``g<a>`` coordinates;
  with ``chunk``, one axis-0 chunk of that many planes after another
  (the layout form L4)."""
  ext = plan.extent(name)
  neg = plan.spans[name][0]
  cells = int(np.prod(ext))
  if chunk is None:
    lines = ['  for (int i = threadIdx.x; i < %d; i += %d) {' %
             (cells, THREADS)]
  else:
    plane = cells // ext[0]
    lines = ['  for (int z = 0; z < %d; z += %d) {  // axis-0 chunks' % (
        ext[0], chunk),
             '  const int i_end = (z + %d < %d ? z + %d : %d) * %d;' % (
                 chunk, ext[0], chunk, ext[0], plane),
             '  for (int i = z * %d + threadIdx.x; i < i_end; i += %d) {' % (
                 plane, THREADS)]
  lines += ['    ' + s for s in _coords(ext)]
  for a in range(plan.dim):
    lines.append('    const int g%d = o%d - %d + l%d;' % (a, a, neg[a], a))
  lines += ['    ' + s for s in body]
  lines.append('  }')
  if chunk is not None:
    lines.append('  }')
  return lines


def _smem_ptr(plan: TilePlan, name: str, const: bool) -> str:
  t = storage_ctype(plan.dtype(name))
  return '%s%s* s_%s = reinterpret_cast<%s%s*>(soda_smem + %d);' % (
      'const ' if const else '', t, name, 'const ' if const else '', t,
      plan.offsets[name])


def _stage_blocks(plan: TilePlan, buf, valid, store) -> List[str]:
  """Every stage's block: the CTA's threads over the stage's extent, the
  stage function where the cell is valid, the value kept in its buffer
  and, for an output, stored; a barrier between consecutive stages
  (under ``compute_chunk``, each loop in axis-0 chunks). A value-mode
  plan's stages are ``_value_blocks`` instead.

  ``buf(name, const)`` declares a buffer's pointer, ``valid(a, lo, hi)``
  is the validity test on axis ``a``, and ``store(name, own)`` gives
  (declarations, lines) that store an output's value ``v`` where the
  cell lies in the tile (``own``)."""
  st = plan.stencil
  dim = plan.dim
  shape, tile = plan.shape, plan.tile
  params = ', '.join('p_%s' % s.name for s in st.param_stmts)
  outputs = set(st.output_names)
  if plan.warp is not None:
    return _value_blocks(plan, buf, valid, store)
  chunk = plan.layout.compute_chunk if plan.layout is not None else None
  out = []
  for k, stage in enumerate(plan.stages):
    name = stage.name
    t = storage_ctype(stage.dtype)
    lo, hi = plan.margins[name]
    neg = plan.spans[name][0]
    ok = ' && '.join(valid(a, lo[a], shape[a] - hi[a]) for a in range(dim))
    body = ['%s v = 0;' % t, 'const bool ok = %s;' % ok, 'if (ok) {']
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
    decls = []
    if name in outputs:
      own = ' && '.join('l%d >= %d && l%d < %d' % (a, neg[a], a,
                                                    neg[a] + tile[a])
                        for a in range(dim))
      decls, lines = store(name, own)
      body += lines
    out.append('  {  // stage %s' % name)
    for p in _stage_parents(stage):
      out.append('    ' + buf(p, const=True))
    if plan.buffered(name):
      out.append('    ' + buf(name, const=False))
    out += ['    ' + d for d in decls]
    out += ['  ' + s for s in _cell_loop(plan, name, body, chunk)]
    out.append('  }')
    if k + 1 < len(plan.stages):
      out.append('  __syncthreads();')
  return out


# the TPU code each layout form replaces (for the source note and the
# run's report)
LAYOUT_REPLACES = {
    'L1': 'soda_tpu/backend/pallas_kernel.py:656',
    'L2': 'soda_tpu/backend/pallas_kernel.py:221',
    'L3': 'soda_tpu/backend/pallas_kernel.py:724',
    'L4': 'soda_tpu/backend/pallas_kernel.py:1359',
}


def _packed_stage_function(plan: TilePlan, k: int, stage) -> str:
  """``soda_pstage_<k>``: a narrow stage (+ & | ^ over integer loads and
  literals, optimization.ranges.narrow16_stages) on two cells per
  32-bit word: ``__vadd2`` adds the halves apart, so each wraps mod
  2^16 as the 16-bit evaluation does; casts of 16 bits or more keep the
  16-bit representation; a literal is its low 16 bits in both halves.
  Each loader returns the pair of its parent's cells packed."""
  lines: List[str] = []
  deltas = _delta_fn(stage)
  counter = [0]

  def tmp(code):
    name = 'w%d' % counter[0]
    counter[0] += 1
    lines.append('const uint32_t %s = %s;' % (name, code))
    return name

  def emit(node):
    if isinstance(node, ir.Num):
      return '0x%08xu' % ((int(node.value) & 0xffff) * 0x10001)
    if isinstance(node, ir.Ref):
      return tmp('ld_%s(%s)' % (node.name, ', '.join(
          str(d) for d in deltas(node))))
    if isinstance(node, ir.Cast):
      return emit(node.expr)
    if isinstance(node, (ir.Expr, ir.LogicAnd)) and len(node.operand) == 1:
      return emit(node.operand[0])
    if not isinstance(node, (ir.AddSub, ir.BinaryAnd, ir.BinaryOr, ir.Xor)):
      raise utils.InternalError('not a narrow expression: %r' % node)
    acc = emit(node.operand[0])
    for opd, op in zip(node.operand[1:], node.operator):
      b = emit(opd)
      acc = tmp('soda::vadd2(%s, %s)' % (acc, b) if op == '+' else
                '(%s %s %s)' % (acc, op, b))
    return acc

  result = emit(stage.tensor.expr)
  parents = _stage_parents(stage)
  tparams = ', '.join('class L_%s' % p for p in parents)
  args = ', '.join('const L_%s& ld_%s' % (p, p) for p in parents)
  body = ''.join('  %s\n' % line for line in lines)
  return ('// stage %s, packed 16-bit pairs\n%sstatic __device__ '
          '__forceinline__ uint32_t soda_pstage_%d(%s) {\n%s  return %s;\n}\n'
          % (stage.name, 'template <%s>\n' % tparams if tparams else '', k,
             args, body, result))


def _unrolled(loops, body: List[str]) -> List[str]:
  """``body`` inside nested fully unrolled loops ``(var, start, stop)``
  (their indices are compile-time constants, so register arrays indexed
  by them stay in registers)."""
  out = []
  for var, start, stop in loops:
    out += ['#pragma unroll',
            'for (int %s = %d; %s < %d; ++%s) {' % (var, start, var, stop, var)]
  out += ['  ' + line for line in body]
  out.append('}' * len(loops))
  return out


def _value_blocks(plan: TilePlan, buf, valid, store) -> List[str]:
  """The stages of a value-mode plan (layout forms L1-L3, tile_plan
  ``WarpPlan``): each warp takes the tile's warp blocks in turn; per
  block it loads each input's frame rows from the input window in
  shared memory into registers (0 outside the window), evaluates every
  stage in registers (no barrier between stages) and stores each
  output's block cells that lie in the tile. ``buf``, ``valid`` and
  ``store`` as ``_stage_blocks``'s.

  A tensor's registers are ``r_<name>[rows...][cells]`` (``cells`` =
  C a lane; a narrow stage ``uint32_t [rows...][C / 2]``; a transposed
  region's stage ``t_<name>[width][lane_rows]``, frame columns by
  register and frame rows by lane). Non-minor taps index rows (roll:
  wrapped over the frame); minor taps rotate lanes (``soda::lane_get``)
  or, under ``lane_shift='slice'``, read the parent's rows staged in
  the warp's scratch after ``__syncwarp()``. Transposed regions enter
  and leave through a padded (+1 column) tile in the same scratch."""
  st = plan.stencil
  dim = plan.dim
  warp, layout = plan.warp, plan.layout
  C, W, word = warp.cells, warp.width, warp.word
  neg, block, window = warp.frame_neg, warp.block, warp.window
  grid = warp.grid(plan.tile)
  lane_rows = warp.lane_rows
  pad = warp.pad
  xw = W + 2 * pad
  params = ', '.join('p_%s' % s.name for s in st.param_stmts)
  readers = last_readers(plan.stages)
  outputs = set(st.output_names)
  rows = warp.rows
  members = layout.transposed
  narrow = layout.narrow16
  ivars = ['i%d' % a for a in range(dim - 1)]

  def ctype_of(name):
    return storage_ctype(plan.dtype(name))

  def counts(name):
    return [c for _, c in rows[name]]

  def decl(name):
    if name in narrow:
      return 'uint32_t r_%s%s[%d];' % (name, ''.join(
          '[%d]' % c for c in counts(name)), C // 2)
    return '%s r_%s%s[%d];' % (ctype_of(name), name, ''.join(
        '[%d]' % c for c in counts(name)), C)

  def row_loops(name, c_stop):
    return [(v, 0, n) for v, n in zip(ivars, counts(name))] + [
        ('c', 0, c_stop)]

  def flat_row(name, index):
    flat = index[0]
    for a in range(1, dim - 1):
      flat = '(%s) * %d + (%s)' % (flat, counts(name)[a], index[a])
    return flat

  def parent_rows(s_name, p_name):
    """Row index of ``p_name``'s registers read by ``s_name``'s cell at
    rows ``i<a>`` with deltas ``d<a>``."""
    out = []
    for a in range(dim - 1):
      if layout.roll:
        out.append('soda::wrap_index<%d>(i%d + d%d)' % (window[a], a, a))
      else:
        k = rows[s_name][a][0] - rows[p_name][a][0]
        out.append('i%d + d%d + %d' % (a, a, k) if k else
                   'i%d + d%d' % (a, a))
    return out

  lines: List[str] = []
  decls: List[str] = []
  for name in sorted(outputs):
    if name in {s.name for s in plan.stages}:
      decls += store(name, 'true')[0]
  made = set()  # tensors whose registers (cells layout) exist
  entered = set()  # tensors transposed in
  first_reader = {}
  for idx, stage in enumerate(plan.stages):
    for p in stage.load_offsets:
      first_reader.setdefault(p, idx)

  def load_input(name):
    ext = plan.extent(name)
    pneg = plan.spans[name][0]
    t = ctype_of(name)
    body = []
    conds = []
    for a in range(dim - 1):
      k = -neg[a] + pneg[a] + rows[name][a][0]
      body.append('const int y%d = w%d + i%d + %d;' % (a, a, a, k))
      conds.append('y%d >= 0 && y%d < %d' % (a, a, ext[a]))
    last = dim - 1
    body.append('const int y%d = w%d + lane * %d + c + %d;' % (
        last, last, C, -neg[last] + pneg[last]))
    conds.append('y%d >= 0 && y%d < %d' % (last, last, ext[last]))
    flat = 'y0'
    for a in range(1, dim):
      flat = '(%s) * %d + y%d' % (flat, ext[a], a)
    body.append('r_%s%s[c] = (%s) ? s_%s[%s] : (%s)0;' % (
        name, ''.join('[i%d]' % a for a in range(dim - 1)),
        ' && '.join(conds), name, flat, t))
    lines.extend(['// input %s: frame rows %s' % (name, rows[name]),
                  decl(name)] + _unrolled(row_loops(name, C), body))
    made.add(name)

  def cell_of(name, index, j):
    """Code of cell j (this lane's block, no shuffle) of ``name``."""
    r = 'r_%s%s' % (name, ''.join('[%s]' % i for i in index))
    if name in narrow:
      return 'soda::pcell_get<%d, %s>(%s, %s)' % (C, ctype_of(name), r, j)
    return '%s[%s]' % (r, j)

  def exchange(stage):
    """slice: stage the parents ``stage`` reads across lanes in the
    warp's scratch; returns parent -> word offset."""
    offs = {}
    at = 0
    body = []
    for p in sorted(stage.load_offsets):
      if p in st.param_names or not any(
          off[0] for off in stage.load_offsets[p]):
        continue
      offs[p] = at
      index = ivars
      body += _unrolled(row_loops(p, C), [
          'soda::xput<%d>(x_buf, %d + (%s) * %d + %d + lane * %d + c, %s);' %
          (word, at, flat_row(p, index), xw, pad, C,
           cell_of(p, index, 'c'))])
      at += int(np.prod(counts(p))) * xw
    if offs:
      lines.extend(['__syncwarp();  // the scratch is free'] + body +
                   ['__syncwarp();  // and staged'])
    return offs

  def transpose_in(p):
    """A region's entry: ``p``'s cells -> ``t_<p>``."""
    start = rows[p][0][0]
    t = ctype_of(p)
    lines.extend(['// %s transposed in' % p, '__syncwarp();'] + _unrolled(
        row_loops(p, C), ['soda::xput<%d>(x_buf, (i0 + %d) * %d + lane * %d '
                          '+ c, %s);' % (word, start, W + 1, C,
                                         cell_of(p, ['i0'], 'c'))]) +
                 ['__syncwarp();', '%s t_%s[%d][%d];' % (t, p, W, lane_rows)]
                 + _unrolled([('j', 0, W), ('c', 0, lane_rows)], [
                     't_%s[j][c] = soda::xget<%d, %s>(x_buf, (lane * %d + c) '
                     '* %d + j);' % (p, word, t, lane_rows, W + 1)]))
    entered.add(p)

  def transpose_out(name):
    """A region's exit: ``t_<name>`` -> its cells ``r_<name>``."""
    start = rows[name][0][0]
    t = ctype_of(name)
    lines.extend(['// %s transposed out' % name, '__syncwarp();'] +
                 _unrolled([('j', 0, W), ('c', 0, lane_rows)], [
                     'soda::xput<%d>(x_buf, (lane * %d + c) * %d + j, '
                     't_%s[j][c]);' % (word, lane_rows, W + 1, name)]) +
                 ['__syncwarp();', decl(name)] + _unrolled(
                     row_loops(name, C), [
                         'r_%s[i0][c] = soda::xget<%d, %s>(x_buf, (i0 + %d) '
                         '* %d + lane * %d + c);' % (name, word, t, start,
                                                     W + 1, C)]))
    made.add(name)

  for k, stage in enumerate(plan.stages):
    name = stage.name
    parents = [p for p in _stage_parents(stage) if p not in st.param_names]
    for p in parents:
      if p in st.input_names and p not in made:
        load_input(p)
    member = name in members
    loaders = []
    if member:
      for p in parents:
        if p not in members and p not in entered:
          transpose_in(p)
      body = []
      for p in parents:
        body.append('auto ld_%s = [&](int, int d1) -> %s { return t_%s['
                    'soda::wrap_index<%d>(j + d1)][c]; };' % (
                        p, ctype_of(p), p, W))
      call = ', '.join(['ld_%s' % p for p in parents] +
                       ([params] if params else []))
      body.append('t_%s[j][c] = soda_stage_%d(%s);' % (name, k, call))
      lines.extend(['// stage %s (transposed region)' % name,
                    '%s t_%s[%d][%d];' % (ctype_of(name), name, W,
                                         lane_rows)] +
                   _unrolled([('j', 0, W), ('c', 0, lane_rows)], body))
      if name in outputs or any(
          name in s.load_offsets and s.name not in members
          for s in plan.stages):
        transpose_out(name)
      continue
    offs = {} if layout.rotate else exchange(stage)
    packed = name in narrow
    args = ', '.join('int d%d' % a for a in range(dim))
    body = []
    for p in parents:
      index = parent_rows(name, p)
      r = 'r_%s%s' % (p, ''.join('[%s]' % i for i in index))
      j = '2 * c + d%d' % (dim - 1) if packed else 'c + d%d' % (dim - 1)
      if p in offs:
        at = '%d + (%s) * %d + %d + lane * %d + ' % (
            offs[p], flat_row(p, index), xw, pad, C)
        if packed:
          code = ('soda::pack2((uint32_t)soda::xget<%d, %s>(x_buf, %s%s), '
                  '(uint32_t)soda::xget<%d, %s>(x_buf, %s%s + 1))' % (
                      word, ctype_of(p), at, j, word, ctype_of(p), at, j))
        else:
          code = 'soda::xget<%d, %s>(x_buf, %s%s)' % (word, ctype_of(p), at,
                                                       j)
      elif packed:
        code = ('soda::ppair_get<%d>(%s, %s)' if p in narrow else
                'soda::pair_get<%d>(%s, %s)') % (C, r, j)
      elif p in narrow:
        code = 'soda::pcell_get<%d, %s>(%s, %s)' % (C, ctype_of(p), r, j)
      else:
        code = 'soda::lane_get<%d>(%s, %s)' % (C, r, j)
      body.append('auto ld_%s = [&](%s) -> %s { return %s; };' % (
          p, args, 'uint32_t' if packed else ctype_of(p), code))
    if packed:
      call = ', '.join('ld_%s' % p for p in parents)
      fn = 'soda_pstage_%d' % k
    else:
      call = ', '.join(['ld_%s' % p for p in parents] +
                       ([params] if params else []))
      fn = 'soda_stage_%d' % k
    body.append('r_%s%s[c] = %s(%s);' % (
        name, ''.join('[i%d]' % a for a in range(dim - 1)), fn, call))
    lines.extend(['// stage %s: rows %s%s' % (name, rows[name],
                                              ', packed' if packed else ''),
                  decl(name)] + _unrolled(row_loops(name, C // 2 if packed
                                                    else C), body))
    made.add(name)

  # stores: each output's block cells
  for name in st.output_names:
    if name not in made:
      continue
    lo, hi = plan.margins[name]
    oneg = plan.spans[name][0]
    own = ' && '.join('l%d >= %d && l%d < %d' % (
        a, oneg[a], a, oneg[a] + plan.tile[a]) for a in range(dim))
    body = []
    for a in range(dim - 1):
      body.append('const int t%d = w%d + i%d + %d;' % (
          a, a, a, rows[name][a][0] - neg[a]))
    last = dim - 1
    body.append('const int j = lane * %d + c;' % C)
    body.append('const int t%d = w%d + j - %d;' % (last, last, neg[last]))
    for a in range(dim):
      body.append('const int l%d = t%d + %d;' % (a, a, oneg[a]))
      body.append('const int g%d = o%d + t%d;' % (a, a, a))
    body.append('const bool ok = %s;' % ' && '.join(
        valid(a, lo[a], plan.shape[a] - hi[a]) for a in range(dim)))
    body.append('const %s v = %s;' % (ctype_of(name), cell_of(name, ivars,
                                                              'c')))
    body.append('if (j >= %d && j < %d) {' % (neg[last], neg[last] +
                                              block[last]))
    body += ['  ' + line for line in store(name, own)[1]]
    body.append('}')
    loops = [(v, neg[a] - rows[name][a][0], neg[a] - rows[name][a][0] +
              block[a]) for a, v in enumerate(ivars)] + [('c', 0, C)]
    lines.extend(['// store %s' % name] + _unrolled(loops, body))

  out = ['  {  // %s: warp blocks of %s outputs, frame %s, %d cell(s) a '
         'lane' % (layout.name, block, window, C)]
  for name in st.input_names:
    if plan.buffered(name):
      out.append('    ' + buf(name, const=True))
  out += ['    ' + d for d in decls]
  out.append('    const int lane = threadIdx.x & 31;')
  if warp.scratch:
    out.append('    unsigned char* x_buf = soda_smem + %d + (threadIdx.x >> 5)'
               ' * %d;' % (warp.scratch_offset, warp.scratch))
  out += ['    #pragma unroll 1',
          '    for (int wb = threadIdx.x >> 5; wb < %d; wb += %d) {' % (
              warp.n_blocks(plan.tile), WARPS),
          '      int q = wb;']
  for a in range(dim - 1, 0, -1):
    out.append('      const int w%d = (q %% %d) * %d;' % (a, grid[a],
                                                         block[a]))
    out.append('      q /= %d;' % grid[a])
  out.append('      const int w0 = q * %d;' % block[0])
  out += ['      ' + line for line in lines]
  out += ['    }', '  }']
  return out


def _kernel_head(plan: TilePlan, min_ctas: int = 0) -> List[str]:
  """The kernel's signature (``min_ctas``: resident CTAs an SM its
  launch bounds ask registers for), its replica offsets and the tile
  origin on every axis but the first (``o1, o2, ...``) from
  ``blockIdx.x``; what is left of the block index is in ``bid``."""
  st = plan.stencil
  grid, tile = plan.grid, plan.tile
  decls, _ = _io_args(plan, void=False)
  bounds = '%d, %d' % (THREADS, min_ctas) if min_ctas else '%d' % THREADS
  # kReplicas: blockIdx.y picks one of several grids laid out one after
  # another. A single grid launches the instantiation without that
  # offset, whose pointers stay kernel parameters.
  out = ['template <bool kReplicas>',
         '__global__ void __launch_bounds__(%s) soda_fused_@H@(%s) {' %
         (bounds, ', '.join(decls)),
         '  extern __shared__ __align__(16) unsigned char soda_smem[];',
         '  if (kReplicas) {',
         '    const long long rep = blockIdx.y;']
  cells = int(np.prod(plan.shape))
  for name in st.input_names:
    out.append('    g_%s += rep * %dll;' % (name, cells))
  for name in st.output_names:
    out.append('    o_%s += rep * %dll;' % (name, cells))
  out.append('  }')
  out.append('  long long bid = blockIdx.x;')
  for a in range(plan.dim - 1, 0, -1):
    out.append('  const int o%d = (int)(bid %% %d) * %d;' % (a, grid[a],
                                                            tile[a]))
    out.append('  bid /= %d;' % grid[a])
  return out


def _kernel(plan: TilePlan) -> str:
  st = plan.stencil
  dim = plan.dim
  shape, tile = plan.shape, plan.tile
  strides = _strides(shape)
  out = _kernel_head(plan)
  out.append('  const int o0 = (int)bid * %d;' % tile[0])

  # inputs: halo tiles, zero outside the array
  for name in st.input_names:
    if not plan.buffered(name):
      continue
    t = storage_ctype(plan.dtype(name))
    inside = ' && '.join('g%d >= 0 && g%d < %d' % (a, a, shape[a])
                         for a in range(dim))
    out.append('  {  // input %s' % name)
    out.append('    ' + _smem_ptr(plan, name, const=False))
    out += ['  ' + s for s in _cell_loop(plan, name, [
        '%s v = 0;' % t,
        'if (%s) v = g_%s[%s];' % (inside, name,
                                   _flat(['g%d' % a for a in range(dim)],
                                         strides)),
        's_%s[i] = v;' % name])]
    out.append('  }')
  out.append('  __syncthreads();')

  def store(name, own):
    return [], ['if (ok && %s) o_%s[%s] = v;' % (
        own, name, _flat(['g%d' % a for a in range(dim)], strides))]

  out += _stage_blocks(
      plan, lambda name, const: _smem_ptr(plan, name, const),
      lambda a, lo, hi: 'g%d >= %d && g%d < %d' % (a, lo, a, hi), store)
  out.append('}')
  return '\n'.join(out)


# -- the many-stage form (tile_plan.DeepForm) ---------------------------------
def _cell_map(ext) -> List[str]:
  """A thread's first cell of an extent (``m<a>``, the minor axis
  fastest): the map the 'cells' element computes once per run of stages
  with that extent."""
  dim = len(ext)
  if dim == 1:
    return ['const int m0 = threadIdx.x;']
  lines = ['const int m%d = threadIdx.x %% %d;' % (dim - 1, ext[-1])]
  rest = 'threadIdx.x / %d' % ext[-1]
  for a in range(dim - 2, 0, -1):
    lines.append('const int m%d = (%s) %% %d;' % (a, rest, ext[a]))
    rest = '(%s) / %d' % (rest, ext[a])
  lines.append('const int m0 = %s;' % rest)
  return lines


def _cell_coords(ext, j: int) -> List[str]:
  """Local coordinates ``l<a>`` of a thread's cell ``threadIdx.x + j *
  THREADS`` of an extent, from its map ``m<a>``: ``j * THREADS`` in the
  extent's mixed radix (compile-time digits) added digit by digit, each
  digit carrying at most one."""
  dim = len(ext)
  if j == 0:
    return ['const int l%d = m%d;' % (a, a) for a in range(dim)]
  digits, rest = [0] * dim, j * THREADS
  for a in range(dim - 1, 0, -1):
    digits[a], rest = rest % ext[a], rest // ext[a]
  digits[0] = rest
  lines, carry = [], ''
  for a in range(dim - 1, 0, -1):
    lines += ['int l%d = m%d + %d%s;' % (a, a, digits[a], carry),
              'const int k%d = l%d >= %d;' % (a, a, ext[a]),
              'if (k%d) l%d -= %d;' % (a, a, ext[a])]
    carry = ' + k%d' % a
  lines.append('const int l0 = m0 + %d%s;' % (digits[0], carry))
  return lines


def _fixed_cells(ext, body: List[str]) -> List[str]:
  """``body`` once for each of a thread's cells of an extent (the map's
  ``m<a>`` in scope), with ``i`` the cell's flat index and ``l<a>`` its
  coordinates; the last pass guarded where the extent is not a multiple
  of THREADS."""
  cells = int(np.prod(ext))
  out = []
  for j in range(-(-cells // THREADS)):
    left = cells - j * THREADS
    lines = ['const int i = threadIdx.x + %d;' % (j * THREADS)]
    lines += _cell_coords(ext, j) + body
    if left < THREADS:
      out += ['if (threadIdx.x < %d) {  // cell pass %d' % (left, j)]
    else:
      out += ['{  // cell pass %d' % j]
    out += ['  ' + s for s in lines] + ['}']
  return out


def _deep_kernel(plan: TilePlan) -> str:
  """The kernel of the many-stage form (tile_plan.DeepForm, with an
  element besides 'tile'): the input fill, then the stages in the plan's
  order with a barrier only before the stages ``deep.barriers`` names.
  'cells' walks each extent with ``_fixed_cells`` (one map per run of
  stages with one extent) in place of ``_cell_loop``'s division of every
  cell index; 'interior' instantiates the tile's body twice, and a CTA
  whose origin lies in ``deep.interior`` runs the one without bounds and
  valid-region tests (``kEdge`` false)."""
  st = plan.stencil
  dim = plan.dim
  shape, tile = plan.shape, plan.tile
  deep = plan.deep
  cells_on = deep.has('cells')
  strides = _strides(shape)
  params = ', '.join('p_%s' % s.name for s in st.param_stmts)
  outputs = set(st.output_names)
  gvars = ['g%d' % a for a in range(dim)]
  inputs = [n for n in st.input_names if plan.buffered(n)]
  out = _kernel_head(plan, deep.ctas)
  out.append('  const int o0 = (int)bid * %d;' % tile[0])

  def walk(name, body):
    if cells_on:
      return _fixed_cells(plan.extent(name), body)
    return [s[2:] for s in _cell_loop(plan, name, body)]

  def coords(name):
    neg = plan.spans[name][0]
    return ['const int g%d = o%d %s %d + l%d;' % (
        a, a, '-' if neg[a] >= 0 else '+', abs(neg[a]), a)
            for a in range(dim)] if cells_on else []

  body = []
  for name in inputs:  # halo tiles, 0 outside the array
    t = storage_ctype(plan.dtype(name))
    inside = ' && '.join('g%d >= 0 && g%d < %d' % (a, a, shape[a])
                         for a in range(dim))
    body += ['{  // input %s' % name, '  ' + _smem_ptr(plan, name, False)]
    cell = coords(name) + [
        '%s v = 0;' % t,
        'if (!kEdge || (%s)) v = g_%s[%s];' % (inside, name,
                                              _flat(gvars, strides)),
        's_%s[i] = v;' % name]
    if cells_on:
      body += ['  ' + s for s in _cell_map(plan.extent(name))]
    body += ['  ' + s for s in walk(name, cell)] + ['}']

  barriers = set(deep.barriers)
  mapped = None  # the extent whose map is in scope
  for k, stage in enumerate(plan.stages):
    name = stage.name
    ext = plan.extent(name)
    if k in barriers:
      body.append('__syncthreads();')
    if cells_on and ext != mapped:
      if mapped is not None:
        body.append('}')
      body += ['{  // cells of extent %s' % (ext,)] + [
          '  ' + s for s in _cell_map(ext)]
      mapped = ext
    t = storage_ctype(stage.dtype)
    lo, hi = plan.margins[name]
    neg = plan.spans[name][0]
    ok = ' && '.join('g%d >= %d && g%d < %d' % (a, lo[a], a, shape[a] - hi[a])
                     for a in range(dim))
    cell = coords(name) + ['%s v = 0;' % t,
                           'const bool ok = !kEdge || (%s);' % ok, 'if (ok) {']
    loaders = []
    for p in _stage_parents(stage):
      pext = plan.extent(p)
      pneg = plan.spans[p][0]
      pt = storage_ctype(plan.dtype(p))
      pstrides = _strides(pext)
      args = ', '.join('int d%d' % a for a in range(dim))
      base = ' + '.join('l%d * %d' % (a, s) if s != 1 else 'l%d' % a
                        for a, s in enumerate(pstrides))
      shift = sum((pneg[a] - neg[a]) * pstrides[a] for a in range(dim))
      taps = ' + '.join('d%d * %d' % (a, s) if s != 1 else 'd%d' % a
                        for a, s in enumerate(pstrides))
      cell += ['  const int b_%s = %s + %d;' % (p, base, shift),
               '  auto ld_%s = [&](%s) -> %s { return s_%s[b_%s + %s]; };' % (
                   p, args, pt, p, p, taps)]
      loaders.append('ld_%s' % p)
    cell.append('  v = soda_stage_%d(%s);' % (
        k, ', '.join(loaders + ([params] if params else []))))
    cell.append('}')
    if plan.buffered(name):
      cell.append('s_%s[i] = v;' % name)
    if name in outputs:
      own = ['l%d >= %d && l%d < %d' % (a, neg[a], a, neg[a] + tile[a])
             for a in range(dim) if plan.spans[name] != ((0,) * dim,) * 2]
      cell.append('if (%s) o_%s[%s] = v;' % (' && '.join(['ok'] + own), name,
                                             _flat(gvars, strides)))
    block = ['{  // stage %s, extent %s' % (name, ext)]
    for p in _stage_parents(stage):
      block.append('  ' + _smem_ptr(plan, p, True))
    if plan.buffered(name):
      block.append('  ' + _smem_ptr(plan, name, False))
    block += ['  ' + s for s in walk(name, cell)] + ['}']
    body += [('  ' if mapped else '') + s for s in block]
  if mapped is not None:
    body.append('}')

  run = ['auto tile_body = [&](auto edge) {',
         '  constexpr bool kEdge = decltype(edge)::value;']
  run += ['  ' + s for s in body]
  run.append('};')
  if deep.has('interior'):
    inside = ' && '.join('o%d >= %d && o%d <= %d' % (a, lo, a, hi)
                         for a, (lo, hi) in enumerate(deep.interior))
    run += ['// a CTA inside every stage\'s valid region (and its input',
            '// windows inside the array) runs without those tests',
            'if (%s) tile_body(std::false_type{});' % inside,
            'else tile_body(std::true_type{});']
  else:
    run.append('tile_body(std::true_type{});')
  out += ['  ' + s for s in run]
  out.append('}')
  return '\n'.join(out)


def _deep_note(plan: TilePlan) -> str:
  deep = plan.deep
  lines = _note(plan).split('\n')[:4] + [
      '// Many-stage form (tile_plan.DeepForm; elements %s):' %
      ', '.join(deep.elements),
      '// tile %s for %d resident CTAs an SM (%d bytes of shared memory' % (
          plan.tile, deep.ctas, plan.smem_bytes),
      '// each), %.1f stage evaluations an output; %d barriers a tile for %d'
      % (deep.evaluations, len(deep.barriers), len(plan.stages)),
      '// stages: a barrier only where a stage reads a buffer written since',
      '// the last one or writes bytes read since it (tile_plan.',
      '// hazard_barriers); buffers reused by liveness one barrier later.']
  return '\n'.join(lines + [
      '// Bound on this card: the larger of the bytes (each input read once,',
      '// each output written once) and the operations, each float operation',
      '// its own instruction under --fmad=false (profiling.bound_ms).'])


# -- the short form (tile_plan.ShortForm) -------------------------------------
def _short_kernel(plan: TilePlan) -> str:
  """The kernel of the short form (tile_plan.ShortForm): the input fill,
  then each stage not kept in registers with a barrier only before the
  stages ``short.barriers`` names. Each extent is walked by a thread map
  fixed per extent (``_cell_map``/``_fixed_cells``) over units of
  ``short.vec`` cells of a frame row: a thread loads the parents' cells
  its taps read as register rows (``tile_plan.register_rows``), then
  evaluates its cells, each after the register stages it reads
  (``short.values``, each with its own valid-region test and 0 outside
  it), and stores the unit to its buffer and, for an output's cells in
  the tile, to device memory. With ``vec`` > 1 the fill is 16-byte
  ``cp.async`` copies (a chunk outside the array reads nothing and
  lands as 0), the rows and the stores loads and stores of whole units;
  else one element each. 'interior' instantiates the body twice, and a
  tile whose origin lies in ``short.interior`` runs the one without
  bounds and valid-region tests (``kEdge`` false).

  'walk': a CTA walks ``plan.steps`` axis-0 tiles of one tile column.
  Each buffer is a ring of ``short.rings`` axis-0 rows, addressed from
  the tensor's phase ``ph_<name>``; the run's first step fills and
  computes whole extents, a later step only the rows it does not share
  with the step before (``kFirst``; an output also its tile's rows the
  step before computed, tile_plan.walk_rows), and a step's first act
  after its barrier is to issue the new input rows of the step
  ``short.depth - 1`` ahead (one cp.async group), the next step's waited
  for at its end.

  The public modes (``plan.config``): ``stream_loop`` is the walk (True
  and 'peel' build the same text: a step inside every stage's valid
  region already runs in the interior class, without axis-0 checks),
  ``prefetch`` its depth, ``dma_split`` cuts each fill into that many
  commit groups over axis-0 sub-ranges, and ``out_dma`` writes each
  output's tile into a staging buffer, then after a barrier stores it
  row by row (16 bytes a thread where the rows allow).

  The layout keys' region (``short.region``, tile_plan.Region) runs in
  place of its members' stages, after one barrier where one is due: the
  CTA's warps take work items (a strip of axis-0 rows, a row of each
  middle axis, a window of ``lanes`` lanes) in passes, and every lane
  of a warp runs every pass, so that each ``__shfl_sync`` meets all 32
  lanes (a surplus item recomputes the last one and stores nothing).
  Each array member is a register array of its rows by the lane's
  columns, built from shifted views of the arrays it reads (lane
  rotates, taken before any valid-region test) and register rows of
  its entries (their rows, middle rows and columns clamped into the
  entry's buffer); each exit's strip rows are stored by the window that
  owns the column."""
  st = plan.stencil
  dim, shape, tile = plan.dim, plan.shape, plan.tile
  short = plan.short
  vec, last = short.vec, plan.dim - 1
  walk = short.has('walk') and dim >= 2
  ahead = short.depth - 1  # the tiles whose rows are in flight
  split = plan.config.dma_split
  strides = _strides(shape)
  params = ', '.join('p_%s' % s.name for s in st.param_stmts)
  outputs = set(st.output_names)
  by_name = {s.name: s for s in plan.stages}
  index = {s.name: k for k, s in enumerate(plan.stages)}
  gvars = ['g%d' % a for a in range(dim)]

  def itemsize(name):
    return plan.dtype(name).np_dtype.itemsize

  def rows_range(name, first, part=None):
    """(first extent row, count) of the axis-0 rows a step computes or
    fills; ``part`` (j, n): the j-th of n sub-ranges of them (dma_split,
    as the mode kernel cuts its fills)."""
    ext0 = plan.extent(name)[0]
    start, count = 0, ext0
    if walk and not first:
      count = walk_rows(st, name, tile[0], plan.spans)
      start = ext0 - count
    if part is not None:
      j, n = part
      start += count // n * j + min(j, count % n)
      count = count // n + (1 if j < count % n else 0)
    return start, count

  def units(name, width, first, part=None):
    """The rows a step covers, and the frame row in units of
    ``width``."""
    if not last:
      return (short.pitch(name) // width,)
    return ((rows_range(name, first, part)[1],) + plan.extent(name)[1:-1] +
            (short.pitch(name) // width,))

  def row_coords(name, first, part=None):
    neg = plan.spans[name][0]
    e0 = rows_range(name, first, part)[0]
    return ['const int g%d = o%d %s %d + l%d;' % (
        a, a, '-' if neg[a] - (e0 if a == 0 else 0) >= 0 else '+',
        abs(neg[a] - (e0 if a == 0 else 0)), a) for a in range(last)]

  def row_flat(name, index_):
    """Flat cell index of the first frame column of row ``index_``."""
    ext = plan.extent(name)
    flat = index_[0] if last else '0'
    for a in range(1, last):
      flat = '(%s) * %d + (%s)' % (flat, ext[a], index_[a])
    return '(%s) * %d' % (flat, short.pitch(name)) if last else '0'

  def ring_row(name, row, var, phase=None):
    """(lines, expression) of the buffer row holding extent row ``row``
    of ``name``: the row itself, or under 'walk' its ring row."""
    if not walk:
      return [], row
    ring = short.rings[name]
    return ['int %s = %s + %s;' % (var, phase or 'ph_%s' % name, row),
            'if (%s >= %d) %s -= %d;' % (var, ring, var, ring)], var

  def fill_blocks(first, phase, part=None):
    lines, copies = [], False
    for name in st.input_names:  # frames, 0 outside the array
      if not plan.buffered(name):
        continue
      cv = short.fill_chunk(itemsize(name))
      a0 = short.frames[name][0]
      t = storage_ctype(plan.dtype(name))
      ext_u = units(name, cv, first, part)
      if not ext_u[0]:
        continue  # an empty sub-range
      e0 = rows_range(name, first, part)[0]
      inside = ' && '.join('g%d >= 0 && g%d < %d' % (a, a, shape[a])
                           for a in range(dim))
      cell = row_coords(name, first, part) + [
          'const int g%d = o%d - %d + l%d * %d;' % (last, last, a0, last, cv)]
      if walk:
        more, q0 = ring_row(name, 'l0 + %d' % e0, 'q0', phase(name))
        cell += more
        dst = 's_%s + %s + l%d * %d' % (
            name, row_flat(name, [q0] + ['l%d' % a for a in range(1, last)]),
            last, cv)
      elif e0:  # a later sub-range of the extent's rows
        dst = 's_%s + %d + i * %d' % (name, e0 * int(np.prod(
            plan.extent(name)[1:-1])) * short.pitch(name), cv)
      else:
        dst = 's_%s + i * %d' % (name, cv)
      if cv > 1:
        copies = True
        cell += ['const bool in = !kEdge || (%s);' % inside,
                 'soda::cp_async16(%s, in ? g_%s + (%s) : g_%s, in ? 16 : '
                 '0);' % (dst, name, _flat(gvars, strides), name)]
        how = '16-byte cp.async copies'
      else:
        cell += ['%s v = 0;' % t,
                 'if (!kEdge || (%s)) v = g_%s[%s];' % (
                     inside, name, _flat(gvars, strides)),
                 '*(%s) = v;' % dst if walk else 's_%s[i] = v;' % name]
        how = 'one element a thread'
      lines += ['{  // input %s: rows %s, frame [-%d, %d), %s' % (
          name, ext_u[:-1], a0, short.frames[name][1], how),
                '  ' + _smem_ptr(plan, name, False)]
      lines += ['  ' + s for s in _cell_map(ext_u)]
      lines += ['  ' + s for s in _fixed_cells(ext_u, cell)] + ['}']
    return lines, copies

  def split_fill(first, phase):
    """The fill of a step in ``split`` commit groups (dma_split): each
    sub-range of every input's rows, then its commit."""
    lines, copies = [], False
    for j in range(split):
      part, got = fill_blocks(first, phase, (j, split))
      copies = copies or got
      lines += (['// sub-range %d of %d' % (j + 1, split)] if split > 1
                else []) + part + ['soda::cp_async_commit();']
    if not copies:  # plain loads: no groups to commit
      lines = [x for x in lines if x != 'soda::cp_async_commit();']
    return lines, copies

  def valid(name):
    lo, hi = plan.margins[name]
    return ' && '.join('g%d >= %d && g%d < %d' % (a, lo[a], a,
                                                  shape[a] - hi[a])
                       for a in range(dim))

  def loaders(stage, j, rows_of):
    """``ld_<parent>`` of ``stage``'s cell j of the unit: an element of
    the register rows ``rows_of`` (register_rows), or a register stage's
    value."""
    lines = []
    args = ', '.join('int d%d' % a for a in range(dim))
    for p in _stage_parents(stage):
      pt = storage_ctype(plan.dtype(p))
      if p in short.values:
        lines.append('auto ld_%s = [&](%s) -> %s { return w_%s; };' % (
            p, ', '.join('int' for _ in range(dim)), pt, p))
        continue
      groups = [(g, lo) for (q, g), (lo, _) in rows_of.items() if q == p]
      code = None
      for n, (g, lo) in enumerate(reversed(groups)):
        pick = 'r_%s_%d[%s + d%d - (%d)]' % (
            p, len(groups) - 1 - n, j, last, lo)
        if code is None:
          code = pick
        else:
          test = ' && '.join('d%d == %d' % (a, g[a]) for a in range(last))
          code = '(%s) ? %s : %s' % (test, pick, code)
      lines.append('auto ld_%s = [&](%s) -> %s { return %s; };' % (
          p, args, pt, code))
    return lines

  def stage_blocks(first):
    body = []
    region = short.region
    for k, stage in enumerate(plan.stages):
      name = stage.name
      if name in short.values:
        continue
      if region is not None and name in region.members:
        if name == region.members[0]:
          if k in short.barriers:
            body.append('__syncthreads();')
          body += region_block(first)
        continue
      if k in short.barriers:
        body.append('__syncthreads();')
      closure = value_closure(stage, by_name, short.values)
      rows_of = register_rows(st, stage, by_name, short.values, vec)
      a_s = short.frames[name][0]
      neg = plan.spans[name][0]
      e0 = rows_range(name, first)[0]
      t = storage_ctype(stage.dtype)
      ext_u = units(name, vec, first)
      cell = row_coords(name, first) + [
          'const int x0 = l%d * %d - %d;  // the unit\'s first frame column'
          % (last, vec, a_s),
          'const int gc = o%d + x0;' % last]
      parents = sorted({p for p, _ in rows_of})
      counter = {}
      for (p, g), (lo, hi) in rows_of.items():  # (parent, group) order
        gid = counter.setdefault(p, 0)
        counter[p] += 1
        pneg = plan.spans[p][0]
        row = ['l%d + %d' % (a, g[a] + pneg[a] - neg[a] + (
            e0 if a == 0 else 0)) for a in range(last)]
        pt = storage_ctype(plan.dtype(p))
        cell.append('%s r_%s_%d[%d];  // %s row at %s, columns [x0%+d, '
                    'x0%+d)' % (pt, p, gid, hi - lo, p, g, lo, hi))
        cell.append('{')
        if last:
          more, row[0] = ring_row(p, row[0], 'q0')
          cell += ['  ' + line for line in more]
        cell.append('  const int at = %s + x0 + %d;' % (
            row_flat(p, row), short.frames[p][0] + lo))
        if vec > 1:
          cell += ['  soda::ldv<%d>(r_%s_%d + %d, s_%s + at + %d);' % (
              vec * itemsize(p), p, gid, q, p, q)
                   for q in range(0, hi - lo, vec)]
        else:
          cell += ['  r_%s_%d[%d] = s_%s[at + %d];' % (p, gid, q, p, q)
                   for q in range(hi - lo)]
        cell.append('}')
      each = ['const int g%d = gc + j;' % last]
      for s in closure:
        sk = index[s.name]
        each += ['%s w_%s = 0;' % (storage_ctype(s.dtype), s.name), '{'] + [
            '  ' + line for line in loaders(s, 'j', rows_of) + [
                'if (!kEdge || (%s)) w_%s = soda_stage_%d(%s);' % (
                    valid(s.name), s.name, sk, ', '.join(
                        ['ld_%s' % p for p in _stage_parents(s)] +
                        ([params] if params else [])))]] + ['}']
      each += loaders(stage, 'j', rows_of) + [
          '%s u = 0;' % t,
          'if (!kEdge || (%s)) u = soda_stage_%d(%s);' % (
              valid(name), k, ', '.join(['ld_%s' % p for p in
                                         _stage_parents(stage)] +
                                        ([params] if params else []))),
          'v[j] = u;']
      cell += ['%s v[%d];' % (t, vec)] + _unrolled([('j', 0, vec)], each)
      unit = vec * itemsize(name)
      if plan.buffered(name):
        if walk:
          more, w0 = ring_row(name, 'l0 + %d' % e0, 'w0')
          cell += more
          dst = 's_%s + %s + l%d * %d' % (
              name, row_flat(name, [w0] + ['l%d' % a
                                           for a in range(1, last)]),
              last, vec)
        else:
          dst = 's_%s + i * %d' % (name, vec)
        if vec > 1:
          cell.append('soda::stv<%d>(%s, v);' % (unit, dst))
        else:
          cell.append('*(%s) = v[0];' % dst if walk else
                      's_%s[i] = v[0];' % name)
      if name in outputs:
        own = ['l%d >= %d && l%d < %d' % (
            a, neg[a] - (e0 if a == 0 else 0), a,
            neg[a] - (e0 if a == 0 else 0) + tile[a])
               for a in range(last) if neg[a] or plan.spans[name][1][a]]
        if short.frames[name] != (0, tile[last]):
          own.append('x0 >= 0 && x0 < %d' % tile[last])
        inside = ' && '.join(['g%d < %d' % (a, shape[a])
                              for a in range(last)] +
                             ['gc < %d' % shape[last]])
        test = ' && '.join(own + ['(!kEdge || (%s))' % inside])
        at = _flat(['g%d' % a for a in range(last)] + ['gc'], strides)
        if plan.config.out_dma:  # into the staging tile (stored later)
          test = ' && '.join(own) or 'true'
          at = 'x0'
          for a in range(last - 1, -1, -1):
            at = '(g%d - o%d) * %d + %s' % (a, a, int(np.prod(
                tile[a + 1:])), at)
          where = 't_%s + (%s)' % (name, at)
        else:
          where = 'o_%s + (%s)' % (name, at)
        if vec > 1:
          cell.append('if (%s) soda::stv<%d>(%s, v);' % (test, unit, where))
        elif plan.config.out_dma:
          cell.append('if (%s) *(%s) = v[0];' % (test, where))
        else:
          cell.append('if (%s) o_%s[%s] = v[0];' % (test, name, at))
      block = ['{  // stage %s, rows %s, frame [-%d, %d), %d cell(s) a '
               'unit%s' % (name, ext_u[:-1], a_s, short.frames[name][1],
                           vec, ', registers: %s' % ', '.join(
                               s.name for s in closure) if closure else '')]
      for p in parents:
        block.append('  ' + _smem_ptr(plan, p, True))
      if plan.buffered(name):
        block.append('  ' + _smem_ptr(plan, name, False))
      if name in plan.staging:
        block.append('  %s* t_%s = reinterpret_cast<%s*>(soda_smem + %d);' %
                     (t, name, t, plan.staging[name]))
      block += ['  ' + s for s in _cell_map(ext_u)]
      block += ['  ' + s for s in _fixed_cells(ext_u, cell)] + ['}']
      body += block
    return body + (_staged_stores(plan, 'kEdge') if plan.staging else [])

  def clamp(var, lo, hi):
    return '%s = %s < %d ? %d : (%s > %d ? %d : %s);' % (
        var, var, lo, lo, var, hi, hi, var)

  def region_block(first):
    """The value-mode region (tile_plan.Region): each work item's strip,
    middle row and window, every member at its register rows in order,
    the exits stored by the window that owns the column."""
    reg = short.region
    cells, lanes, strip = reg.cells, reg.lanes, reg.strip
    members = set(reg.members)
    # the rows of the exits this step computes, tile-relative
    spans_ = []
    for e in reg.exits:
      start, count = rows_range(e, first)
      n0 = plan.spans[e][0][0]
      spans_.append((start - n0, start - n0 + count))
    lo_t, hi_t = min(a for a, _ in spans_), max(b for _, b in spans_)
    mids = [(min(-plan.spans[e][0][a] for e in reg.exits),
             max(tile[a] + plan.spans[e][1][a] for e in reg.exits))
            for a in range(1, last)]
    n_items = (-(-(hi_t - lo_t) // strip) * reg.windows *
               int(np.prod([b - a for a, b in mids] or [1])))
    per = (THREADS // 32) * (32 // lanes)
    lines = ['{  // region: %s in registers (%d-row strips, %d-lane '
             'windows of %d column(s) a lane), stored: %s' % (
                 ', '.join(reg.members), strip, lanes, cells,
                 ', '.join(reg.exits))]
    entries = sorted({p for m in reg.members
                      for p in by_name[m].load_offsets if p not in members})
    for p in entries:
      lines.append('  ' + _smem_ptr(plan, p, True))
    for e in reg.exits:
      if plan.buffered(e):
        lines.append('  ' + _smem_ptr(plan, e, False))
      if e in plan.staging:
        t = storage_ctype(plan.dtype(e))
        lines.append('  %s* t_%s = reinterpret_cast<%s*>(soda_smem + %d);' %
                     (t, e, t, plan.staging[e]))
    body = ['int item = pass * %d + slot;' % per,
            'const bool live = item < %d;' % n_items,
            'if (!live) item = %d;  // computes, stores nothing' %
            (n_items - 1)]
    if reg.windows > 1:
      body += ['const int w = item %% %d;' % reg.windows,
               'item /= %d;' % reg.windows]
    else:
      body.append('const int w = 0;')
    for a in range(last - 1, 0, -1):
      lo, hi = mids[a - 1]
      body += ['const int t%d = item %% %d + %d;' % (a, hi - lo, lo),
               'item /= %d;' % (hi - lo),
               'const int g%d = o%d + t%d;' % (a, a, a)]
    body += ['const int s0 = item * %d + %d;  // the strip\'s first row' %
             (strip, lo_t),
             'const int x0 = %d + w * %d + ll * %d;  // the lane\'s first '
             'column' % (reg.start, reg.stride, cells),
             'const int gc = o%d + x0;' % last,
             'const bool own = live && ll * %d >= %d && ll * %d < %d;  // '
             'the window stores these columns' % (
                 cells, reg.edge[0], cells, reg.edge[0] + reg.stride)]
    region_by = {n: by_name[n] for n in reg.members}
    for m in reg.arrays:
      t = storage_ctype(plan.dtype(m))
      rows = reg.rows(m)
      if m in reg.packed:
        body.append('uint32_t a_%s[%d][%d];  // packed pairs' % (
            m, rows, cells // 2))
      else:
        body.append('%s a_%s[%d][%d];' % (t, m, rows, cells))
    for m in reg.arrays:
      body += ['{  // %s: rows [s0 - %d, s0 + %d)' % (
          m, reg.halo[m][0], strip + reg.halo[m][1])]
      body += ['  ' + x for x in region_member(m, region_by)]
      body.append('}')
      if m in reg.exits:
        body += region_store(m, first)
    lines += ['  const int ll = (int)(threadIdx.x & %du);  // lane in its '
              'window' % (lanes - 1),
              '  const int slot = (int)(threadIdx.x >> 5) * %d + (int)('
              '(threadIdx.x & 31u) / %d);' % (32 // lanes, lanes),
              '  #pragma unroll 1',
              '  for (int pass = 0; pass < %d; ++pass) {' % -(-n_items // per)]
    lines += ['    ' + x for x in body] + ['  }', '}']
    return lines

  def region_member(m, region_by):
    """One array's rows: the shifted views of the arrays it reads (lane
    rotates, computed by every lane), then its cells, row by row, each
    row's entry register rows first."""
    reg = short.region
    cells = reg.cells
    stage = by_name[m]
    up = reg.halo[m][0]
    closure = value_closure(stage, by_name, reg.inline)
    out = []
    reads: Dict[str, List[Tuple[int, ...]]] = {}
    for s in closure + [stage]:
      for p in s.load_offsets:
        if p in reg.arrays:
          reads.setdefault(p, []).extend(
              tuple(reversed(o)) for o in s.load_offsets[p])
    views = {}
    for p, offs in sorted(reads.items()):
      d0 = (min(o[0] for o in offs), max(o[0] for o in offs))
      dl = (min(o[-1] for o in offs), max(o[-1] for o in offs))
      views[p] = (d0[0], dl[0])
      tp = storage_ctype(plan.dtype(p))
      base = reg.halo[p][0] - up + d0[0]  # p's row of view row 0
      need = sorted({(i + o[0] - d0[0], j + o[-1] - dl[0])
                     for i in range(reg.rows(m)) for j in range(cells)
                     for o in offs} | (
                         {(i + o[0] - d0[0], j + 1 + o[-1] - dl[0])
                          for i in range(reg.rows(m))
                          for j in range(0, cells, 2) for o in offs}
                         if m in reg.packed else set()))
      out.append('%s x_%s[%d][%d];  // %s at rows %+d.., columns %+d..' % (
          tp, p, reg.rows(m) + d0[1] - d0[0], cells + dl[1] - dl[0], p,
          d0[0], dl[0]))
      get = ('soda::pcell_get<%d, %s>' % (cells, tp) if p in reg.packed
             else 'soda::lane_get<%d>' % cells)
      out += ['x_%s[%d][%d] = %s(a_%s[%d], %d);' % (
          p, v, c, get, p, v + base, c + dl[0]) for v, c in need]
    entry_rows = register_rows(st, stage, by_name, reg.inline, cells,
                               skip=reg.members)
    row = ['const int t = s0 - %d + i;' % up, 'const int g0 = o0 + t;']
    counter: Dict[str, int] = {}
    gids = {}
    for (p, g), (lo, hi) in entry_rows.items():
      gid = counter.setdefault(p, 0)
      counter[p] += 1
      gids[(p, g)] = gid
      pt = storage_ctype(plan.dtype(p))
      ext = plan.extent(p)
      pneg = plan.spans[p][0]
      a_p, b_p = short.frames[p]
      row.append('%s r_%s_%d[%d];  // %s row at %s, columns [x0%+d, x0%+d)' % (
          pt, p, gid, hi - lo, p, g, lo, hi))
      row.append('{')
      idx = []
      for a in range(last):
        var = 'e%d' % a
        src = 't' if a == 0 else 't%d' % a
        row.append('  int %s = %s + %d;' % (var, src, g[a] + pneg[a]))
        row.append('  ' + clamp(var, 0, ext[a] - 1))
        idx.append(var)
      more, idx[0] = ring_row(p, idx[0], 'q0')
      row += ['  ' + x for x in more]
      row.append('  const int rb = %s + %d;' % (row_flat(p, idx), a_p))
      for q in range(0, hi - lo, cells):
        row += ['  {', '    int c = x0 + %d;' % (lo + q),
                '    ' + clamp('c', -a_p, b_p - cells)]
        if cells > 1:
          row.append('    soda::ldv<%d>(r_%s_%d + %d, s_%s + rb + c);' % (
              cells * plan.dtype(p).np_dtype.itemsize, p, gid, q, p))
        else:
          row.append('    r_%s_%d[%d] = s_%s[rb + c];' % (p, gid, q, p))
        row.append('  }')
      row.append('}')

    def loader(p, j, pair):
      """``ld_<p>`` at cell ``j`` (a pair at j, j + 1 where ``pair``)."""
      args = ', '.join('int d%d' % a for a in range(dim))
      pt = storage_ctype(plan.dtype(p))
      if p in reg.inline:
        return 'auto ld_%s = [&](%s) -> %s { return w_%s; };' % (
            p, ', '.join('int' for _ in range(dim)), pt, p)

      def cell(jj):
        if p in views:
          d0, dl = views[p]
          return 'x_%s[i + d0 - (%d)][%s + d%d - (%d)]' % (p, d0, jj, last,
                                                         dl)
        code = None
        groups = [(g, lo) for (q, g), (lo, _) in entry_rows.items() if q == p]
        for g, lo in reversed(groups):
          pick = 'r_%s_%d[%s + d%d - (%d)]' % (p, gids[(p, g)], jj, last, lo)
          if code is None:
            code = pick
          else:
            test = ' && '.join('d%d == %d' % (a, g[a]) for a in range(last))
            code = '(%s) ? %s : %s' % (test, pick, code)
        return code

      if pair:
        return ('auto ld_%s = [&](%s) -> uint32_t { return soda::pack2('
                '(uint32_t)%s, (uint32_t)%s); };' % (
                    p, args, cell(j), cell('%s + 1' % j)))
      return 'auto ld_%s = [&](%s) -> %s { return %s; };' % (
          p, args, pt, cell(j))

    def call(s, sk, pack=False):
      return 'soda_%sstage_%d(%s)' % ('p' if pack else '', sk, ', '.join(
          ['ld_%s' % p for p in _stage_parents(s)] +
          ([params] if params and not pack else [])))

    k = index[m]
    t = storage_ctype(stage.dtype)
    if m in reg.packed:
      each = ['const int g%d = gc + j;' % last]
      each += [loader(p, 'j', True) for p in _stage_parents(stage)]
      each += ['uint32_t u = %s;' % call(stage, k, True),
               'if (kEdge && !(%s)) u &= 0xffff0000u;' % valid(m),
               '{',
               '  const int g%d = gc + j + 1;' % last,
               '  if (kEdge && !(%s)) u &= 0x0000ffffu;' % valid(m),
               '}',
               'a_%s[i][j / 2] = u;' % m]
      cell_code = _unrolled([('jj', 0, cells // 2)],
                            ['const int j = 2 * jj;'] + each)
    else:
      each = ['const int g%d = gc + j;' % last]
      for s in closure:
        sk = index[s.name]
        each += ['%s w_%s = 0;' % (storage_ctype(s.dtype), s.name), '{'] + [
            '  ' + line for line in
            [loader(p, 'j', False) for p in _stage_parents(s)] + [
                'if (!kEdge || (%s)) w_%s = %s;' % (valid(s.name), s.name,
                                                     call(s, sk))]] + ['}']
      each += [loader(p, 'j', False) for p in _stage_parents(stage)]
      each += ['%s u = 0;' % t,
               'if (!kEdge || (%s)) u = %s;' % (valid(m), call(stage, k)),
               'a_%s[i][j] = u;' % m]
      cell_code = _unrolled([('j', 0, cells)], each)
    out += _unrolled([('i', 0, reg.rows(m))], row + cell_code)
    return out

  def region_store(e, first):
    """Exit ``e``'s strip rows: into its buffer (the rows this step
    computes, within its frame), and for an output its tile's cells to
    device memory (or the staging tile)."""
    reg = short.region
    cells = reg.cells
    up = reg.halo[e][0]
    t = storage_ctype(plan.dtype(e))
    size = cells * plan.dtype(e).np_dtype.itemsize
    neg = plan.spans[e][0]
    out = ['#pragma unroll', 'for (int i = %d; i < %d; ++i) {' % (
        up, up + reg.strip), '  const int t = s0 - %d + i;' % up]
    if e in reg.packed:
      out += ['  %s v[%d];' % (t, cells)] + [
          '  v[%d] = soda::unpack16<%s>(a_%s[i][%d] >> %d);' % (
              j, t, e, j // 2, 16 * (j % 2)) for j in range(cells)]
      src = 'v'
    else:
      src = 'a_%s[i]' % e
    if plan.buffered(e):
      start, count = rows_range(e, first)
      a_e, b_e = short.frames[e]
      ext = plan.extent(e)
      test = ['own', 't + %d >= %d' % (neg[0], start),
              't + %d < %d' % (neg[0], start + count),
              'x0 >= %d' % -a_e, 'x0 < %d' % b_e]
      test += ['t%d + %d >= 0 && t%d + %d < %d' % (a, neg[a], a, neg[a],
                                                   ext[a])
               for a in range(1, last)]
      idx = ['q'] + ['t%d + %d' % (a, neg[a]) for a in range(1, last)]
      out += ['  if (%s) {' % ' && '.join(test),
              '    int q = t + %d;' % neg[0]]
      more, idx[0] = ring_row(e, 'q', 'qr')
      out += ['    ' + x for x in more]
      dst = 's_%s + %s + x0 + %d' % (e, row_flat(e, idx), a_e)
      out.append('    soda::stv<%d>(%s, %s);' % (size, dst, src) if cells > 1
                 else '    *(%s) = %s[0];' % (dst, src))
      out.append('  }')
    if e in outputs:
      test = ['own', 't >= 0', 't < %d' % tile[0],
              'x0 >= 0', 'x0 < %d' % tile[last]]
      test += ['t%d >= 0 && t%d < %d' % (a, a, tile[a])
               for a in range(1, last)]
      inside = ' && '.join(['o0 + t < %d' % shape[0]] +
                           ['g%d < %d' % (a, shape[a])
                            for a in range(1, last)] +
                           ['gc < %d' % shape[last]])
      if plan.config.out_dma:
        at = 'x0'
        for a in range(last - 1, -1, -1):
          at = '(%s) * %d + %s' % ('t' if a == 0 else 't%d' % a,
                                   int(np.prod(tile[a + 1:])), at)
        where = 't_%s + (%s)' % (e, at)
      else:
        test.append('(!kEdge || (%s))' % inside)
        where = 'o_%s + (%s)' % (e, _flat(['(o0 + t)'] + [
            'g%d' % a for a in range(1, last)] + ['gc'], strides))
      out.append('  if (%s) %s' % (' && '.join(test), (
          'soda::stv<%d>(%s, %s);' % (size, where, src) if cells > 1 else
          '*(%s) = %s[0];' % (where, src))))
    out.append('}')
    return out

  # the launch bounds ask registers for the resident CTAs the shared
  # memory leaves; under stream_loop no more than its grid puts on an SM
  # (runs of steps_per_cta leave about two an SM: capping it there frees
  # registers that would otherwise spill). Elsewhere the grid's CTAs are
  # not the launch's: the replicated and sharded executors launch
  # replicas as gridDim.y.
  ctas = short.ctas
  if plan.config.stream_loop:
    ctas = min(ctas, -(-plan.n_ctas // SMS))
  out = _kernel_head(plan, ctas)
  inside = ' && '.join('o%d >= %d && o%d <= %d' % (a, lo, a, hi)
                       for a, (lo, hi) in enumerate(short.interior))
  if not walk:
    out.append('  const int o0 = (int)bid * %d;' % tile[0])
    body, copies = split_fill(True, None)
    if copies:
      body.append('soda::cp_async_wait<0>();  // this thread\'s copies landed')
    body += stage_blocks(True)
    run = ['auto tile_body = [&](auto edge) {',
           '  constexpr bool kEdge = decltype(edge)::value;']
    run += ['  ' + s for s in body]
    run.append('};')
    if short.has('interior'):
      run += ['// a CTA inside every stage\'s valid region (and its input',
              '// frames inside the array) runs without those tests',
              'if (%s) tile_body(std::false_type{});' % inside,
              'else tile_body(std::true_type{});']
    else:
      run.append('tile_body(std::true_type{});')
    out += ['  ' + s for s in run]
    out.append('}')
    return '\n'.join(out)

  steps, grid0 = plan.steps, plan.grid[0]
  rings = short.rings
  # The forks on ``ahead > 1`` (the fill's signature, the fills ahead of
  # the loop, the steady state's prefetch) and on ``split > 1`` (the
  # fill's commit inside split_fill or after fill_blocks) exist only to
  # keep the default depth-2 walk's text, and so the default kernels'
  # pinned digests (CELL_SOURCES), as they were before the modes joined
  # the walk; one text with ``ahead`` as a parameter compiles alike.
  fill_of = split_fill if split > 1 else fill_blocks
  first_fill, copies = fill_of(True, lambda name: 'ph_%s' % name)
  next_fill, _ = fill_of(False, lambda name: 'fph_%s' % name)
  # the groups a fill commits; where a wait leaves some in flight, a
  # step past the run's end commits as many empty ones (keeping the count)
  groups = split if copies else 0

  def close(indent):
    """The end of the branch that fills a step ahead."""
    if not groups or ahead == 1:
      return [indent + '}']
    return [indent + '} else {',
            indent + '  for (int j = 0; j < %d; ++j) soda::cp_async_commit();'
            % groups, indent + '}']

  run = ['const int k_first = (int)bid * %d;' % steps,
         'const int k_end = k_first + %d < %d ? k_first + %d : %d;' % (
             steps, grid0, steps, grid0),
         '// ring phases: extent row r of a step lies in ring row',
         '// (ph + r) mod rows',
         ] + ['int ph_%s = 0;  // %d rows' % (n, rows)
              for n, rows in rings.items()]
  if ahead > 1:
    run += ['// the input rows of step k, ``ahead`` steps after the current',
            '// one (kFirst: its whole extents; else those the step before',
            '// does not share), issued as cp.async copies where they are',
            '// 16-byte ones',
            'auto fill = [&](auto edge, auto first, int k, int ahead) {']
  else:
    run += ['// the input rows of step k (kFirst: its whole extents; else',
            '// those the step before does not share), issued as cp.async',
            '// copies where they are 16-byte ones',
            'auto fill = [&](auto edge, auto first, int k) {']
  run += ['  constexpr bool kEdge = decltype(edge)::value;',
          '  const int o0 = k * %d;' % tile[0],
          '  if constexpr (decltype(first)::value) {']
  run += ['    ' + s for s in first_fill]
  run += ['  } else {']
  run += ['    const int fph_%s = (ph_%s + %s) %% %d;' % (
      n, n, '%d' % tile[0] if ahead == 1 else 'ahead * %d' % tile[0],
      rings[n]) for n in st.input_names if n in rings]
  run += ['    ' + s for s in next_fill]
  run += ['  }']
  if copies and split == 1:
    run.append('  soda::cp_async_commit();')
  run += ['};',
          'auto step = [&](auto edge, auto first, int k) {',
          '  constexpr bool kEdge = decltype(edge)::value;',
          '  const int o0 = k * %d;' % tile[0],
          '  if constexpr (decltype(first)::value) {']
  run += ['    ' + s for s in stage_blocks(True)]
  run += ['  } else {']
  run += ['    ' + s for s in stage_blocks(False)]
  run += ['  }', '};']
  if short.has('interior'):
    run += ['// a step inside every stage\'s valid region (and its input',
            '// frames inside the array) runs without those tests',
            'auto inner = [&](int k) {',
            '  const int o0 = k * %d;' % tile[0],
            '  return %s;' % inside,
            '};']
  else:
    run += ['auto inner = [&](int) { return false; };']
  more = ', 1' if ahead > 1 else ''
  run += ['if (inner(k_first)) fill(std::false_type{}, std::true_type{}, '
          'k_first%s);' % more,
          'else fill(std::true_type{}, std::true_type{}, k_first%s);' % more]
  if ahead > 1:  # the steps after the first whose rows go ahead of it
    run += ['for (int j = 1; j < %d; ++j) {' % ahead,
            '  if (k_first + j < k_end) {',
            '    if (inner(k_first + j)) fill(std::false_type{}, '
            'std::false_type{}, k_first + j, j);',
            '    else fill(std::true_type{}, std::false_type{}, k_first + j, '
            'j);'] + close('  ') + ['}']
  if copies:
    run.append('soda::cp_async_wait<%d>();' % ((ahead - 1) * groups))
  run += ['#pragma unroll 1',
          'for (int k = k_first; k < k_end; ++k) {',
          '  __syncthreads();  // step k\'s input rows landed, step k - 1 '
          'done']
  if ahead > 1:
    run += ['  if (k + %d < k_end) {' % ahead,
            '    if (inner(k + %d)) fill(std::false_type{}, std::false_type{}, '
            'k + %d, %d);' % (ahead, ahead, ahead),
            '    else fill(std::true_type{}, std::false_type{}, k + %d, %d);'
            % (ahead, ahead)] + close('  ')
  else:
    run += ['  if (k + 1 < k_end) {',
            '    if (inner(k + 1)) fill(std::false_type{}, std::false_type{}, '
            'k + 1);',
            '    else fill(std::true_type{}, std::false_type{}, k + 1);',
            '  }']
  run += ['  const bool in = inner(k);',
          '  if (k == k_first) {',
          '    if (in) step(std::false_type{}, std::true_type{}, k);',
          '    else step(std::true_type{}, std::true_type{}, k);',
          '  } else {',
          '    if (in) step(std::false_type{}, std::false_type{}, k);',
          '    else step(std::true_type{}, std::false_type{}, k);',
          '  }']
  if copies:
    run.append('  soda::cp_async_wait<%d>();  // the next step\'s rows' %
               ((ahead - 1) * groups))
  run += ['  ph_%s = (ph_%s + %d) %% %d;' % (n, n, tile[0], rows)
          for n, rows in rings.items()]
  run.append('}')
  out += ['  ' + s for s in run]
  out.append('}')
  return '\n'.join(out)


def region_forms(plan: TilePlan) -> Tuple[str, ...]:
  """The layout forms a short plan's region (tile_plan.Region) builds:
  L1, L2 where a transposed lane region's members read each other at
  minor-axis offsets under 'slice' (under 'rotate' every member does,
  and the transposed set changes nothing), L3 where stages are packed.
  Keys that come to the same kernel name the same forms."""
  reg, layout = plan.short.region, plan.layout
  forms = ['L1']
  if not layout.rotate and any(m in layout.transposed for m in reg.members):
    forms.append('L2')
  if reg.packed:
    forms.append('L3')
  return tuple(forms)


def _short_note(plan: TilePlan) -> str:
  short = plan.short
  lines = _note(plan).split('\n')[:4] + [
      '// Short form (tile_plan.ShortForm; elements %s):' %
      ', '.join(short.elements),
      '// %d resident CTA(s) an SM (%d bytes of shared memory each); %s;' % (
          short.ctas, plan.smem_bytes,
          '%d cells a thread on the minor axis, 16-byte fills, loads and '
          'stores of whole units' % short.vec if short.vec > 1 else
          'one cell a thread'),
      '// stages in registers: %s; %d barriers a tile for %d stages;' % (
          ', '.join(short.values) or 'none', len(short.barriers),
          len(plan.stages)),
      '// %.2f stage evaluations and %.2f input cells filled an output.' % (
          short.evaluations, short.fills)]
  reg = short.region
  if reg is not None:
    forms = region_forms(plan)
    lines += [
        '// Layout %s (%s), as the short form\'s region: %s' % (
            '+'.join(forms), ', '.join(LAYOUT_REPLACES[f] for f in forms),
            ', '.join(reg.members)),
        '// in registers after one barrier: work items of a %d-row strip, '
        'one row of' % reg.strip,
        '// each middle axis and a window of %d lanes x %d column(s); an '
        'axis-0 tap' % (reg.lanes, reg.cells),
        '// a register index (halo rows computed once a strip), a minor-axis '
        'tap a',
        '// lane rotate (__shfl_sync); the window\'s edges (%d, %d '
        'columns) not' % reg.edge,
        '// stored. roll and window build this same text. About %d live '
        'register' % reg.regs,
        '// words a thread (the plan\'s estimate); stored: %s.' %
        ', '.join(reg.exits)]
    if reg.packed:
      lines.append('// narrow: %s as packed 16-bit pairs (__vadd2, & | ^).' %
                   ', '.join(reg.packed))
  for element in ('region', 'packed'):
    if element in short.off:
      lines.append('// layout element %s off: %s.' % (element,
                                                       short.off[element]))
  if short.has('walk') and plan.dim >= 2:
    lines += ['// walk: a CTA walks %d axis-0 tiles of one tile column (%d '
              'CTAs), each' % (plan.steps, plan.n_ctas),
              '// buffer a ring of axis-0 rows (%s), the next tile\'s new' %
              ', '.join('%s %d' % kv for kv in short.rings.items()),
              '// input rows in flight while a tile computes.']
  cfg = plan.config
  if cfg.stream_loop:
    lines += ['// stream_loop (%s): the walk, %d tiles a run' % (
        MODE_REPLACES['stream_loop'], plan.steps),
              '// (tile_plan.steps_per_cta); True and \'peel\' build this '
              'same text: a',
              '// step inside every stage\'s valid region runs without axis-0 '
              'checks.']
  if cfg.prefetch > 2:
    lines.append('// prefetch=%d (%s): the input rows of the %d tiles after '
                 'the current one in flight.' % (
                     cfg.prefetch, MODE_REPLACES['prefetch'], short.depth - 1))
  if cfg.dma_split > 1:
    lines.append('// dma_split=%d (%s): each fill in %d cp.async commit '
                 'groups over axis-0 sub-ranges.' % (
                     cfg.dma_split, MODE_REPLACES['dma_split'], cfg.dma_split))
  if cfg.out_dma:
    lines.append('// out_dma (%s): each output tile staged in shared memory, '
                 'stored after a barrier row by row.' % MODE_REPLACES['out_dma'])
  return '\n'.join(lines + [
      '// Bound on this card: bytes (each input read once, each output',
      '// written once; a stencil does a few operations per byte). The design',
      '// therefore makes one pass over device memory for all stages: one',
      '// CTA per output tile fills its input frames into shared memory once,',
      '// keeps the stages other stages read at offsets there and the rest in',
      '// registers, and stores only the outputs.'])


# -- the mode kernels (stream_loop, prefetch, dma_split, out_dma) -----------
def _fill_function(plan: TilePlan, index: int, name: str) -> List[str]:
  """``soda_fill_<index><kCheck0>``: the CTA's threads fill window rows
  [r0, r1) (axis 0) of input ``name`` around the tile at ``o0, ...``,
  as copy_width says: cp.async copies issued into the current commit
  group, or plain loads; cells outside the array read as 0 (cp.async's
  src-size 0 reads nothing). ``kCheck0`` false drops the axis-0 test of
  the array's bounds (a steady step's window lies inside)."""
  st = plan.stencil
  dim, shape = plan.dim, plan.shape
  ext = plan.extent(name)
  neg = plan.spans[name][0]
  t = storage_ctype(plan.dtype(name))
  width, phase = copy_width(st, name, shape, plan.tile, plan.spans)
  itemsize = plan.dtype(name).np_dtype.itemsize
  strides = _strides(shape)
  el = ext[-1]
  per_row = int(np.prod(ext[1:-1]))  # lines per axis-0 row of the window
  words = (el - phase) // 2
  units = el if width in (0, itemsize) else phase + words + (el - phase) % 2
  last = dim - 1
  how = {0: 'plain element loads',
         itemsize: '%d-byte cp.async per element' % itemsize}.get(
             width, '4-byte cp.async per element pair, window %d element(s) '
             'into its slot' % phase)
  out = ['// input %s: window %s, %s' % (name, ext, how),
         'template <bool kCheck0>',
         'static __device__ __forceinline__ void soda_fill_%d(%s* s, const %s* '
         '__restrict__ g, %s, int r0, int r1) {' % (
             index, t, t, ', '.join('int o%d' % a for a in range(dim))),
         '  const int n = (r1 - r0) * %d;' % (per_row * units),
         '  for (int i = threadIdx.x; i < n; i += %d) {' % THREADS,
         '    const int line = i / %d;' % units,
         '    const int u = i - line * %d;' % units,
         '    int r = line;']
  for a in range(dim - 2, 0, -1):
    out.append('    const int l%d = r %% %d;' % (a, ext[a]))
    out.append('    r /= %d;' % ext[a])
  out.append('    const int l0 = r0 + r;')
  for a in range(last):
    out.append('    const int g%d = o%d - %d + l%d;' % (a, a, neg[a], a))
  row_in = ['(!kCheck0 || (g0 >= 0 && g0 < %d))' % shape[0]]
  row_in += ['g%d >= 0 && g%d < %d' % (a, a, shape[a]) for a in range(1, last)]
  out.append('    const bool row_in = %s;' % ' && '.join(row_in))
  flat = 'l0'
  for a in range(1, last):
    flat = '(%s) * %d + l%d' % (flat, ext[a], a)
  out.append('    const int e = (%s) * %d;' % (flat, el))
  terms = ['(long long)g%d * %dll' % (a, strides[a]) for a in range(last)]
  out.append('    const long long gl = %s + (o%d - %d);' % (
      ' + '.join(terms), last, neg[-1]))

  def element(indent):
    return [indent + 'const int gc = o%d - %d + c;' % (last, neg[-1]),
            indent + 'const bool in = row_in && gc >= 0 && gc < %d;' %
            shape[-1],
            indent + 's[e + c] = in ? g[gl + c] : (%s)0;' % t]

  if width == 0:
    out.append('    const int c = u;')
    out += element('    ')
  elif width == itemsize:
    out += ['    const int c = u;',
            '    const int gc = o%d - %d + c;' % (last, neg[-1]),
            '    const bool in = row_in && gc >= 0 && gc < %d;' % shape[-1],
            '    soda::cp_async<%d>(s + e + c, in ? g + gl + c : g, in ? %d : '
            '0);' % (width, width)]
  else:
    out += ['    if (u < %d || u >= %d) {  // a row\'s odd edge element' % (
        phase, phase + words),
            '      const int c = u < %d ? 0 : %d;' % (phase, el - 1)]
    out += element('      ')
    out += ['    } else {  // an aligned pair: both in the array or neither',
            '      const int c = %d + 2 * (u - %d);' % (phase, phase),
            '      const int gc = o%d - %d + c;' % (last, neg[-1]),
            '      const bool in = row_in && gc >= 0 && gc < %d;' % shape[-1],
            '      soda::cp_async<4>(s + e + c, in ? g + gl + c : g, in ? 4 : '
            '0);',
            '    }']
  out += ['  }', '}', '']
  return out


def _staged_stores(plan: TilePlan, check: str = 'kCheck0') -> List[str]:
  """out_dma: after a barrier, each output's staged tile stored row by
  row (16 bytes per thread where the rows and the tile's rows are whole
  16-byte units, else one element per thread), clipped to the array
  (on axis 0 only where ``check``: the mode kernel's ``kCheck0``, the
  short form's ``kEdge``)."""
  st = plan.stencil
  dim, shape, tile = plan.dim, plan.shape, plan.tile
  strides = _strides(shape)
  last = dim - 1
  lines_per_tile = int(np.prod(tile[:-1]))
  out = ['    __syncthreads();']
  for name in st.output_names:
    t = storage_ctype(plan.dtype(name))
    itemsize = plan.dtype(name).np_dtype.itemsize
    vec = (tile[-1] * itemsize) % 16 == 0 and (shape[-1] * itemsize) % 16 == 0
    chunk = 16 // itemsize if vec else 1
    units = tile[-1] // chunk
    out += ['    {  // store %s: %s per thread' % (
        name, '16 bytes' if vec else 'one element'),
            '      const %s* t_%s = reinterpret_cast<const %s*>(soda_smem + '
            '%d);' % (t, name, t, plan.staging[name]),
            '      for (int i = threadIdx.x; i < %d; i += %d) {' % (
                lines_per_tile * units, THREADS),
            '        const int line = i / %d;' % units,
            '        const int c = (i - line * %d) * %d;' % (units, chunk),
            '        int r = line;']
    for a in range(dim - 2, 0, -1):
      out.append('        const int t%d = r %% %d;' % (a, tile[a]))
      out.append('        r /= %d;' % tile[a])
    out.append('        const int t0 = r;')
    inside = ['(!%s || o0 + t0 < %d)' % (check, shape[0])]
    inside += ['o%d + t%d < %d' % (a, a, shape[a]) for a in range(1, last)]
    inside.append('o%d + c < %d' % (last, shape[-1]))
    index = ' + '.join(['(long long)(o%d + t%d) * %dll' % (a, a, strides[a])
                        for a in range(last)] + ['(o%d + c)' % last])
    store = ('soda::store16(o_%s + gi, t_%s + line * %d + c);' if vec else
             'o_%s[gi] = t_%s[line * %d + c];') % (name, name, tile[-1])
    out += ['        if (%s) {' % ' && '.join(inside),
            '          const long long gi = %s;' % index,
            '          ' + store,
            '        }',
            '      }',
            '    }']
  return out


def _mode_kernel(plan: TilePlan) -> str:
  """The kernel of a mode plan (tile_plan.KernelConfig): a CTA walks
  ``plan.steps`` axis-0 tiles of one tile column; each step's input
  windows are filled into a ring of ``plan.slots`` slots ``slots - 1``
  steps ahead, as ``dma_split`` commit groups each; with ``rolling`` a
  step after the run's first loads only its new rows and takes the
  overlap from the previous window; under 'peel' the steady steps drop
  the axis-0 bounds checks; ``out_dma`` stages the outputs."""
  st = plan.stencil
  dim, shape, tile, grid = plan.dim, plan.shape, plan.tile, plan.grid
  strides = _strides(shape)
  cfg = plan.config
  slots, split, steps = plan.slots, cfg.dma_split, plan.steps
  k_lo, k_hi = plan.steady
  inputs = [n for n in st.input_names if plan.buffered(n)]
  out = []
  for i, name in enumerate(inputs):
    out += _fill_function(plan, i, name)
  out += _kernel_head(plan)
  out += ['  const int k_first = (int)bid * %d;' % steps,
          '  const int k_end = k_first + %d < %d ? k_first + %d : %d;' % (
              steps, grid[0], steps, grid[0])]

  def window(name, slot, const=False):
    t = storage_ctype(plan.dtype(name))
    return 'reinterpret_cast<%s%s*>(soda_smem + %d + (%s) * %d)' % (
        'const ' if const else '', t, plan.offsets[name], slot,
        plan.slot_bytes[name])

  # fill: the windows of step k into `slot`, `split` commit groups
  out += ['  auto fill = [&](auto kc, int k, int slot) {',
          '    constexpr bool kCheck0 = decltype(kc)::value;',
          '    const int o0 = k * %d;' % tile[0]]
  others = ''.join(', o%d' % a for a in range(1, dim))
  for i, name in enumerate(inputs):
    first = plan.halo0(name) if plan.rolling else 0
    out.append('    const int r0_%d = k == k_first ? 0 : %d;' % (i, first)
               if first else '    const int r0_%d = 0;' % i)
  if split == 1:
    for i, name in enumerate(inputs):
      out.append('    soda_fill_%d<kCheck0>(%s, g_%s, o0%s, r0_%d, %d);' % (
          i, window(name, 'slot'), name, others, i, plan.extent(name)[0]))
    out.append('    soda::cp_async_commit();')
  else:
    out.append('    for (int j = 0; j < %d; ++j) {  // plane sub-ranges' %
               split)
    for i, name in enumerate(inputs):
      rows = '(%d - r0_%d)' % (plan.extent(name)[0], i)
      out += ['      const int a_%d = r0_%d + (%s / %d) * j + (j < %s %% %d '
              '? j : %s %% %d);' % (i, i, rows, split, rows, split, rows,
                                    split),
              '      const int b_%d = a_%d + %s / %d + (j < %s %% %d ? 1 : '
              '0);' % (i, i, rows, split, rows, split),
              '      soda_fill_%d<kCheck0>(%s, g_%s, o0%s, a_%d, b_%d);' % (
                  i, window(name, 'slot'), name, others, i, i)]
    out += ['      soda::cp_async_commit();', '    }']
  out.append('  };')

  steady = '%d <= k && k <= %d' % (k_lo, k_hi)
  out += ['  auto issue = [&](int k, int slot) {',
          '    if (k < k_end) {']
  if plan.peel:
    out += ['      if (%s) fill(std::false_type{}, k, slot);' % steady,
            '      else fill(std::true_type{}, k, slot);']
  else:
    out.append('      fill(std::true_type{}, k, slot);')
  out += ['    } else {  // no such step: empty groups keep the count',
          '      for (int j = 0; j < %d; ++j) soda::cp_async_commit();' %
          split,
          '    }',
          '  };']

  # step: every stage over the tile at (k * tile[0], o1, ...)
  def buf(name, const):
    if name in st.input_names:
      t = storage_ctype(plan.dtype(name))
      return 'const %s* s_%s = %s;' % (t, name, window(name, 'slot', True))
    return _smem_ptr(plan, name, const)

  def valid(a, lo, hi):
    test = 'g%d >= %d && g%d < %d' % (a, lo, a, hi)
    return '(!kCheck0 || (%s))' % test if a == 0 else test

  tstrides = _strides(tile)

  def store(name, own):
    if not cfg.out_dma:
      return [], ['if (ok && %s) o_%s[%s] = v;' % (
          own, name, _flat(['g%d' % a for a in range(dim)], strides))]
    t = storage_ctype(plan.dtype(name))
    neg = plan.spans[name][0]
    local = ' + '.join('(l%d - %d) * %d' % (a, neg[a], tstrides[a])
                       for a in range(dim))
    return (['%s* t_%s = reinterpret_cast<%s*>(soda_smem + %d);' % (
        t, name, t, plan.staging[name])],
            ['if (%s) t_%s[%s] = v;' % (own, name, local)])

  out += ['  auto step = [&](auto kc, int k, int slot) {',
          '    constexpr bool kCheck0 = decltype(kc)::value;',
          '    const int o0 = k * %d;' % tile[0]]
  out += ['  ' + s for s in _stage_blocks(plan, buf, valid, store)]
  if cfg.out_dma:
    out += _staged_stores(plan)
  out.append('  };')

  if slots > 1:
    out.append('  for (int f = 0; f < %d; ++f) issue(k_first + f, f);' %
               (slots - 1))
  out += ['  #pragma unroll 1',
          '  for (int k = k_first; k < k_end; ++k) {',
          '    const int it = k - k_first;',
          '    const int slot = it %% %d;' % slots,
          '    // every thread is done with the slot the next fill overwrites',
          '    if (it > 0) __syncthreads();',
          '    issue(k + %d, (it + %d) %% %d);' % (slots - 1, slots - 1, slots),
          '    soda::cp_async_wait<%d>();  // step k\'s groups have landed' %
          ((slots - 1) * split),
          '    __syncthreads();']
  if plan.rolling:
    out.append('    if (k + 1 < k_end) {  // the next window starts with this '
               'one\'s last rows')
    for name in inputs:
      halo = plan.halo0(name)
      if not halo:
        continue
      row = int(np.prod(plan.extent(name)[1:]))
      t = storage_ctype(plan.dtype(name))
      out += ['      {',
              '        const %s* src = %s + %d;' % (
                  t, window(name, 'slot', True), tile[0] * row),
              '        %s* dst = %s;' % (t, window(name, '(it + 1) %% %d' %
                                                 slots)),
              '        for (int i = threadIdx.x; i < %d; i += %d) dst[i] = '
              'src[i];' % (halo * row, THREADS),
              '      }']
    out.append('    }')
  if plan.peel:
    out += ['    if (k != k_first && k != k_end - 1 && %s)' % steady,
            '      step(std::false_type{}, k, slot);',
            '    else',
            '      step(std::true_type{}, k, slot);']
  else:
    out.append('    step(std::true_type{}, k, slot);')
  out += ['  }', '}']
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
      % (plan.n_ctas, THREADS, ', '.join(casts)),
      '  else',
      '    soda_fused_@H@<true><<<dim3(%d, (unsigned)replicas), %d, smem,'
      % (plan.n_ctas, THREADS),
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
  readers = last_readers(plan.stages)
  for stage in plan.stages:
    if stage.name in readers:
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
    if name in readers:
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


def _mode_note(plan: TilePlan) -> str:
  st = plan.stencil
  cfg = plan.config
  lines = [
      '// Fused SODA stencil kernel for `%s` at shape %s, tile %s, in the' % (
          st.app_name, plan.shape, plan.tile),
      '// modes %s.' % mode_name(cfg),
      '// Generated by soda_tpu_torch/backend/cuda_source.py; replaces the',
      '// TPU kernel soda_tpu/backend/pallas_kernel.py PallasExecutor._build',
      '// (pl.pallas_call at :1543) in the same modes:']
  if cfg.stream_loop:
    lines += [
        '// - stream_loop=%r (%s): one CTA walks %d' % (
            cfg.stream_loop, MODE_REPLACES['stream_loop'], plan.steps),
        '//   consecutive axis-0 tiles of one tile column (%d CTAs; the run' %
        plan.n_ctas,
        '//   is the longest that keeps tile_plan.MIN_CTAS), its input',
        '//   windows kept in shared memory from step to step.']
    if plan.rolling:
      lines += [
          '//   Rolling fill (pallas_kernel.py:857-1003): a step after the',
          '//   run\'s first loads only its %d new rows and copies the rows it' %
          plan.tile[0],
          '//   shares with the previous window inside shared memory.']
    if plan.peel:
      lines += [
          '//   \'peel\' (:1456-1495): a run\'s first and last steps, and steps',
          '//   near the array\'s axis-0 ends, keep the axis-0 bounds checks;',
          '//   the steady steps (axis-0 tiles %d..%d) run without them.' %
          plan.steady]
  if cfg.prefetch > 2:
    lines += [
        '// - prefetch=%d (%s): a ring of %d windows' % (
            cfg.prefetch, MODE_REPLACES['prefetch'], plan.slots),
        '//   per input, filled with cp.async %d steps ahead (commit_group,' %
        (plan.slots - 1),
        '//   then wait_group leaves the later steps\' groups in flight).']
  if cfg.dma_split > 1:
    lines += [
        '// - dma_split=%d (%s): each fill issued as %d' % (
            cfg.dma_split, MODE_REPLACES['dma_split'], cfg.dma_split),
        '//   cp.async commit groups over plane sub-ranges; a step waits for',
        '//   all of them.']
  if cfg.out_dma:
    lines += [
        '// - out_dma (%s): each output tile staged in' %
        MODE_REPLACES['out_dma'],
        '//   shared memory, stored after a barrier row by row (16 bytes per',
        '//   thread where the rows allow).']
  lines += [
      '// Bound on this card: bytes (each input read once, each output',
      '// written once; a stencil does a few operations per byte). What the',
      '// modes do about it: rows that consecutive windows share are read',
      '// from device memory once (rolling); the next steps\' loads are in',
      '// flight while a step computes (cp.async ring, commit groups); outputs',
      '// leave as whole rows (staging). Cells outside the array are filled',
      '// with 0, as the default kernel does: cp.async with src-size 0 reads',
      '// nothing. %d bytes of shared memory per CTA, %d window slot(s) per' % (
          plan.smem_bytes, plan.slots),
      '// input.']
  if plan.layout is not None:
    lines += _layout_note(plan)
  return '\n'.join(lines)


# The TPU code each mode replaces (for the source note and the run's
# report).
MODE_REPLACES = {
    'stream_loop': 'soda_tpu/backend/pallas_kernel.py:1456',
    'prefetch': 'soda_tpu/backend/pallas_kernel.py:825',
    'dma_split': 'soda_tpu/backend/pallas_kernel.py:369',
    'out_dma': 'soda_tpu/backend/pallas_kernel.py:1018',
}


def mode_name(config) -> str:
  """A short name of a kernel config, e.g. ``peel+prefetch3``."""
  parts = []
  if config.stream_loop:
    parts.append('peel' if config.stream_loop == 'peel' else 'stream')
  if config.prefetch > 2:
    parts.append('prefetch%d' % config.prefetch)
  if config.dma_split > 1:
    parts.append('split%d' % config.dma_split)
  if config.out_dma:
    parts.append('out_dma')
  return '+'.join(parts) or 'default'


def _layout_note(plan: TilePlan) -> List[str]:
  """Source note lines of a layout form (plan.layout)."""
  layout = plan.layout
  lines = ['// Layout form %s (%s), the H100 form of the TPU kernel\'s '
           'layout keys' % (layout.form, layout.name),
           '// (%s):' % LAYOUT_REPLACES[layout.form]]
  if layout.compute_chunk is not None:
    return lines + [
        '// compute_chunk=%d: every stage buffer in shared memory as in the'
        % layout.compute_chunk,
        '// default kernel, each stage loop walking the tile in axis-0 chunks',
        '// of %d planes.' % layout.compute_chunk]
  warp = plan.warp
  lines += [
      '// stage_mode=\'value\': each of the %d warps takes warp blocks of %s'
      % (WARPS, warp.block,),
      '// outputs in turn and evaluates every stage over a frame of %s cells' %
      (warp.window,),
      '// in registers (%d cell(s) a lane), with no barrier between stages;' %
      warp.cells,
      '// an axis-0 tap is a register index, a minor-axis tap %s.' % (
          'a lane rotate (__shfl_sync)' if layout.rotate else
          'a read of the parent\'s rows staged in a per-warp shared-memory '
          'row after __syncwarp()'),
      '// shift_mode=\'%s\': %s' % (layout.shift_mode,
                                    'each stage over the whole frame, with '
                                    'wrap-around' if layout.roll else
                                    'each stage over its own span'),
      '// (the wrapped cells feed no stored output). About %d live register'
      % warp.regs,
      '// values a thread (the plan\'s estimate).']
  if layout.transposed:
    lines += ['// transpose_lanes: stages %s hold their values transposed'
              % ', '.join(sorted(layout.transposed)),
              '// (frame columns by register), so their minor-axis taps are '
              'register',
              '// indices; entries and exits pass a padded shared-memory '
              'transpose.']
  if layout.narrow16:
    lines += ['// narrow: stages %s run on two cells per 32-bit word'
              % ', '.join(sorted(layout.narrow16)),
              '// (__vadd2, & | ^; odd offsets realigned by __byte_perm).']
  return lines


def generate(plan: TilePlan) -> KernelSource:
  """CUDA C++ source of the fused kernel for ``plan`` (a mode plan's
  kernel where ``plan.config`` sets a mode, a layout form where it sets
  a layout)."""
  funcs = [_stage_function(plan, k, stage)
           for k, stage in enumerate(plan.stages)]
  config = plan.config
  deep = plan.deep is not None and plan.deep.elements != ('tile',)
  if deep:
    note = _deep_note(plan)
  elif plan.short is not None:
    note = _short_note(plan)
  elif config.is_default:
    note = _note(plan)
  elif config.one_tile:
    note = '\n'.join(_note(plan).split('\n')[:4] + _layout_note(plan))
  else:
    note = _mode_note(plan)
  packed = []
  if plan.short is not None and plan.short.region is not None:
    packed = [_packed_stage_function(plan, k, stage)
              for k, stage in enumerate(plan.stages)
              if stage.name in plan.short.region.packed]
  elif plan.short is None and plan.layout is not None:
    packed = [_packed_stage_function(plan, k, stage)
              for k, stage in enumerate(plan.stages)
              if stage.name in plan.layout.narrow16]
  text = '\n'.join([
      note,
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
      ''.join(p + '\n' for p in packed) +
      (_deep_kernel(plan) if deep else _short_kernel(plan)
       if plan.short is not None else _kernel(plan) if config.one_tile
       else _mode_kernel(plan)),
      '',
      _launcher(plan),
      '#else',
      _host_loop(plan),
      '#endif',
      '',
  ])
  digest = hashlib.sha256(text.encode()).hexdigest()[:16]
  return KernelSource(text=text.replace('@H@', digest), digest=digest)
