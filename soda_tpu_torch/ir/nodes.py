"""Expression IR for SODA-TPU.

This is the rebuild's equivalent of the external ``haoda.ir`` expression
layer that the reference imports everywhere (reconstructed interface in
SURVEY.md §2.9; node classes registered at
reference src/soda/grammar.py:209-232). Same capabilities —
visitor-based rewriting, structural equality for CSE, reduction helpers —
but implemented as plain Python classes with no textX dependency.

Node taxonomy:
  chain nodes  Expr(||) LogicAnd(&&) BinaryOr(|) Xor(^) BinaryAnd(&)
               EqCmp(== !=) LtCmp(< <= > >=) AddSub(+ -) MulDiv(* / %)
               -- each holds ``operand`` (n children) and ``operator``
               (n-1 op strings)
  Unary        prefix operator string(s) applied to one operand
  Cast         explicit type conversion ``type(expr)``
  Call         intrinsic function call, e.g. ``min(a, b)``, ``sqrt(x)``
  Ref          stencil tensor access ``name(i, j)`` with optional ``~lat``
  Var          scalar variable (a ``let`` binding or param element access)
  Let          typed local binding inside a local/output statement
  Num          numeric literal (original lexeme preserved for printing)
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from soda_tpu_torch.ir.types import Type

# Functions accepted by the frontend as intrinsic calls. The reference
# delegates this to haoda's FuncName rule; the corpus uses sqrt/min
# (tests/src/denoise2d.soda, erosion.soda).
FUNCS = (
    'min', 'max', 'abs', 'sqrt', 'rsqrt', 'exp', 'log', 'sin', 'cos', 'tan',
    'tanh', 'pow', 'floor', 'ceil', 'round', 'select',
)

# Reduction operators understood by to_reduction/from_reduction (the
# computation-reuse pass only handles these; reference
# computation_reuse.py:1792-1803).


class Node:
  """Base IR node with declarative attributes and rebuilding visitors."""

  SCALAR_ATTRS: Tuple[str, ...] = ()
  LINEAR_ATTRS: Tuple[str, ...] = ()

  def __init__(self, **kwargs):
    self.dtype: Optional[Type] = kwargs.pop('dtype', None)
    for attr in self.SCALAR_ATTRS:
      setattr(self, attr, kwargs.pop(attr, None))
    for attr in self.LINEAR_ATTRS:
      setattr(self, attr, tuple(kwargs.pop(attr, ())))
    if kwargs:
      raise TypeError('%s got unexpected attrs: %s' %
                      (type(self).__name__, sorted(kwargs)))

  @property
  def ATTRS(self) -> Tuple[str, ...]:
    return self.SCALAR_ATTRS + self.LINEAR_ATTRS

  # -- traversal -------------------------------------------------------------
  def visit(self, callback: Callable[['Node', Any], Any], args: Any = None):
    """Post-order rebuilding traversal.

    A shallow copy of this node is made with all child nodes visited
    recursively, then ``callback(copy, args)`` is applied; a non-None
    return replaces the node. The input node is never mutated (matches
    the contract documented at reference mutator.py:36-39).
    """
    copied = self._shallow_copy()
    for attr in self.SCALAR_ATTRS:
      val = getattr(copied, attr)
      if isinstance(val, Node):
        setattr(copied, attr, val.visit(callback, args))
    for attr in self.LINEAR_ATTRS:
      val = getattr(copied, attr)
      setattr(
          copied,
          attr,
          tuple(
              v.visit(callback, args) if isinstance(v, Node) else v
              for v in val))
    result = callback(copied, args)
    return copied if result is None else result

  def _shallow_copy(self) -> 'Node':
    new = type(self).__new__(type(self))
    new.dtype = self.dtype
    for attr in self.ATTRS:
      setattr(new, attr, getattr(self, attr))
    return new

  # -- structural identity (dtype excluded: it is derived info) --------------
  def _key(self):
    return (type(self).__name__,) + tuple(
        getattr(self, attr) for attr in self.ATTRS)

  def __eq__(self, other) -> bool:
    return isinstance(other, Node) and self._key() == other._key()

  def __hash__(self) -> int:
    return hash(self._key())

  def __repr__(self) -> str:
    return '%s(%s)' % (type(self).__name__, str(self))

  # -- printing ---------------------------------------------------------------
  PRECEDENCE = 100

  def _str_operand(self, operand: 'Node', need_parens: bool) -> str:
    s = str(operand)
    return '(%s)' % s if need_parens else s


def _make_chain(class_name: str, precedence: int,
                operators: Tuple[str, ...]):
  """Factory for binary-chain node classes (operand[0] op operand[1] ...)."""

  class Chain(Node):
    SCALAR_ATTRS = ()
    LINEAR_ATTRS = ('operand', 'operator')
    PRECEDENCE = precedence
    OPERATORS = operators

    def __str__(self):
      parts = []
      for opd in self.operand:
        # parenthesize any same-or-lower precedence child so that printing
        # and parsing are structurally bijective (nested chains of the same
        # class only arise from explicit parens or pass rewrites)
        need = opd.PRECEDENCE <= self.PRECEDENCE
        parts.append(self._str_operand(opd, need))
      out = [parts[0]]
      for op, part in zip(self.operator, parts[1:]):
        out.append(' %s %s' % (op, part))
      return ''.join(out)

  Chain.__name__ = class_name
  Chain.__qualname__ = class_name
  return Chain


Expr = _make_chain('Expr', 0, ('||',))
LogicAnd = _make_chain('LogicAnd', 1, ('&&',))
BinaryOr = _make_chain('BinaryOr', 2, ('|',))
Xor = _make_chain('Xor', 3, ('^',))
BinaryAnd = _make_chain('BinaryAnd', 4, ('&',))
EqCmp = _make_chain('EqCmp', 5, ('==', '!='))
LtCmp = _make_chain('LtCmp', 6, ('<=', '>=', '<', '>'))
AddSub = _make_chain('AddSub', 7, ('+', '-'))
MulDiv = _make_chain('MulDiv', 8, ('*', '/', '%'))

CHAIN_CLASSES = (Expr, LogicAnd, BinaryOr, Xor, BinaryAnd, EqCmp, LtCmp,
                 AddSub, MulDiv)
_CHAIN_BY_OP = {
    op: cls for cls in CHAIN_CLASSES for op in cls.OPERATORS
}


class Unary(Node):
  SCALAR_ATTRS = ('operand',)
  LINEAR_ATTRS = ('operator',)
  PRECEDENCE = 9

  def __str__(self):
    need = self.operand.PRECEDENCE < self.PRECEDENCE
    return ''.join(self.operator) + self._str_operand(self.operand, need)


class Cast(Node):
  SCALAR_ATTRS = ('expr',)
  PRECEDENCE = 10

  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    if self.dtype is None:
      raise ValueError('Cast requires a dtype')

  def _key(self):  # dtype is semantic for casts
    return ('Cast', self.dtype, self.expr)

  def __str__(self):
    from soda_tpu_torch.ir.arithmetic import unparenthesize
    return '%s(%s)' % (self.dtype, unparenthesize(self.expr))


class Call(Node):
  SCALAR_ATTRS = ('name',)
  LINEAR_ATTRS = ('operand',)
  PRECEDENCE = 10

  def __str__(self):
    from soda_tpu_torch.ir.arithmetic import unparenthesize
    return '%s(%s)' % (self.name, ', '.join(
        str(unparenthesize(a)) for a in self.operand))


class Ref(Node):
  """Stencil tensor access: name(idx...) with optional latency ``~lat``."""
  SCALAR_ATTRS = ('name', 'lat')
  LINEAR_ATTRS = ('idx',)
  PRECEDENCE = 10

  def __str__(self):
    result = '%s(%s)' % (self.name, ', '.join(map(str, self.idx)))
    if self.lat is not None:
      result += ' ~%s' % self.lat
    return result


class Var(Node):
  SCALAR_ATTRS = ('name',)
  LINEAR_ATTRS = ('idx',)  # constant indices for param element access
  PRECEDENCE = 10

  def __str__(self):
    return self.name + ''.join('[%d]' % i for i in self.idx)


class Let(Node):
  SCALAR_ATTRS = ('name', 'expr')
  PRECEDENCE = 10

  def _key(self):  # declared type is semantic for lets
    return ('Let', self.dtype, self.name, self.expr)

  def __str__(self):
    from soda_tpu_torch.ir.arithmetic import unparenthesize
    expr = unparenthesize(self.expr)
    if self.dtype is not None:
      return '%s %s = %s' % (self.dtype, self.name, expr)
    return '%s = %s' % (self.name, expr)


class Num(Node):
  """Numeric literal; keeps the original lexeme for faithful printing."""
  SCALAR_ATTRS = ('lexeme', 'value')
  PRECEDENCE = 10

  def _key(self):
    return ('Num', self.value, self.dtype)

  @property
  def is_float_literal(self) -> bool:
    return isinstance(self.value, float)

  def __str__(self):
    return self.lexeme


def make_num(value, dtype: Optional[Type] = None) -> Num:
  if isinstance(value, float):
    lexeme = repr(value)
    if dtype is not None and dtype.is_float and dtype.width_in_bits <= 32:
      lexeme += 'f'
  else:
    lexeme = str(value)
  return Num(lexeme=lexeme, value=value, dtype=dtype)


def make_var(name: str, dtype: Optional[Type] = None) -> Var:
  return Var(name=name, idx=(), dtype=dtype)


def make_chain(op: str, operands) -> Node:
  """Build a chain node applying ``op`` over ``operands`` (flattening 1)."""
  operands = tuple(operands)
  if len(operands) == 1:
    return operands[0]
  cls = _CHAIN_BY_OP[op]
  return cls(operand=operands, operator=(op,) * (len(operands) - 1))


# -- reduction helpers (used by computation reuse & rebalance) ----------------
def to_reduction(node: Node) -> Optional[Tuple[str, Tuple[Node, ...]]]:
  """View a node as (operator, operands) if it is a pure reduction.

  Supported reductions: an AddSub chain with all '+' operators, or a
  min/max Call. Mirrors haoda's ``to_reduction`` as used at reference
  computation_reuse.py:730.
  """
  if isinstance(node, AddSub) and all(op == '+' for op in node.operator):
    return ('+', node.operand)
  if isinstance(node, Call) and node.name in ('min', 'max'):
    return (node.name, node.operand)
  return None


def from_reduction(operator: str, operands: Tuple[Node, ...]) -> Node:
  """Inverse of ``to_reduction``."""
  operands = tuple(operands)
  if operator == '+':
    if len(operands) == 1:
      return operands[0]
    return AddSub(operand=operands, operator=('+',) * (len(operands) - 1))
  if operator in ('min', 'max'):
    if len(operands) == 1:
      return operands[0]
    return Call(name=operator, operand=operands)
  raise ValueError('unknown reduction operator: %s' % operator)
