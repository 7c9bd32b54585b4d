"""Arithmetic utilities over the expression IR.

Rebuild of the external ``haoda.ir.arithmetic`` interface used by the
reference (SURVEY.md §2.9 "Arithmetic"): ``simplify`` (reference
core.py:131), ``propagate_type`` (grammar.py:118,133),
``reverse_distribute`` (inline.py:163), ``print_tree``
(computation_reuse.py:359), ``unparenthesize`` (grammar.py:106).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from soda_tpu_torch.ir import nodes as ir
from soda_tpu_torch.ir.types import Type, common_type_of

_logger = logging.getLogger().getChild(__name__)

UINT1 = Type('uint1')

# operators whose chain is fully associative+commutative (safe to splice
# nested chains regardless of position)
_ASSOC_CHAINS = (ir.Expr, ir.LogicAnd, ir.BinaryOr, ir.Xor, ir.BinaryAnd)


def unparenthesize(node: ir.Node) -> ir.Node:
  """Strip redundant singleton chain wrappers (print helper)."""
  while isinstance(node, ir.CHAIN_CLASSES) and len(node.operand) == 1:
    node = node.operand[0]
  return node


def simplify(node):
  """Simplify IR: collapse singleton chains, flatten nested chains.

  Accepts a single node, None, or an iterable of nodes (same convenience
  contract as the reference's ``arithmetic.simplify`` usage at
  core.py:131-132 where both exprs and let-tuples are passed).
  """
  if node is None:
    return None
  if isinstance(node, (tuple, list)):
    return type(node)(simplify(n) for n in node)

  def callback(obj, _):
    # collapse singleton chains / empty unaries
    if isinstance(obj, ir.CHAIN_CLASSES) and len(obj.operand) == 1:
      return obj.operand[0]
    if isinstance(obj, ir.Unary):
      ops = [op for op in obj.operator if op != '+']
      # cancel double negation / double bitwise-not
      stack = []
      for op in ops:
        if stack and stack[-1] == op and op in ('-', '~'):
          stack.pop()
        else:
          stack.append(op)
      if not stack:
        return obj.operand
      if tuple(stack) != obj.operator:
        return ir.Unary(operator=tuple(stack), operand=obj.operand,
                        dtype=obj.dtype)
      return obj
    # flatten nested chains of the same class
    if isinstance(obj, ir.CHAIN_CLASSES):
      ops = ('+',) + obj.operator if isinstance(obj, ir.AddSub) else \
            ('*',) + obj.operator if isinstance(obj, ir.MulDiv) else \
            (None,) + obj.operator
      new_operands = []
      new_ops = []  # ops aligned with operands; first ignored on emit
      changed = False
      for op, opd in zip(ops, obj.operand):
        if type(opd) is type(obj):
          if isinstance(obj, _ASSOC_CHAINS):
            # these chain classes have ONE operator kind; the leading
            # position (op is None) takes it from either chain, never
            # a literal None (which would corrupt the operator tuple
            # when a nested chain sits in operand[0])
            fill = op if op is not None else \
                (obj.operator or opd.operator)[0]
            inner_ops = (fill,) * (len(opd.operator) + 1)
            new_operands.extend(opd.operand)
            new_ops.extend(inner_ops)
            changed = True
            continue
          if isinstance(obj, ir.AddSub):
            inner = ('+',) + opd.operator
            if op == '+':
              spliced = inner
            else:  # distributing '-' over the nested chain
              spliced = tuple('-' if o == '+' else '+' for o in inner)
            new_operands.extend(opd.operand)
            new_ops.extend(spliced)
            changed = True
            continue
          if isinstance(obj, ir.MulDiv) and op == '*' and \
              all(o == '*' for o in opd.operator):
            new_operands.extend(opd.operand)
            new_ops.extend(('*',) * (len(opd.operator) + 1))
            changed = True
            continue
        new_operands.append(opd)
        new_ops.append(op)
      if changed:
        return type(obj)(operand=tuple(new_operands),
                         operator=tuple(new_ops[1:]), dtype=obj.dtype)
    return obj

  return node.visit(callback)


def propagate_type(node, symbol_table: Dict[str, Type]):
  """Return a copy of ``node`` with ``dtype`` filled in bottom-up.

  ``symbol_table`` maps tensor/variable names to their types. Mirrors the
  role of ``haoda.ir.arithmetic.base.propagate_type`` (reference
  grammar.py:118-136).
  """
  if node is None:
    return None
  if isinstance(node, (tuple, list)):
    return type(node)(propagate_type(n, symbol_table) for n in node)

  def callback(obj, _):
    if isinstance(obj, ir.Ref):
      t = symbol_table.get(obj.name)
      if t is not None:
        obj.dtype = t
    elif isinstance(obj, ir.Var):
      t = symbol_table.get(obj.name)
      if t is not None:
        obj.dtype = t
    elif isinstance(obj, ir.Num):
      if obj.dtype is None and isinstance(obj.value, float):
        obj.dtype = Type('float' if obj.lexeme.endswith('f') else 'double')
    elif isinstance(obj, (ir.Expr, ir.LogicAnd, ir.EqCmp, ir.LtCmp)):
      obj.dtype = UINT1
    elif isinstance(obj, ir.CHAIN_CLASSES):
      obj.dtype = common_type_of(o.dtype for o in obj.operand)
    elif isinstance(obj, ir.Unary):
      obj.dtype = UINT1 if '!' in obj.operator else obj.operand.dtype
    elif isinstance(obj, ir.Call):
      if obj.name in ('min', 'max', 'select'):
        args = obj.operand[1:] if obj.name == 'select' else obj.operand
        obj.dtype = common_type_of(a.dtype for a in args)
      elif obj.name in ('abs', 'floor', 'ceil', 'round'):
        obj.dtype = obj.operand[0].dtype
      else:  # transcendental: floats pass through, ints promote to float
        t = obj.operand[0].dtype
        obj.dtype = t if (t is not None and t.is_float) else Type('float')
    elif isinstance(obj, ir.Let):
      # a Let's declared dtype stands; its expr was already propagated
      pass
    # Cast keeps its declared dtype
    return obj

  return node.visit(callback)


def reverse_distribute(node):
  """Rewrite ``a*c + b*c`` into ``(a + b) * c`` (common-factor grouping).

  Port of the behavior relied on by the reference's ``inline2`` pass
  (inline.py:163). Only all-'+' AddSub chains are transformed.
  """
  if node is None:
    return None
  if isinstance(node, (tuple, list)):
    return type(node)(reverse_distribute(n) for n in node)

  def callback(obj, _):
    if not (isinstance(obj, ir.AddSub) and
            all(op == '+' for op in obj.operator)):
      return obj
    # split each operand into (coefficient-free term, factor or None);
    # a numeric coefficient is the factor regardless of position
    # (c*x and x*c both group under c)
    groups = {}  # factor -> list of remaining terms
    order = []
    for opd in obj.operand:
      factor = None
      rest = opd
      if (isinstance(opd, ir.MulDiv) and len(opd.operand) == 2 and
          opd.operator == ('*',)):
        if isinstance(opd.operand[0], ir.Num) and \
            not isinstance(opd.operand[1], ir.Num):
          factor = opd.operand[0]
          rest = opd.operand[1]
        else:
          factor = opd.operand[1]
          rest = opd.operand[0]
      key = factor
      if key not in groups:
        groups[key] = []
        order.append(key)
      groups[key].append(rest)
    if all(len(v) == 1 for v in groups.values()):
      return obj
    new_operands = []
    for key in order:
      terms = groups[key]
      if key is None:
        new_operands.extend(terms)
      elif len(terms) == 1:
        new_operands.append(
            ir.MulDiv(operator=('*',), operand=(terms[0], key)))
      else:
        inner = ir.AddSub(operand=tuple(terms),
                          operator=('+',) * (len(terms) - 1))
        new_operands.append(ir.MulDiv(operator=('*',), operand=(inner, key)))
    if len(new_operands) == 1:
      return new_operands[0]
    return ir.AddSub(operand=tuple(new_operands),
                     operator=('+',) * (len(new_operands) - 1),
                     dtype=obj.dtype)

  return node.visit(callback)


def print_tree(node: ir.Node, printer=None, indent: int = 0) -> None:
  """Debug dump of an expression tree (haoda ``base.print_tree`` analog)."""
  out = printer or _logger.debug
  out('%s%s: %s', ' ' * indent, type(node).__name__, node)
  for attr in node.ATTRS:
    val = getattr(node, attr)
    if isinstance(val, ir.Node):
      print_tree(val, printer, indent + 2)
    elif isinstance(val, tuple):
      for v in val:
        if isinstance(v, ir.Node):
          print_tree(v, printer, indent + 2)
