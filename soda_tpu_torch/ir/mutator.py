"""Index-space rewrites over the expression IR.

Three rewrites every stencil pass needs (same capabilities as the
reference's src/soda/mutator.py, restructured around a single
map-over-refs primitive):

  * ``shift``      — move every tensor access by a constant offset;
  * ``normalize``  — shift so the least access index (in column-major
                     order) lands on the origin;
  * ``replace_expressions`` — CSE substitution keyed on normalized
                     subexpressions.
"""

from __future__ import annotations

import collections.abc
import operator
import types
from typing import Mapping, MutableMapping, Optional, Sequence, Tuple

from soda_tpu_torch.ir import nodes as ir
from soda_tpu_torch.ir import visitor


def _map_refs(obj, fn):
  """Apply ``fn(ref)`` to every ir.Ref in ``obj``.

  ``obj`` may be an ir.Node (a rewritten copy is returned) or any
  object exposing ``mutate`` (a Tensor; mutated in place and returned).
  """

  def callback(node, _):
    if isinstance(node, ir.Ref):
      fn(node)
    return node

  if isinstance(obj, ir.Node):
    return obj.visit(callback)
  mutate = getattr(obj, 'mutate', None)
  if mutate is None:
    raise TypeError('cannot rewrite refs of %r' % type(obj))
  mutate(callback)
  return obj


def substitute_vars(obj: ir.Node, env: Mapping[str, ir.Node]) -> ir.Node:
  """Replace scalar ``Var`` reads by the expressions bound to them.

  Only names present in ``env`` are touched (stencil params stay Var
  reads); indexed Vars (param element access, ``p[0]``) are never
  substituted. Returns a rewritten copy; ``obj`` is not mutated.
  """
  if not env:
    return obj

  def callback(node, _):
    if isinstance(node, ir.Var) and not node.idx:
      return env.get(node.name, node)
    return node

  return obj.visit(callback)


def shift(obj, offset: Sequence[int], excluded=(), op=operator.sub):
  """Offset every Ref index (except ``excluded`` names) pointwise.

  The default ``op`` subtracts, i.e. ``shift(x, k)`` moves an access
  ``t(i)`` to ``t(i - k)``; pass ``operator.add`` to move forward.
  """
  # fold the operator into a signed delta so the hot path is one add
  if op is operator.sub:
    delta = tuple(-x for x in offset)
  elif op is operator.add:
    delta = tuple(offset)
  else:
    raise ValueError('shift expects operator.add or operator.sub')
  skip = frozenset(excluded)

  def move(ref: ir.Ref) -> None:
    if ref.name not in skip:
      ref.idx = tuple(i + d for i, d in zip(ref.idx, delta))

  return _map_refs(obj, move)


def normalize(obj, references: Optional[Mapping[str, Tuple[int, ...]]] = None):
  """Shift ``obj`` so its least access index becomes the origin.

  Accepts a single ir.Node or an iterable of them (normalized jointly:
  one common shift for the whole group).
  """
  if isinstance(obj, types.GeneratorType):
    obj = tuple(obj)
  origin = visitor.get_normalize_index(obj, references)
  if not any(origin):
    return obj
  if isinstance(obj, ir.Node):
    return shift(obj, origin)
  if isinstance(obj, collections.abc.Iterable):
    return type(obj)(shift(node, origin) for node in obj)
  raise TypeError('normalize expects an ir.Node or an iterable of them')


def replace_expressions(
    obj: ir.Node,
    cses: MutableMapping[ir.Node, ir.Ref],
    used: Optional[MutableMapping[ir.Node, ir.Node]] = None,
    references: Optional[Mapping[str, Tuple[int, ...]]] = None,
) -> ir.Node:
  """Substitute common subexpressions bottom-up, normalization-aware.

  ``cses`` maps *normalized* subexpressions to the Refs that will hold
  their value. Any sub-node of ``obj`` whose normalized form matches a
  key is replaced by that key's Ref, shifted back to the sub-node's own
  position. When ``used`` is given, each hit is recorded there with its
  own definition rewritten against the remaining substitutions (so
  chained CSEs reference each other, not the original expression).
  """

  def substitute(node):
    origin = visitor.get_normalize_index(node, references)
    canon = shift(node, origin) if any(origin) else node
    hit = cses.get(canon)
    if hit is None:
      return node
    if used is not None and canon not in used:
      rest = dict(cses)
      del rest[canon]
      used[canon] = replace_expressions(canon, rest, used, references)
    return shift(hit, origin, op=operator.add)

  return obj.visit(lambda node, _: substitute(node))
