"""Read-only visitors over the expression IR.

Equivalent of the reference's src/soda/visitor.py (get_load_* collectors,
get_normalize_index) plus haoda's ``get_vars``/``get_instances_of``
(SURVEY.md §2.9 "Visitors"), generalized to anything exposing ``visit``.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from soda_tpu_torch.ir import nodes as ir


def _visit_all(obj, visitor, args):
  """Dispatch over a Node, or anything with ``visit_loads`` (a Tensor)."""
  if isinstance(obj, ir.Node):
    obj.visit(visitor, args)
  elif hasattr(obj, 'visit_loads'):
    obj.visit_loads(visitor, args)
  else:
    raise TypeError('argument is not an IR node or a tensor: %r' % (obj,))


def get_load_tuple(obj) -> Tuple[ir.Ref, ...]:
  """All Ref loads, in traversal order (reference visitor.py:16)."""
  loads: List[ir.Ref] = []

  def visitor(node, loads):
    if isinstance(node, ir.Ref):
      loads.append(node)
    return node

  _visit_all(obj, visitor, loads)
  return tuple(loads)


def get_load_set(obj) -> Tuple[ir.Ref, ...]:
  """All unique Ref loads (reference visitor.py:41)."""
  loads: Dict[ir.Ref, None] = collections.OrderedDict()

  def visitor(node, loads):
    if isinstance(node, ir.Ref):
      loads[node] = None
    return node

  _visit_all(obj, visitor, loads)
  return tuple(loads)


def get_load_dict(obj) -> Dict[str, List[ir.Ref]]:
  """Ref loads grouped by tensor name (reference visitor.py:66)."""
  loads: Dict[str, List[ir.Ref]] = collections.OrderedDict()

  def visitor(node, loads):
    if isinstance(node, ir.Ref):
      loads.setdefault(node.name, []).append(node)
    return node

  _visit_all(obj, visitor, loads)
  return loads


def get_vars(obj) -> Tuple[ir.Var, ...]:
  """All Var accesses (haoda ``ir.visitor.get_vars`` analog)."""
  out: List[ir.Var] = []

  def visitor(node, out):
    if isinstance(node, ir.Var):
      out.append(node)
    return node

  _visit_all(obj, visitor, out)
  return tuple(out)


def get_instances_of(obj, cls) -> Tuple[ir.Node, ...]:
  """All sub-nodes of a class (haoda ``get_instances_of``,
  used at reference hls_kernel.py:677)."""
  out: List[ir.Node] = []

  def visitor(node, out):
    if isinstance(node, cls):
      out.append(node)
    return node

  _visit_all(obj, visitor, out)
  return tuple(out)


def get_normalize_index(
    obj,
    references: Optional[Mapping[str, Tuple[int, ...]]] = None
) -> Tuple[int, ...]:
  """Index making the least access 0 under reversed-tuple (column-major)
  order — the same normalization rule as reference visitor.py:92-122."""
  if isinstance(obj, ir.Node) or hasattr(obj, 'visit_loads'):
    objs: Iterable = (obj,)
  elif isinstance(obj, collections.abc.Iterable):
    objs = obj
  else:
    raise TypeError('argument is not an ir.Node or an iterable of ir.Nodes')

  def get_idx(load: ir.Ref) -> Tuple[int, ...]:
    if references is None:
      return load.idx
    ref = references.get(load.name)
    if ref is None:
      return load.idx
    return tuple(x - y for x, y in zip(load.idx, ref))

  loads = sum(map(get_load_tuple, objs), ())
  if not loads:
    return ()
  return get_idx(min(loads, key=lambda l: tuple(reversed(get_idx(l)))))
