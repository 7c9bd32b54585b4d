"""Shared utilities (errors, toposort, index serialization).

Covers the slices of ``haoda.util`` and ``soda.util`` the rebuild needs
(SURVEY.md §2.4, §2.9 "Util").
"""

from __future__ import annotations

import functools
import operator
from typing import Dict, Iterable, List, Sequence, Set, Tuple, TypeVar

COORDS_TILED = 'xyzw'
COORDS_IN_TILE = 'ijkl'
COORDS_IN_ORIG = 'pqrs'
MAX_DRAM_BANK = 4


class SemanticError(Exception):
  """User-visible error in the stencil program."""


class SemanticWarn(Exception):
  pass


class InternalError(Exception):
  """Invariant violation inside the compiler."""


class InputError(Exception):
  """Invalid input configuration."""


def serialize(vec: Sequence[int], tile_size: Sequence[int]) -> int:
  """N-D index -> column-major linear offset (reference soda/util.py:9).

  Dimension 0 has stride 1; the last tile_size entry (the streaming
  dimension sentinel) is never used as a stride bound.
  """
  return sum((vec[i] * functools.reduce(operator.mul, tile_size[:i])
              for i in range(1, len(tile_size))), vec[0])


def serialize_iter(iterable, tile_size) -> List[int]:
  return [serialize(x, tile_size) for x in iterable]


def deserialize(offset: int, tile_size: Sequence[int]) -> Tuple[int, ...]:
  """Inverse of serialize (reference soda/util.py:17)."""

  def gen(offset):
    for size in tile_size[:-1]:
      yield offset % size
      offset = offset // size
    yield offset

  return tuple(gen(offset))


_T = TypeVar('_T')


def toposort_flatten(graph: Dict[_T, Set[_T]], sort: bool = True) -> List[_T]:
  """Topological sort of {node: set(dependencies)} -> dependency-first list.

  Drop-in for the external ``toposort.toposort_flatten`` the reference
  depends on (core.py:468). Deterministic: ties broken by sorted order
  when ``sort`` else insertion order.
  """
  graph = {k: set(v) for k, v in graph.items()}
  # make sure every referenced node exists
  extra = {dep for deps in graph.values() for dep in deps} - set(graph)
  order_hint = {k: i for i, k in enumerate(list(graph) + sorted(
      extra, key=repr))}
  for dep in extra:
    graph[dep] = set()
  result: List[_T] = []
  emitted: Set[_T] = set()
  while graph:
    ready = [k for k, deps in graph.items() if deps <= emitted]
    if not ready:
      raise ValueError('cyclic dependency detected among: %s' %
                       sorted(map(repr, graph)))
    if sort:
      try:
        ready.sort()
      except TypeError:
        ready.sort(key=order_hint.get)
    else:
      ready.sort(key=order_hint.get)
    for k in ready:
      result.append(k)
      emitted.add(k)
      del graph[k]
  return result


def idx2str(idx) -> str:
  return '(%s)' % ', '.join(map(str, idx))


def lst2str(lst) -> str:
  return '[%s]' % ', '.join(map(str, lst))


# -- correctness thresholds (reference frt/host.py:633-657 squared form) -------
# default relaxed to 1e-4 for XLA/Mosaic FMA contraction vs the
# individually-rounded oracle; contrast's +-100-coefficient cancelling
# sums legitimately differ by one FMA-contracted ulp of a ~5e3-magnitude
# running sum (see tests/checks.py for the full rationale)
DEFAULT_THRESHOLD = 1e-4
KERNEL_THRESHOLDS = {'contrast': 1e-3}


def threshold_for(app_name: str) -> float:
  """Per-kernel float comparison threshold (squared-form criterion)."""
  for key, value in KERNEL_THRESHOLDS.items():
    if app_name.startswith(key):
      return value
  return DEFAULT_THRESHOLD

