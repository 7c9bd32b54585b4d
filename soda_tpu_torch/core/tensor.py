"""DAG node for stencil dependency analysis.

One Tensor per input / local / output statement (after
iterate-unrolling). Serves the same role as the reference's
src/soda/tensor.py Tensor, redesigned around what the TPU pipeline
actually consumes: the reuse-offset LP reads ``load_offsets``; the
fusion planner (backend/plan.py) reads ``ld_refs``/``st_idx``; the
executors evaluate ``lets``/``expr``. FPGA-era per-access FIFO tables
have no counterpart here.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

from soda_tpu_torch import utils
from soda_tpu_torch.ir import nodes as ir


class Tensor:
  """A value in the stencil DAG.

  Attributes:
    name: unique statement name.
    dtype: element Type.
    st_ref: the store Ref of the defining statement (None for inputs).
    lets / expr: the computation (empty / None for inputs).
    parents / children: name -> Tensor edges, wired by Stencil.tensors.
    ld_refs: parent name -> list of loaded Refs (sorted by serialized
      offset), wired by Stencil.tensors.
    produce_offset / consume_offset / max_access: results of the
      reuse-offset LP (Stencil._solve_reuse_offsets).
  """

  def __init__(self, stmt, tile_size):
    self._tile_size = tuple(tile_size)
    self.dtype = stmt.dtype
    ref = getattr(stmt, 'ref', None)
    if ref is not None:  # local / output statement
      self.st_ref = copy.copy(ref)
      self.name = ref.name
      self.st_idx: Tuple[int, ...] = tuple(ref.idx)
      self.lets: Tuple[ir.Let, ...] = tuple(stmt.let)
      self.expr: Optional[ir.Node] = stmt.expr
    else:  # input statement: no computation, origin store index
      self.st_ref = None
      self.name = stmt.name
      self.st_idx = (0,) * len(self._tile_size)
      self.lets = ()
      self.expr = None
    self.parents: Dict[str, 'Tensor'] = {}
    self.children: Dict[str, 'Tensor'] = {}
    self.ld_refs: Dict[str, List[ir.Ref]] = {}
    self.produce_offset = 0
    self.consume_offset = 0
    self.max_access = 0

  # -- serialized (column-major linear) offsets ---------------------------------
  @property
  def st_offset(self) -> int:
    """Store index as a column-major linear offset."""
    return utils.serialize(self.st_idx, self._tile_size)

  @property
  def ld_offsets(self) -> Dict[str, Dict[int, ir.Ref]]:
    """Per-parent map of serialized load offset -> Ref."""
    table: Dict[str, Dict[int, ir.Ref]] = {}
    for parent, refs in self.ld_refs.items():
      table[parent] = {
          utils.serialize(r.idx, self._tile_size): r for r in refs
      }
    return table

  # -- IR traversal --------------------------------------------------------------
  def mutate(self, callback, args=None) -> None:
    """Rewrite lets, expr and the store ref with an IR visitor."""
    self.lets = tuple(let.visit(callback, args) for let in self.lets)
    if self.expr is not None:
      self.expr = self.expr.visit(callback, args)
    if self.st_ref is not None:
      self.st_ref = self.st_ref.visit(callback, args)
      # the callback may have renamed or re-indexed the store
      self.name = self.st_ref.name
      self.st_idx = tuple(self.st_ref.idx)

  def visit_loads(self, callback, args=None) -> None:
    """Read-only visit over the computation side (lets + expr)."""
    for let in self.lets:
      let.visit(callback, args)
    if self.expr is not None:
      self.expr.visit(callback, args)

  def propagate_type(self) -> None:
    """Fill let-variable dtypes into their uses."""
    if self.expr is None:
      return
    let_types = {let.name: let.dtype for let in self.lets}

    def fill(node, _):
      if isinstance(node, ir.Var) and node.dtype is None:
        node.dtype = let_types.get(node.name)
      return node

    self.mutate(fill)

  # -- DAG classification ---------------------------------------------------------
  def is_input(self) -> bool:
    # input statements have no store ref; a parent-based test would
    # misclassify constant / param-only stages as inputs
    return self.st_ref is None

  def is_output(self) -> bool:
    return not self.children

  def is_producer(self) -> bool:
    """Feeds at least one other tensor."""
    return bool(self.children)

  def is_consumer(self) -> bool:
    """Reads at least one other tensor."""
    return bool(self.parents)

  def __repr__(self) -> str:
    return 'Tensor(%s: %s <- [%s])' % (
        self.name, self.dtype, ', '.join(self.parents))
