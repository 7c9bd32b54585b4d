"""Fusion planning: the TPU-native analog of the reference's dataflow layer.

The reference lowers a Stencil into an explicit FIFO module graph
(reference src/soda/dataflow.py) because its target is a spatial
dataflow architecture. On TPU, all of that machinery collapses into a
*fusion plan*: a chronological stage schedule (one stage per non-input
tensor), per-stage load-offset/margin tables that drive shifted reads,
and a grouping of stages into kernels controlled by the ``cluster``
granularity knob (reference cluster.py:51-202 — here a backend fusion
decision rather than an IR rewrite):

  - ``none`` / ``full``: every stage fused into ONE kernel (values flow
    through registers/VMEM where the reference used FIFOs).
  - ``coarse``: one kernel per stage (debugging / VMEM pressure).
  - ``fine``: accepted and treated as ``coarse``. The reference's fine
    granularity splits each stage per unroll PE id (cluster.py:84-94);
    on TPU there is no schedulable unit below one kernel — the VPU's
    8x128 lanes already are the "PEs" — so no lane-group split exists.

Array-axis convention (used by every executor in this package): public
arrays are indexed in REVERSED DSL-dimension order — DSL dimension 0
(the contiguous, stride-1 dimension of the reference's column-major
serialization, soda/util.py:9) is the minor-most array axis, and the
streaming dimension (`*`) is axis 0. This maps the streaming dimension
onto TPU sublane blocks and dimension 0 onto the 128-wide lane axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from soda_tpu_torch import utils
from soda_tpu_torch.core import stencil as core
from soda_tpu_torch.core.tensor import Tensor


def window_margins(stencil, tensor: Tensor
                   ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
  """Margins from the overall stencil window (reference CPU-check loop
  bounds, frt/host.py:566-577). Correct for stencils whose stages all
  normalize their loads, but NOT in general — see materialized_margins."""
  dim = len(stencil.tile_size)
  if tensor.is_input():
    return (0,) * dim, (0,) * dim
  if tensor.is_output():
    sources = tuple(map(stencil.tensors.get, stencil.input_names))
  else:
    sources = tuple(tensor.parents.values())
  return core.window_margins(core.overall_window(tensor, sources))


def materialized_margins(stencil) -> Dict[str, Tuple[Tuple[int, ...],
                                                     Tuple[int, ...]]]:
  """Per-tensor (lo, hi) valid-region margins under grid execution.

  Propagated compositionally through the stage DAG: a cell of tensor T
  is valid iff every load it performs hits a *valid, in-array* cell of
  its parent. This is the true guarantee every executor in this package
  provides (the reference's window-based loop bounds coincide for the
  hand-written corpus, but under computation reuse an intermediate's
  store offset can make the window bound under-estimate the margin —
  its generated host would silently read out of range there).
  """
  cached = getattr(stencil, '_materialized_margins', None)
  if cached is not None:
    return cached
  dim = len(stencil.tile_size)
  zeros = (0,) * dim
  margins: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
      name: (zeros, zeros) for name in stencil.input_names
  }
  for tensor in stencil.chronological_tensors:
    if tensor.is_input():
      continue
    st_idx = tensor.st_idx
    lo = [0] * dim
    hi = [0] * dim
    for parent_name, refs in tensor.ld_refs.items():
      if parent_name in stencil.param_names:
        continue
      p_lo, p_hi = margins[parent_name]
      for ref in refs:
        for d in range(dim):
          delta = ref.idx[d] - st_idx[d]
          lo[d] = max(lo[d], p_lo[d] - delta)
          hi[d] = max(hi[d], p_hi[d] + delta)
    margins[tensor.name] = (tuple(lo), tuple(hi))
  # memoized: the tensor DAG is immutable once built, and the oracle /
  # valid-region helpers query per stage (O(stages^2) otherwise)
  stencil._materialized_margins = margins
  return margins


def stage_margins(stencil, tensor: Tensor
                  ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
  """Valid-region margins of one tensor (see materialized_margins)."""
  return materialized_margins(stencil)[tensor.name]


def validate_grid(stencil, shape: Sequence[int]) -> None:
  """Reject grids too small for the cumulative stencil window.

  Executors otherwise fail deep inside with shape errors (or worse,
  an all-margin output) when some stage's valid region is empty along
  an axis. The reference's generated host rejects undersized tiles up
  front (its tile size is a compile-time constant >= the window);
  here the grid arrives at run time, so check every materialized
  stage. Raises utils.InputError naming the first offending tensor.
  """
  dim = len(stencil.tile_size)
  if len(shape) != dim:
    raise utils.InputError(
        'expected %d-D grid, got %d-D' % (dim, len(shape)))
  for name, (lo, hi) in materialized_margins(stencil).items():
    for d in range(dim):
      # shape is in array-axis (reversed-DSL) order
      extent = shape[dim - 1 - d]
      if lo[d] + hi[d] >= extent:
        raise utils.InputError(
            'grid dimension %d (extent %d) is too small for the '
            'cumulative stencil window of tensor %s '
            '(needs > %d cells)' % (d, extent, name, lo[d] + hi[d]))


@dataclasses.dataclass
class Stage:
  """One producible tensor with its load-offset table."""
  tensor: Tensor
  lo: Tuple[int, ...]  # DSL-dim order
  hi: Tuple[int, ...]
  # parent name -> tuple of load offsets relative to the store index
  # (DSL-dim order); these are the shifts each read applies.
  load_offsets: Dict[str, Tuple[Tuple[int, ...], ...]] = \
      dataclasses.field(default_factory=dict)

  @property
  def name(self) -> str:
    return self.tensor.name

  @property
  def dtype(self):
    return self.tensor.dtype

  def rel_offset(self, ref_idx: Sequence[int]) -> Tuple[int, ...]:
    st = self.tensor.st_idx
    return tuple(i - s for i, s in zip(ref_idx, st))


@dataclasses.dataclass
class FusionPlan:
  """Stage schedule + kernel grouping for one stencil."""
  stencil: object
  stages: List[Stage]
  groups: List[List[Stage]]  # kernels, in execution order
  halo_lo: Tuple[int, ...]  # overall input halo (DSL-dim order)
  halo_hi: Tuple[int, ...]

  @property
  def dim(self) -> int:
    return len(self.halo_lo)

  def stage(self, name: str) -> Stage:
    for s in self.stages:
      if s.name == name:
        return s
    raise KeyError(name)

  # -- resource estimation (the analog of FIFO-depth accounting) --------------
  def vmem_bytes(self, block_shape: Sequence[int]) -> int:
    """Estimated VMEM bytes for one fused-kernel block of
    ``block_shape`` (array-axis order), counting each stage's slab plus
    its halo margins. The analog of the reference's FIFO-depth ILP
    objective sum(width x depth) (dataflow.py:132-166)."""
    total = 0
    shape_dsl = tuple(reversed(tuple(block_shape)))
    for stage in self.stages:
      cells = 1
      for d in range(len(shape_dsl)):
        cells *= shape_dsl[d] + stage.lo[d] + stage.hi[d]
      total += cells * stage.dtype.width_in_bytes
    for name in self.stencil.input_names:
      cells = 1
      for d, extent in enumerate(shape_dsl):
        cells *= extent + self.halo_lo[d] + self.halo_hi[d]
      total += cells * self.stencil.symbol_table[name].width_in_bytes
    return total

  def dot(self) -> str:
    """Graphviz dump of the stage DAG (observability parity with the
    reference's SuperSourceNode graphviz hook, dataflow.py:36-41)."""
    lines = ['digraph stages {']
    for name in self.stencil.input_names:
      lines.append('  "%s" [shape=box];' % name)
    for group_id, group in enumerate(self.groups):
      for stage in group:
        lines.append('  "%s" [label="%s\\n%s kernel %d"];' %
                     (stage.name, stage.name, stage.dtype, group_id))
        for parent in stage.tensor.parents:
          lines.append('  "%s" -> "%s";' % (parent, stage.name))
    lines.append('}')
    return '\n'.join(lines)


def _peak_live(stages: Sequence[Stage], outputs, consumers) -> int:
  """Peak count of simultaneously-live stage values under an order.

  A stage's value is live from its execution until its last consumer
  executes (outputs stay live to the final store). This is the cost the
  value-mode kernel pays in Mosaic-managed VMEM, and the vmem-mode
  kernel pays in scratch slots (scratch_slots reuses dead slabs).
  """
  remaining = {n: set(c) for n, c in consumers.items()}
  live = set()
  peak = 0
  for s in stages:
    live.add(s.name)
    for p in set(s.tensor.ld_refs):
      if p in remaining:
        remaining[p].discard(s.name)
        if not remaining[p] and p not in outputs:
          live.discard(p)
    peak = max(peak, len(live))
  return peak


def _liveness_order(stages: List[Stage], output_names) -> List[Stage]:
  """Topological stage order minimizing peak value liveness.

  The register-sufficiency analog of the reference's FIFO-depth ILP
  (dataflow.py:94-176): CR-heavy pipelines (contrast: 115 reuse
  variables) spill under the chronological order because every leaf is
  computed before any combine. A Sethi-Ullman-style DFS post-order from
  the outputs — visiting the register-hungriest subtree first —
  completes each subtree before starting a sibling. Returns whichever
  of {chronological, DFS} simulates fewer simultaneously-live values
  (so simple pipelines keep their familiar order).
  """
  by_name = {s.name: s for s in stages}
  outputs = set(output_names)
  consumers: Dict[str, set] = {n: set() for n in by_name}
  for s in stages:
    for p in s.tensor.ld_refs:
      if p in consumers:
        consumers[p].add(s.name)

  su: Dict[str, int] = {}  # Sethi-Ullman register estimate per subtree

  def su_of(name: str) -> int:
    stack = [name]
    while stack:
      n = stack[-1]
      if n in su:
        stack.pop()
        continue
      parents = [p for p in set(by_name[n].tensor.ld_refs) if p in by_name]
      pending = [p for p in parents if p not in su]
      if pending:
        stack.extend(pending)
        continue
      stack.pop()
      if not parents:
        su[n] = 1
      else:
        nums = sorted((su[p] for p in parents), reverse=True)
        su[n] = max(x + i for i, x in enumerate(nums))
    return su[name]

  emitted = set()
  order: List[Stage] = []

  def emit(name: str) -> None:
    stack = [name]
    while stack:
      n = stack[-1]
      if n in emitted:
        stack.pop()
        continue
      pending = [p for p in set(by_name[n].tensor.ld_refs)
                 if p in by_name and p not in emitted]
      if pending:
        # hungriest subtree first (classic Sethi-Ullman order)
        stack.extend(sorted(pending, key=su_of))
        continue
      stack.pop()
      emitted.add(n)
      order.append(by_name[n])

  for out in output_names:
    if out in by_name:
      emit(out)
  for s in stages:  # dead stages (no path to an output) keep their spot
    if s.name not in emitted:
      emit(s.name)
  if _peak_live(order, outputs, consumers) < \
      _peak_live(stages, outputs, consumers):
    return order
  return stages


def make_plan(stencil, cluster: Optional[str] = None) -> FusionPlan:
  """Build the fusion plan for ``stencil``.

  ``cluster`` overrides the stencil's cluster directive; ``none`` and
  ``full`` both mean one fused kernel (on TPU fusion is the default —
  the reference's ``none`` kept modules separate because FIFOs were
  free on an FPGA; on TPU separate kernels round-trip HBM).
  """
  cluster = cluster or stencil.cluster or 'none'
  from soda_tpu_torch.optimization import ranges
  ranges.annotate(stencil)  # enables exact f32 int-division lowering
  margins = materialized_margins(stencil)
  stages: List[Stage] = []
  for tensor in stencil.chronological_tensors:
    if tensor.is_input():
      continue
    lo, hi = margins[tensor.name]
    stage = Stage(tensor=tensor, lo=lo, hi=hi)
    for parent_name, refs in tensor.ld_refs.items():
      stage.load_offsets[parent_name] = tuple(
          stage.rel_offset(ref.idx) for ref in refs)
    stages.append(stage)
  stages = _liveness_order(stages, stencil.output_names)

  if cluster in ('none', 'full'):
    groups = [list(stages)]
  elif cluster in ('coarse', 'fine'):
    groups = [[s] for s in stages]
  else:
    raise ValueError('unknown cluster granularity: %s' % cluster)

  halo_lo, halo_hi = margins[stencil.output_names[0]]
  for name in stencil.output_names[1:]:
    lo2, hi2 = margins[name]
    halo_lo = tuple(map(max, halo_lo, lo2))
    halo_hi = tuple(map(max, halo_hi, hi2))
  return FusionPlan(stencil=stencil, stages=stages, groups=groups,
                    halo_lo=halo_lo, halo_hi=halo_hi)
