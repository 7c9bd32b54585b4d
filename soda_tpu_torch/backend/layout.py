"""The JAX kernel's layout keys, resolved for the fused CUDA kernel.

The TPU kernel (soda_tpu/backend/pallas_kernel.py ``PallasExecutor``)
has six keys that choose how stage values and shifted reads map onto
the VPU's registers: ``stage_mode`` (values or VMEM slabs),
``shift_mode`` (windowed slices or rolls of full-extent values),
``lane_shift`` (the minor axis rotated in registers or sliced across
lanes), ``transpose_lanes`` (chains of minor-axis-only stages evaluated
in transposed layout), ``narrow`` (16-bit stages at native width) and
``compute_chunk`` (stage slabs evaluated in axis-0 chunks). On the H100
they choose between the same two places, shared memory and registers,
and the fused kernel has a form for each (backend/cuda_source.py):

- ``stage_mode='vmem'`` without ``compute_chunk`` is the default kernel
  (every stage in shared memory, one barrier per stage): the plan is
  the default plan.
- ``stage_mode='value'`` (L1): each warp evaluates every stage of a
  window of the tile in registers, axis-0 taps as register indices, the
  minor axis as lane rotates (``__shfl_sync``) or, under
  ``lane_shift='slice'``, reads through a per-warp shared-memory row;
  ``shift_mode='roll'`` evaluates each stage at the window's full
  extent with wrap-around.
- ``transpose_lanes`` (L2, 2-D value mode): the stages of a transposed
  lane region hold their values transposed, so their minor-axis taps
  are register indices; entries and exits pass through a padded
  shared-memory transpose.
- ``narrow='on'`` (L3, value mode): the stages ``ranges.narrow16_stages``
  admits run on two cells per 32-bit register.
- ``compute_chunk`` (L4, 3-D, implies vmem): the default kernel whose
  stage loops walk the tile in axis-0 chunks.

``layout_config`` checks the keys with the JAX constructor's rules and
exception types (pallas_kernel.py:321-343, :382-456, :662-663) and
resolves the ``'auto'`` values by its rules. When a caller passes no
layout key, no ``LayoutConfig`` exists and the kernel is the default
one; when it passes any, the others take the JAX defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional

from soda_tpu_torch import utils
from soda_tpu_torch.ir import nodes as ir

# the JAX kernel's layout keys (pallas_kernel.py:287-305), and the one
# that has no counterpart: Pallas's interpret mode
LAYOUT_KEYS = ('stage_mode', 'shift_mode', 'lane_shift', 'transpose_lanes',
               'narrow', 'compute_chunk')
REJECTED_KEYS = ('interpret',)


@dataclasses.dataclass(frozen=True)
class LayoutConfig:
  """Resolved layout keys of one fused kernel (see layout_config).

  Attributes:
    stage_mode: 'value' or 'vmem'.
    shift_mode: 'window' or 'roll' (roll needs value).
    lane_shift: 'rotate' or 'slice' (what 'auto' resolved to).
    transposed: stages evaluated in transposed lane layout (L2).
    narrow16: stages evaluated as packed 16-bit pairs (L3).
    compute_chunk: axis-0 planes per chunk of a stage loop (L4), or
      None.
  """
  stage_mode: str
  shift_mode: str = 'window'
  lane_shift: str = 'slice'
  transposed: FrozenSet[str] = frozenset()
  narrow16: FrozenSet[str] = frozenset()
  compute_chunk: Optional[int] = None

  @property
  def value(self) -> bool:
    return self.stage_mode == 'value'

  @property
  def roll(self) -> bool:
    return self.shift_mode == 'roll'

  @property
  def rotate(self) -> bool:
    """Minor-axis taps are lane rotates (roll mode rotates lanes too,
    pallas_kernel.py:667)."""
    return self.lane_shift == 'rotate' or self.roll

  @property
  def form(self) -> str:
    """L1-L4: the kernel form the config selects (the most specific)."""
    if self.compute_chunk is not None:
      return 'L4'
    if self.narrow16:
      return 'L3'
    if self.transposed:
      return 'L2'
    return 'L1'

  @property
  def name(self) -> str:
    """A short name, e.g. ``L2 value/roll/rotate+transpose``."""
    if self.compute_chunk is not None:
      return 'L4 vmem+chunk%d' % self.compute_chunk
    parts = '%s value/%s/%s' % (self.form, self.shift_mode,
                                'rotate' if self.rotate else 'slice')
    if self.transposed:
      parts += '+transpose'
    if self.narrow16:
      parts += '+narrow'
    return parts


def _chain_width_mode(stages) -> str:
  """The JAX kernel's 'auto' stage mode (pallas_kernel.py:406-439):
  value, unless a stage folds more than 12 operands in one chain, or
  more than 4 stages fold more than 8."""
  wide_stages = 0
  for stage in stages:
    widest = [0]

    def chain_width(node, _):
      if isinstance(node, ir.CHAIN_CLASSES):
        widest[0] = max(widest[0], len(node.operand))
      return node

    stage.tensor.expr.visit(chain_width)
    for let in stage.tensor.lets:
      let.expr.visit(chain_width)
    if widest[0] > 12:
      return 'vmem'
    if widest[0] > 8:
      wide_stages += 1
  return 'vmem' if wide_stages > 4 else 'value'


def transposed_lane_regions(plan, stencil, transpose_lanes: str) -> set:
  """Stage names that evaluate in transposed (lane-major) layout:
  maximal producer-consumer chains whose loads shift only along the
  minor (lane) axis, admitted when the chain's lane shifts outweigh its
  crossings (3 * shifts > 2.5 * crossings + 4); 'auto' also caps the
  crossings at two. A copy of soda_tpu/backend/pallas_kernel.py:221-284,
  which lives in a module that imports jax."""
  dim = plan.dim
  lane_only = {}
  for stg in plan.stages:
    ok = True
    for parent, offs in stg.load_offsets.items():
      if parent in stencil.param_names:
        continue
      for off in offs:
        if any(off[d] for d in range(1, dim)):
          ok = False
    lane_only[stg.name] = ok
  consumers = {stg.name: set() for stg in plan.stages}
  for stg in plan.stages:
    for parent in stg.tensor.ld_refs:
      if parent in consumers:
        consumers[parent].add(stg.name)
  # connected components over lane-only stages (edges: producer ->
  # consumer where both are lane-only)
  comp: Dict[str, set] = {}
  for stg in plan.stages:
    if not lane_only[stg.name]:
      continue
    comp.setdefault(stg.name, {stg.name})
    for parent in stg.tensor.ld_refs:
      if lane_only.get(parent):
        merged = comp[parent] | comp[stg.name]
        for n in merged:
          comp[n] = merged
  outputs_set = set(stencil.output_names)
  transposed = set()
  for members in {id(c): c for c in comp.values()}.values():
    lane_shifts = 0
    entries = set()
    exits = 0
    for stg in plan.stages:
      if stg.name not in members:
        continue
      for parent, offs in stg.load_offsets.items():
        if parent in stencil.param_names:
          continue
        if parent not in members:
          entries.add(parent)
        lane_shifts += len({off[0] for off in offs if off[0]})
      if (stg.name in outputs_set or
          any(c not in members for c in consumers[stg.name])):
        exits += 1
    crossings = len(entries) + exits
    if 3 * lane_shifts <= 2.5 * crossings + 4:
      continue
    if transpose_lanes == 'on' or crossings <= 2:
      transposed |= members
  return transposed


def layout_config(plan, shape, stage_mode: str = 'auto',
                  shift_mode: str = 'window', lane_shift: str = 'auto',
                  transpose_lanes: str = 'auto', narrow: str = 'auto',
                  compute_chunk: Optional[int] = None,
                  mid_tile: Optional[int] = None
                  ) -> Optional[LayoutConfig]:
  """Check and resolve the layout keys as the JAX constructor does, for
  ``plan``, the stencil's one-kernel fusion plan (``make_plan(stencil,
  'full')``).

  Raises ValueError for a value outside a key's choices and
  utils.InputError for a combination the kernel does not take, with the
  JAX package's messages. Returns None for the default kernel (vmem
  without chunks: today's shared-memory kernel is the vmem form).
  ``mid_tile`` is only checked (mid tiling needs value mode or chunks,
  pallas_kernel.py:518-519).
  """
  stencil = plan.stencil
  shape = tuple(shape)
  dim = len(shape)
  if transpose_lanes not in ('auto', 'on', 'off'):
    raise ValueError('transpose_lanes must be auto|on|off')
  if narrow not in ('auto', 'on', 'off'):
    raise ValueError('narrow must be auto|on|off')
  if shift_mode not in ('window', 'roll'):
    raise ValueError('shift_mode must be window|roll')
  if lane_shift not in ('auto', 'rotate', 'slice'):
    raise ValueError('lane_shift must be auto|rotate|slice')
  if lane_shift == 'auto':
    lane_shift = 'rotate' if shape[-1] <= 256 else 'slice'
  if stage_mode == 'auto':
    stage_mode = _chain_width_mode(plan.stages)
  if stage_mode not in ('value', 'vmem'):
    raise ValueError('stage_mode must be value|vmem|auto')
  if compute_chunk is not None:
    if dim < 3:
      raise utils.InputError('compute_chunk applies to 3-D grids only')
    if (isinstance(compute_chunk, bool) or
        not isinstance(compute_chunk, int) or compute_chunk < 1):
      raise utils.InputError('compute_chunk must be a positive int, '
                             'got %r' % (compute_chunk,))
    stage_mode = 'vmem'
  if dim < 2:
    raise utils.InputError(
        'the layout forms need >= 2-D grids (a warp window has rows and '
        'lanes); run 1-D stencils without layout keys')
  if mid_tile is not None and stage_mode != 'value' and compute_chunk is None:
    raise utils.InputError('mid tiling requires stage_mode=value')
  if shift_mode == 'roll' and stage_mode != 'value':
    raise utils.InputError('shift_mode=roll requires stage_mode=value')
  if stage_mode == 'vmem':
    if compute_chunk is None:
      return None
    return LayoutConfig(stage_mode='vmem', compute_chunk=compute_chunk)
  rotate = lane_shift == 'rotate' or shift_mode == 'roll'
  transposed = set()
  if dim == 2 and (shift_mode == 'roll' or not rotate) and \
      transpose_lanes != 'off':
    transposed = transposed_lane_regions(plan, stencil, transpose_lanes)
  narrow16 = set()
  if narrow == 'on':
    from soda_tpu_torch.optimization import ranges
    narrow16 = ranges.narrow16_stages(stencil) - transposed
  return LayoutConfig(stage_mode='value', shift_mode=shift_mode,
                      lane_shift=lane_shift, transposed=frozenset(transposed),
                      narrow16=frozenset(narrow16))


def split_layout_keys(opts: dict) -> dict:
  """Pop the layout keys out of ``opts`` (in place) and return them;
  ``interpret`` raises utils.InputError: the port's counterpart of
  Pallas's interpret mode is ``device='cpu'``."""
  for key in REJECTED_KEYS:
    if key in opts:
      raise utils.InputError(
          'interpret: Pallas\'s interpreter has no counterpart on the H100 '
          "kernel; pass device='cpu' to run the kernel's plain PyTorch "
          'version')
  return {k: opts.pop(k) for k in LAYOUT_KEYS if k in opts}
