"""Grouped execution: the ``cluster`` granularity knob.

The counterpart of soda_tpu/backend/grouped.py. ``cluster: none/full``
fuses every stage into one kernel; ``coarse`` (and ``fine``, which the
fusion plan treats as ``coarse``, plan.py:14-18) runs one fused kernel
per stage group, handing full-size tensors from group to group through
device memory.

Each group is materialized as a self-contained sub-Stencil whose inputs
are the group's external parents (``group_stencil``, a copy of the JAX
package's), so every group reuses the ordinary ``FusedExecutor``. A
group's kernel writes only its sub-stencil's valid region into
``torch.empty`` storage; the next group reads the cells outside it as
they are. That is sound because, as ``materialized_margins`` composes,
every cell that depends on them lies outside the original stencil's
valid region: compare grouped results there only.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.backend import cuda_source
from soda_tpu_torch.backend.fused import (FusedExecutor, check_args,
                                          check_stencil, fix_border,
                                          fused_stencil_plain, prepare_args,
                                          resolve_device)
from soda_tpu_torch.backend.plan import make_plan, validate_grid
from soda_tpu_torch.backend.tile_plan import kernel_plan
from soda_tpu_torch.core.stencil import Stencil
from soda_tpu_torch.frontend import ast

# What the grouped kernels replace, for the run's report: the TPU's
# per-group Pallas kernels chained through HBM.
REPLACES = 'soda_tpu/backend/grouped.py:115'


def group_stencil(stencil, group, index: int) -> Stencil:
  """Build a self-contained Stencil computing one stage group.

  Group inputs are every tensor the group loads but does not produce;
  group outputs are stages consumed outside the group (or program
  outputs). ``border`` is always ``ignore`` — preserve fix-ups apply
  once, at the whole-program level.
  """
  produced = {stage.name for stage in group}
  external: List[str] = []
  for stage in group:
    for parent in stage.tensor.ld_refs:
      if (parent not in produced and parent not in external and
          parent not in stencil.param_names):
        external.append(parent)
  outputs = set(stencil.output_names)
  consumed_outside = set()
  for other in stencil.chronological_tensors:
    if other.name in produced:
      continue
    consumed_outside.update(n for n in other.ld_refs if n in produced)

  input_stmts = [
      # iterate clones (name_iterN) are tensors, not statements, so
      # dtype comes from the tensor table
      ast.InputStmt(dtype=stencil.tensors[name].dtype, name=name,
                    tile_size=stencil.tile_size[:-1], dram=())
      for name in external
  ]
  local_stmts, output_stmts = [], []
  for stage in group:
    t = stage.tensor
    kwargs = dict(ref=copy.copy(t.st_ref), dtype=t.dtype, expr=t.expr,
                  let=t.lets)
    # dead locals (no consumers anywhere — legal DSL) must still be
    # a sub-stencil output so the group has one; the value is simply
    # never read downstream
    dead = not t.children and t.name not in outputs
    if t.name in outputs or t.name in consumed_outside or dead:
      if t.name in consumed_outside and t.children and any(
          c in produced for c in t.children):
        raise utils.InternalError(
            'stage %s is consumed both inside and outside its group' %
            t.name)
      output_stmts.append(ast.OutputStmt(dram=(), **kwargs))
    else:
      local_stmts.append(ast.LocalStmt(**kwargs))
  return Stencil(
      app_name='%s_g%d' % (stencil.app_name, index),
      border='ignore', cluster='none', iterate=1,
      burst_width=stencil.burst_width,
      unroll_factor=stencil.unroll_factor,
      tile_size=stencil.tile_size, dim=stencil.dim,
      input_stmts=input_stmts, local_stmts=local_stmts,
      output_stmts=output_stmts, param_stmts=list(stencil.param_stmts),
      optimizations={})


def group_stencils(stencil, cluster: Optional[str] = None):
  """(the fusion plan, one sub-stencil per group in run order). The
  plan lists its groups in a liveness order that varies with the hash
  seed (plan.py:256, :279-283); here they run in chronological order
  (a topological one: each group is one stage, or all of them), so
  every sub-stencil, its source and its build key depend only on the
  stencil."""
  plan = make_plan(stencil, cluster or stencil.cluster or 'coarse')
  order = {t.name: i for i, t in enumerate(stencil.chronological_tensors)}
  groups = sorted(plan.groups,
                  key=lambda g: min(order[s.name] for s in g))
  return plan, [group_stencil(stencil, g, i) for i, g in enumerate(groups)]


def _compose(stencil, subs: Sequence[Stencil], run_group, args):
  """Run the groups in order on positional ``args``, each group's
  inputs taken from the program's inputs or earlier groups' outputs;
  returns the program's outputs (before any border fix-up)."""
  n_in = len(stencil.input_names)
  env: Dict[str, torch.Tensor] = dict(zip(stencil.input_names, args[:n_in]))
  params = dict(zip(stencil.param_names, args[n_in:]))
  for gi, sub in enumerate(subs):
    group_args = [env[name] for name in sub.input_names]
    group_args += [params[name] for name in sub.param_names]
    env.update(zip(sub.output_names, run_group(gi, group_args)))
  return tuple(env[name] for name in stencil.output_names)


def grouped_stencil_plain(stencil, inputs: Sequence[torch.Tensor],
                          params: Sequence[torch.Tensor] = (),
                          cluster: Optional[str] = None
                          ) -> Tuple[torch.Tensor, ...]:
  """The grouped kernels' function in plain PyTorch: the same groups,
  each through ``fused_stencil_plain`` (whole grid as one tile). Outputs
  are defined on the original stencil's valid regions."""
  _, subs = group_stencils(stencil, cluster)

  def run_group(gi, group_args):
    n_in = len(subs[gi].input_names)
    return fused_stencil_plain(subs[gi], group_args[:n_in],
                               group_args[n_in:])

  return _compose(stencil, subs, run_group, (*inputs, *params))


class GroupedExecutor:
  """Run a stencil as one fused CUDA kernel per plan group (on the CPU,
  each group's plain version).

  Args:
    stencil: a core.Stencil of this package.
    shape: full array shape (streaming axis first).
    cluster: 'coarse' or 'fine' (default: the stencil's directive, else
      'coarse').
    device: 'cuda' (default; raises without a usable GPU) or 'cpu'.
    replicas: as FusedExecutor's: None, or R grids per call.
    apply_preserve_border: as FusedExecutor's.
    **opts: every group kernel's options (FusedExecutor's ``tile`` and
      modes), as GroupedPallasExecutor forwards its ``**kwargs``
      (soda_tpu/backend/grouped.py:95,110).

  ``launches`` is the sum of the groups' kernel launches.
  """

  def __init__(self, stencil, shape: Sequence[int],
               cluster: Optional[str] = None, device='cuda',
               replicas: Optional[int] = None,
               apply_preserve_border: bool = True, **opts):
    check_stencil(stencil)
    self.stencil = stencil
    self.apply_preserve_border = apply_preserve_border
    self.shape = tuple(int(s) for s in shape)
    # per-group sub-stencils see their group inputs as margin-zero, so
    # the per-executor checks do NOT compose to the full window:
    # validate against the ORIGINAL stencil's cumulative margins here
    validate_grid(stencil, self.shape)
    self.device = resolve_device(device)
    self.plan, subs = group_stencils(stencil, cluster)
    if self.device.type == 'cuda':  # every group's nvcc at once
      from soda_tpu_torch.backend.build import build_all
      build_all([cuda_source.generate(kernel_plan(sub, self.shape, **opts))
                 for sub in subs])
    self.executors: List[Tuple[Stencil, FusedExecutor]] = [
        (sub, FusedExecutor(sub, self.shape, device=self.device,
                            replicas=replicas, **opts)) for sub in subs]
    self.replicas = replicas
    self.batch_shape = self.executors[0][1].batch_shape

  @property
  def launches(self) -> int:
    return sum(ex.launches for _, ex in self.executors)

  @launches.setter
  def launches(self, value: int) -> None:
    """Reset every group's count (only 0 is meaningful for a sum)."""
    if value != 0:
      raise ValueError('launches can only be reset to 0')
    for _, ex in self.executors:
      ex.launches = 0

  def prepare(self, inputs: Mapping[str, np.ndarray],
              params: Optional[Mapping[str, np.ndarray]] = None
              ) -> Tuple[torch.Tensor, ...]:
    return prepare_args(self.stencil, self.batch_shape, self.device, inputs,
                        params)

  def fn(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Positional ``fn(*inputs, *params) -> (outputs...)``: one launch
    per group, in chronological order."""
    check_args(self.stencil, self.batch_shape, self.device, args)
    outs = _compose(self.stencil, [sub for sub, _ in self.executors],
                    lambda gi, group_args: self.executors[gi][1].fn(
                        *group_args), args)
    if self.stencil.preserve_border and self.apply_preserve_border:
      outs = fix_border(self.stencil, self.shape,
                        args[:len(self.stencil.input_names)], outs)
    return outs

  def __call__(self, inputs: Mapping[str, np.ndarray],
               params: Optional[Mapping[str, np.ndarray]] = None
               ) -> Dict[str, torch.Tensor]:
    outs = self.fn(*self.prepare(inputs, params))
    return dict(zip(self.stencil.output_names, outs))
