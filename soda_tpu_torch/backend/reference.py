"""NumPy reference executor: the framework's correctness oracle.

Plays the role of the reference's generated scalar CPU check
(reference src/soda/codegen/frt/host.py:558-660 — the
``SODA_TEST_MAIN`` loop nest): every non-input tensor is produced in
chronological order over the full grid, each one restricted to its own
valid region computed from the overall stencil window, with C arithmetic
semantics (see soda_tpu_torch.backend.c_semantics).

Array-axis convention (see soda_tpu_torch.backend.plan): arrays are indexed in
reversed DSL-dimension order — ``a[i_{dim-1}, ..., i_1, i_0]`` with the
streaming dimension as axis 0 and DSL dimension 0 minor-most. Cells
outside a tensor's valid region stay zero (the reference's host buffers
are value-initialized, host.py:476).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from soda_tpu_torch import utils
from soda_tpu_torch.backend import c_semantics as semantics
from soda_tpu_torch.backend.plan import stage_margins, validate_grid
from soda_tpu_torch.core.tensor import Tensor
from soda_tpu_torch.ir import nodes as ir


def _axis_slices(lo: Tuple[int, ...], hi: Tuple[int, ...],
                 shape: Tuple[int, ...]) -> Tuple[slice, ...]:
  """DSL-dim margins -> array-axis slices (axes are reversed DSL dims)."""
  dim = len(lo)
  return tuple(
      slice(lo[dim - 1 - a], shape[a] - hi[dim - 1 - a])
      for a in range(dim))


def preserve_border_fixup(xp, stencil, shape: Tuple[int, ...],
                          get_input, outs: dict) -> dict:
  """``border: preserve``: cells outside each output's valid region
  carry the positionally-paired input's value (wrapped to the output
  type). One shared implementation for every single-chip executor —
  the sharded executor derives the GLOBAL boundary from each shard's
  mesh position and stays separate. ``get_input(name)`` returns the
  full input array; works on NumPy (in-place copy) and JAX (.at[].set)
  arrays alike. (The reference reserves the directive in its grammar;
  its generated host preserves borders during untiling,
  host.py:846-950.)
  """
  fixed = {}
  n_in = len(stencil.input_names)
  for k, name in enumerate(stencil.output_names):
    paired = stencil.input_names[
        k if n_in == len(stencil.output_names) else 0]
    base = semantics.wrap(xp, get_input(paired),
                          stencil.symbol_table[name])
    region = output_valid_slices(stencil, shape, name)
    if hasattr(base, 'at'):  # jax array
      fixed[name] = base.at[region].set(outs[name][region])
    else:
      base = base.copy()
      base[region] = np.asarray(outs[name])[region]
      fixed[name] = base
  return fixed


def output_valid_slices(stencil, shape: Tuple[int, ...],
                        name: Optional[str] = None) -> Tuple[slice, ...]:
  """Array-axis slices of the valid (comparable) region of an output."""
  tensor = stencil.tensors[name or stencil.output_names[0]]
  lo, hi = stage_margins(stencil, tensor)
  return _axis_slices(lo, hi, shape)


class ReferenceExecutor:
  """Interprets the stencil tensor DAG with NumPy.

  Usage::

    ref = ReferenceExecutor(stencil)
    outs = ref.run({'input': arr})            # dict name -> full array
    region = output_valid_slices(stencil, arr.shape)
  """

  def __init__(self, stencil):
    self.stencil = stencil

  def run(self,
          inputs: Mapping[str, np.ndarray],
          params: Optional[Mapping[str, np.ndarray]] = None,
          return_locals: bool = False) -> Dict[str, np.ndarray]:
    stencil = self.stencil
    params = dict(params or {})
    arrays: Dict[str, np.ndarray] = {}
    shape: Optional[Tuple[int, ...]] = None
    for name in stencil.input_names:
      if name not in inputs:
        raise utils.InputError('missing input: %s' % name)
      arr = np.asarray(inputs[name])
      dtype = stencil.symbol_table[name]
      arrays[name] = semantics.wrap(np, arr, dtype)
      if shape is None:
        shape = arr.shape
      elif arr.shape != shape:
        raise utils.InputError(
            'input %s shape %s != %s' % (name, arr.shape, shape))
    assert shape is not None
    validate_grid(stencil, shape)

    for tensor in stencil.chronological_tensors:
      if tensor.is_input():
        continue
      arrays[tensor.name] = self._produce(tensor, arrays, params, shape)

    if stencil.preserve_border:
      for name, fixed in preserve_border_fixup(
          np, stencil, shape,
          lambda n: arrays[n],
          {n: arrays[n] for n in stencil.output_names}).items():
        arrays[name] = fixed

    if return_locals:
      return arrays
    return {name: arrays[name] for name in stencil.output_names}

  def _produce(self, tensor: Tensor, arrays, params, shape) -> np.ndarray:
    stencil = self.stencil
    dim = len(shape)
    lo, hi = stage_margins(stencil, tensor)
    region = _axis_slices(lo, hi, shape)
    st_idx = tensor.st_idx

    def load(ref: ir.Ref):
      if ref.name in stencil.param_names:
        return params[ref.name][tuple(ref.idx)]
      src = arrays[ref.name]
      window = tuple(
          slice(region[a].start + ref.idx[dim - 1 - a] - st_idx[dim - 1 - a],
                region[a].stop + ref.idx[dim - 1 - a] - st_idx[dim - 1 - a])
          for a in range(dim))
      return src[window]

    def param(name, idx):
      return params[name][idx]

    evaluator = semantics.Evaluator(np, load, param=param)
    value, _ = evaluator.eval_stmt(tensor)
    out = np.zeros(shape, dtype=tensor.dtype.np_dtype)
    out[region] = semantics.wrap(np, value, tensor.dtype)
    return out


def run(stencil, inputs, params=None, **kwargs) -> Dict[str, np.ndarray]:
  return ReferenceExecutor(stencil).run(inputs, params, **kwargs)


def make_test_inputs(stencil, shape: Tuple[int, ...],
                     seed: int = 0) -> Dict[str, np.ndarray]:
  """Generate inputs like the reference self-test does: coordinate-sum
  ramps for integer tensors, uniform [0, 1) for floats
  (frt/host.py:513-528)."""
  rng = np.random.default_rng(seed)
  inputs: Dict[str, np.ndarray] = {}
  for name in stencil.input_names:
    dtype = stencil.symbol_table[name]
    if dtype.is_float:
      inputs[name] = rng.random(shape).astype(dtype.np_dtype)
    else:
      ramp = np.zeros(shape, dtype=np.int64)
      for a in range(len(shape)):
        axes = [1] * len(shape)
        axes[a] = shape[a]
        ramp = ramp + np.arange(shape[a], dtype=np.int64).reshape(axes)
      inputs[name] = semantics.wrap(np, ramp, dtype)
  return inputs


def make_test_params(stencil, seed: int = 1):
  rng = np.random.default_rng(seed)
  params = {}
  for stmt in stencil.param_stmts:
    size = tuple(stmt.size)
    if stmt.dtype.is_float:
      params[stmt.name] = rng.random(size).astype(stmt.dtype.np_dtype)
    else:
      ramp = np.zeros(size, dtype=np.int64)
      for a in range(len(size)):
        axes = [1] * len(size)
        axes[a] = size[a]
        ramp = ramp + np.arange(size[a], dtype=np.int64).reshape(axes)
      params[stmt.name] = semantics.wrap(np, ramp, stmt.dtype)
  return params
