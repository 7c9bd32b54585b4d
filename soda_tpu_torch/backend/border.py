"""``border: preserve`` on torch tensors.

The counterpart of backend/reference.py:39-65 (``preserve_border_fixup``,
copied from the JAX package): cells outside each output's valid region
carry the positionally paired input's value, wrapped to the output
type. That function looks for ``.at`` (JAX) and otherwise calls
``.copy()``, which a torch tensor lacks, so the port keeps its own.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from soda_tpu_torch.backend import semantics
from soda_tpu_torch.backend.reference import output_valid_slices


def paired_input(stencil, name: str) -> str:
  """The input whose values ``border: preserve`` keeps outside output
  ``name``'s valid region: the one at its position, else the first."""
  n_in = len(stencil.input_names)
  k = stencil.output_names.index(name)
  return stencil.input_names[k if n_in == len(stencil.output_names) else 0]


def border_base(stencil, name: str, src: torch.Tensor) -> torch.Tensor:
  """A fresh storage tensor of output ``name``'s type holding ``src``
  (its paired input's storage tensor), wrapped to that type."""
  in_type = stencil.symbol_table[paired_input(stencil, name)]
  out_type = stencil.symbol_table[name]
  base = semantics.wrap(semantics.to_repr(src, in_type), out_type, in_type,
                        src.device)
  return semantics.to_storage(base, out_type).clone()


def preserve_border_fixup(stencil, shape: Tuple[int, ...],
                          get_input: Callable[[str], torch.Tensor],
                          outs: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
  """Return outputs whose cells outside the valid region come from the
  paired input. ``get_input(name)`` gives the input's storage tensor;
  ``outs`` maps output names to storage tensors of the full grid, or of
  a batch of grids of ``shape`` on leading axes (each grid its own)."""
  fixed = {}
  for name in stencil.output_names:
    base = border_base(stencil, name,
                       get_input(paired_input(stencil, name)))
    region = (Ellipsis,) + output_valid_slices(stencil, shape, name)
    base[region] = outs[name][region]
    fixed[name] = base
  return fixed
