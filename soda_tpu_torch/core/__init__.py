"""Stencil core (tensor-level IR + scheduling; reference layer L4)."""

from soda_tpu_torch.core.stencil import (  # noqa: F401
    Stencil, overall_window, window_extent, window_margins, window_offset,
)
from soda_tpu_torch.core.tensor import Tensor  # noqa: F401
