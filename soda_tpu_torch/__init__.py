"""SODA-TPU ported to PyTorch and CUDA (NVIDIA Hopper).

The front half (DSL parser, IR, stencil core, optimization passes,
fusion planning, the NumPy oracle, the corpus) is the port's own copy
of the JAX package's, in the same layout (``utils``, ``ir``,
``frontend``, ``core``, ``optimization``, ``backend/plan.py``,
``backend/reference.py``, ``backend/c_semantics.py``, ``corpus.py``).
Beside it, what touches tensors and devices: the torch evaluator, the
tile plan, the generated CUDA kernel and its executors (fused, grouped,
replicated), and the ``python -m soda_tpu_torch`` command line. It
imports torch, never jax, and nothing of the JAX package.
"""

__version__ = '0.1.0'


def build_stencil(source, **overrides):
  """Parse SODA DSL text into a Stencil (see soda_tpu_torch.api)."""
  from soda_tpu_torch import api
  return api.build_stencil(source, **overrides)


def build_stencil_from_file(path, **overrides):
  from soda_tpu_torch import api
  return api.build_stencil_from_file(path, **overrides)


def get_executor(stencil, shape, backend='auto', device='cuda', **kwargs):
  """Compile a stencil for a grid shape (see soda_tpu_torch.backend)."""
  from soda_tpu_torch.backend import get_executor as _get
  return _get(stencil, shape, backend, device=device, **kwargs)


def chained(executor, n_steps):
  """Apply the stencil n_steps times (see soda_tpu_torch.api.chained)."""
  from soda_tpu_torch import api
  return api.chained(executor, n_steps)
