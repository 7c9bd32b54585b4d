"""Top-level API of the port: text -> Stencil -> executor.

The front half is shared: ``build_stencil`` and
``build_stencil_from_file`` are soda_tpu.api's own.
"""

from __future__ import annotations

from soda_tpu import utils
from soda_tpu.api import build_stencil, build_stencil_from_file

__all__ = ['build_stencil', 'build_stencil_from_file', 'chained']


def chained(executor, n_steps: int):
  """Apply the stencil ``n_steps`` times, feeding outputs back as
  inputs (soda_tpu.api.chained; there a ``lax.fori_loop``, here a Python
  loop over ``executor.fn`` that keeps every tensor on the device).

  Requires as many outputs as inputs with matching types (as
  ``iterate > 1`` does). Returns a callable with the executor's
  positional signature ``(*inputs, *params) -> (outputs...)``; prepare
  arguments with ``executor.prepare``.
  """
  stencil = executor.stencil
  n_in = len(stencil.input_names)
  if len(stencil.output_names) != n_in or \
      tuple(stencil.symbol_table[n].np_dtype
            for n in stencil.input_names) != \
      tuple(stencil.symbol_table[n].np_dtype
            for n in stencil.output_names):
    raise utils.InputError(
        'chained() needs as many outputs as inputs with matching '
        'types (as iterate > 1 requires)')

  def run(*args):
    state = tuple(args[:n_in])
    pars = tuple(args[n_in:])
    for _ in range(n_steps):
      state = tuple(executor.fn(*state, *pars))
    return state

  return run
