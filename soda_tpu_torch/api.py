"""Top-level API of the port: text -> Stencil -> executor.

``build_stencil`` and ``build_stencil_from_file`` are copies of
soda_tpu/api.py:9-39 over the port's own front half.
"""

from __future__ import annotations

from soda_tpu_torch import utils
from soda_tpu_torch.core.stencil import Stencil
from soda_tpu_torch.frontend import parser

__all__ = ['build_stencil', 'build_stencil_from_file', 'chained']


def build_stencil(source: str, **overrides) -> Stencil:
  """Parse SODA DSL text and construct a Stencil.

  ``overrides`` may replace any directive (burst_width, unroll_factor,
  tile_size, iterate, border, cluster, replication_factor, dram_in,
  dram_out, optimizations) — the analog of the reference CLI's
  override flags (sodac.py:45-97).
  """
  program = parser.parse(source)
  args = dict(
    border=program.border,
    burst_width=program.burst_width,
    cluster=program.cluster,
    iterate=program.iterate,
    app_name=program.app_name,
    unroll_factor=program.unroll_factor,
    replication_factor=overrides.pop('replication_factor', 1),
    dim=program.dim,
    tile_size=program.tile_size,
    input_stmts=list(program.input_stmts),
    param_stmts=list(program.param_stmts),
    local_stmts=list(program.local_stmts),
    output_stmts=list(program.output_stmts),
  )
  args.update(overrides)
  return Stencil(**args)


def build_stencil_from_file(path: str, **overrides) -> Stencil:
  with open(path) as f:
    return build_stencil(f.read(), **overrides)


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
