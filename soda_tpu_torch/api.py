"""Top-level API of the port: text -> Stencil -> executor.

``build_stencil`` and ``build_stencil_from_file`` are copies of
soda_tpu/api.py:9-39 over the port's own front half.
"""

from __future__ import annotations

from typing import Dict

from soda_tpu_torch import utils
from soda_tpu_torch.backend import graphs
from soda_tpu_torch.core.stencil import Stencil
from soda_tpu_torch.frontend import parser

__all__ = ['Chained', 'build_stencil', 'build_stencil_from_file', 'chained']


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


def chained(executor, n_steps: int) -> 'Chained':
  """Apply the stencil ``n_steps`` times, feeding outputs back as inputs
  (soda_tpu.api.chained, one jitted ``lax.fori_loop`` there).

  Requires as many outputs as inputs with matching types (as
  ``iterate > 1`` does). Returns a ``Chained``, callable with the
  executor's positional signature ``(*inputs, *params) -> (outputs...)``;
  prepare arguments with ``executor.prepare``.
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
  return Chained(executor, n_steps)


class Chained:
  """``n_steps`` calls of ``executor.fn``, each fed the last one's outputs.

  On a CUDA device the first call for a signature (the arguments'
  shapes, dtypes, devices and contiguity) runs ``loop`` and records the
  same ``n_steps`` calls in one CUDA graph (backend/graphs.py); every
  later call copies its arguments into the graph's fixed buffers,
  replays it (one dispatch for the whole run, as the JAX package's
  ``fori_loop`` is) and returns copies of its outputs, which no later
  call overwrites. ``replays`` counts those calls. A recording that
  fails raises.

  ``loop`` runs instead, enqueuing each call from Python, on the CPU,
  where an argument requires grad (autograd does not record through a
  replay, so gradients flow through the loop's calls as they would
  without ``chained``), inside a recording already under way (which
  records the loop's work itself), and for an executor whose
  ``recordable`` is false (the whole-grid executor, plain PyTorch that
  may wait on the host, and a sharded one that records nothing).
  """

  def __init__(self, executor, n_steps: int):
    self.executor = executor
    self.n_steps = n_steps
    self.n_in = len(executor.stencil.input_names)
    self.replays = 0
    self._graphs: Dict[tuple, graphs.Captured] = {}

  def loop(self, *args):
    """The ``n_steps`` calls enqueued from Python, one after another."""
    state = tuple(args[:self.n_in])
    pars = tuple(args[self.n_in:])
    for _ in range(self.n_steps):
      state = tuple(self.executor.fn(*state, *pars))
    return state

  def __call__(self, *args):
    if not (getattr(self.executor, 'recordable', True) and
            graphs.capturable(args)):
      return self.loop(*args)
    key = graphs.signature(args)
    captured = self._graphs.get(key)
    if captured is None:
      outs = self.loop(*args)
      fixed = tuple(graphs.clone(arg) for arg in args)
      self._graphs[key] = graphs.Captured(lambda: self.loop(*fixed),
                                          graphs.leaves(fixed))
      return outs
    outs = captured.replay(graphs.leaves(args))
    self.replays += 1
    return tuple(graphs.clone(out) for out in outs)
