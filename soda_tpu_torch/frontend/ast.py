"""Statement-level AST for the SODA DSL.

Rebuild of reference src/soda/grammar.py's statement classes
(InputStmt grammar.py:48, LocalStmt/OutputStmt grammar.py:73-151,
ParamStmt/ParamAttr grammar.py:153-171, SodaProgram grammar.py:173-207)
with identical textual round-trip semantics, minus the textX dependency.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from soda_tpu_torch import utils
from soda_tpu_torch.ir import arithmetic, nodes as ir, visitor
from soda_tpu_torch.ir.types import Type


class InputStmt(ir.Node):
  """``input dram 0 uint16: name(2000, *)``

  tile_size gets a trailing 0 sentinel for the streaming dimension and
  dram defaults to (0,), as in reference grammar.py:59-64.
  """
  SCALAR_ATTRS = ('name',)
  LINEAR_ATTRS = ('tile_size', 'dram')

  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    if not self.dram:
      self.dram = (0,)
    self.tile_size = tuple(self.tile_size) + (0,)

  def __str__(self):
    dram = '.'.join(map(str, self.dram))
    result = f'input dram {dram} {self.dtype}: {self.name}'
    if self.tile_size[:-1]:
      result += '({}, *)'.format(', '.join(map(str, self.tile_size[:-1])))
    return result


class LocalStmtOrOutputStmt(ir.Node):
  SCALAR_ATTRS = ('ref', 'expr')
  LINEAR_ATTRS = ('let',)

  def __init__(self, **kwargs):
    stencil = kwargs.pop('stencil', None)
    super().__init__(**kwargs)
    # bind let variable types onto Var uses (reference grammar.py:85-94)
    var_types = {let.name: let.dtype for let in self.let}

    def set_var_type(obj, var_types):
      if isinstance(obj, ir.Var) and obj.name in var_types:
        obj.dtype = var_types[obj.name]
      return obj

    self.let = tuple(l.visit(set_var_type, var_types) for l in self.let)
    self.expr = self.expr.visit(set_var_type, var_types)
    self.stencil = stencil

  @property
  def name(self) -> str:
    return self.ref.name

  def _key(self):  # exclude the stencil backref from structural identity
    return (type(self).__name__, self.dtype, self.ref, self.expr, self.let)

  def __str__(self):
    if self.let:
      let = '\n  {}\n '.format('\n  '.join(map(str, self.let)))
    else:
      let = ''
    expr = arithmetic.unparenthesize(self.expr)
    return f'{self.dtype}:{let} {self.ref} = {expr}'

  @property
  def symbol_table(self) -> Dict[str, Type]:
    """Stencil symbol table extended with this stmt's lets, toposorted
    (reference grammar.py:110-120)."""
    symbol_table = dict(self.stencil.symbol_table)
    lets = {let.name: let for let in self.let}
    dep_graph = {
        let.name: {v.name for v in visitor.get_vars(let) if v.name in lets}
        for let in self.let
    }
    for var in utils.toposort_flatten(dep_graph):
      if var in lets:
        symbol_table[var] = arithmetic.propagate_type(
            lets[var], symbol_table).expr.dtype if lets[var].dtype is None \
            else lets[var].dtype
    return symbol_table

  def propagate_type(self, dummy=None) -> None:
    """Propagate types; insert a Cast if the expr type differs from the
    declared type (reference grammar.py:123-136)."""
    symbol_table = self.symbol_table
    self.expr = arithmetic.propagate_type(self.expr, symbol_table)
    if self.expr.dtype != self.dtype:
      self.expr = ir.Cast(expr=self.expr, dtype=self.dtype)
    self.let = tuple(
        arithmetic.propagate_type(let, symbol_table) for let in self.let)


class LocalStmt(LocalStmtOrOutputStmt):

  def __str__(self):
    return f'local {super().__str__()}'


class OutputStmt(LocalStmtOrOutputStmt):
  LINEAR_ATTRS = LocalStmtOrOutputStmt.LINEAR_ATTRS + ('dram',)

  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    if not self.dram:
      self.dram = (0,)

  def _key(self):
    return super()._key() + (self.dram,)

  def __str__(self):
    return f'output dram {".".join(map(str, self.dram))} {super().__str__()}'


class Partitioning(ir.Node):
  SCALAR_ATTRS = ('strategy', 'factor', 'dim')

  def __str__(self):
    result = f'partition {self.strategy}'
    if self.strategy == 'cyclic':
      result += f' factor={self.factor}'
    if self.dim is not None:
      result += f' dim={self.dim}'
    return result


class ParamAttr(ir.Node):
  SCALAR_ATTRS = ('dup', 'partitioning')

  def __str__(self):
    if self.dup is not None:
      return f'dup {self.dup}'
    return str(self.partitioning)


class ParamStmt(ir.Node):
  SCALAR_ATTRS = ('name',)
  LINEAR_ATTRS = ('attr', 'size', 'dram')

  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    if not self.dram:
      self.dram = (0,)

  def __str__(self):
    return 'param {}{}: {}{}'.format(
        self.dtype, ''.join(map(', {}'.format, self.attr)), self.name,
        ''.join(map('[{}]'.format, self.size)))


class SodaProgram(ir.Node):
  SCALAR_ATTRS = ('border', 'burst_width', 'cluster', 'iterate', 'app_name',
                  'unroll_factor', 'input_stmts', 'param_stmts', 'local_stmts',
                  'output_stmts')

  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    for node in self.input_stmts:
      if hasattr(self, 'tile_size'):
        if node.tile_size[:-1] and self.tile_size != node.tile_size:
          raise utils.SemanticError(
              "tile size %s doesn't match previous one %s" %
              (node.tile_size, self.tile_size))
      elif node.tile_size[:-1]:
        self.tile_size = node.tile_size
        self.dim = len(self.tile_size)
    if not hasattr(self, 'tile_size'):
      self.tile_size = self.input_stmts[-1].tile_size
      self.dim = len(self.tile_size)

  def __str__(self):
    return '\n'.join(
        filter(None, (
            'border: {}'.format(self.border),
            'burst width: {}'.format(self.burst_width),
            'cluster: {}'.format(self.cluster),
            'iterate: {}'.format(self.iterate),
            'kernel: {}'.format(self.app_name),
            'unroll factor: {}'.format(self.unroll_factor),
            '\n'.join(map(str, self.input_stmts)),
            '\n'.join(map(str, self.param_stmts)),
            '\n'.join(map(str, self.local_stmts)),
            '\n'.join(map(str, self.output_stmts)),
        )))
