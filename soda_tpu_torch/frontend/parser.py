"""Recursive-descent parser for the SODA DSL.

Replaces the reference's textX metamodel (grammar at
reference src/soda/grammar.py:15-46 plus haoda's expression
grammar). Same language surface:

  directives   border / burst width / cluster / iterate / kernel /
               unroll factor — in any order
  statements   input / param / local / output
  expressions  C-like precedence: || && | ^ & ==/!= </<=/>/>= +- */%
               unary +-~!; atoms: cast ``type(expr)``, intrinsic call,
               tensor ref ``name(i, j) [~lat]``, number, variable
               ``name[: idx]*``; ``#`` comments.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from soda_tpu_torch import utils
from soda_tpu_torch.frontend import ast
from soda_tpu_torch.ir import nodes as ir
from soda_tpu_torch.ir.types import Type, is_type_name


class SodaSyntaxError(utils.SemanticError):
  pass


_TOKEN_RE = re.compile(r"""
    (?P<WS>\s+|\#[^\n]*)
  | (?P<NUM>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?f?)
  | (?P<ID>[A-Za-z_]\w*)
  | (?P<OP>\|\||&&|==|!=|<=|>=|[-+*/%~!&|^<>()\[\],:=.])
""", re.VERBOSE)


class _Token:
  __slots__ = ('kind', 'text', 'pos', 'line', 'col')

  def __init__(self, kind, text, pos, line, col):
    self.kind, self.text, self.pos = kind, text, pos
    self.line, self.col = line, col

  def __repr__(self):
    return f'{self.kind}({self.text!r})@{self.line}:{self.col}'


def _tokenize(source: str) -> List[_Token]:
  tokens = []
  pos = 0
  line, col = 1, 1
  while pos < len(source):
    m = _TOKEN_RE.match(source, pos)
    if not m:
      raise SodaSyntaxError('unexpected character %r at line %d col %d' %
                            (source[pos], line, col))
    text = m.group(0)
    kind = m.lastgroup
    if kind != 'WS':
      tokens.append(_Token(kind, text, pos, line, col))
    nl = text.count('\n')
    if nl:
      line += nl
      col = len(text) - text.rfind('\n')
    else:
      col += len(text)
    pos = m.end()
  tokens.append(_Token('EOF', '', pos, line, col))
  return tokens



# chain levels from lowest to highest precedence
_LEVELS: Tuple[Tuple[type, Tuple[str, ...]], ...] = (
    (ir.Expr, ('||',)),
    (ir.LogicAnd, ('&&',)),
    (ir.BinaryOr, ('|',)),
    (ir.Xor, ('^',)),
    (ir.BinaryAnd, ('&',)),
    (ir.EqCmp, ('==', '!=')),
    (ir.LtCmp, ('<=', '>=', '<', '>')),
    (ir.AddSub, ('+', '-')),
    (ir.MulDiv, ('*', '/', '%')),
)


class Parser:

  def __init__(self, source: str):
    self.tokens = _tokenize(source)
    self.i = 0

  # -- token helpers ---------------------------------------------------------
  def peek(self, offset: int = 0) -> _Token:
    return self.tokens[min(self.i + offset, len(self.tokens) - 1)]

  def next(self) -> _Token:
    tok = self.tokens[self.i]
    self.i += 1
    return tok

  def accept(self, text: str) -> bool:
    if self.peek().text == text and self.peek().kind != 'NUM':
      self.i += 1
      return True
    return False

  def expect(self, text: str) -> _Token:
    tok = self.next()
    if tok.text != text:
      raise SodaSyntaxError('expected %r but got %r at line %d col %d' %
                            (text, tok.text, tok.line, tok.col))
    return tok

  def expect_kind(self, kind: str) -> _Token:
    tok = self.next()
    if tok.kind != kind:
      raise SodaSyntaxError('expected %s but got %r at line %d col %d' %
                            (kind, tok.text, tok.line, tok.col))
    return tok

  def _int(self) -> int:
    neg = False
    while True:
      if self.accept('-'):
        neg = not neg
      elif self.accept('+'):
        pass
      else:
        break
    tok = self.expect_kind('NUM')
    if not re.fullmatch(r'\d+', tok.text):
      raise SodaSyntaxError('expected integer, got %r at line %d' %
                            (tok.text, tok.line))
    return -int(tok.text) if neg else int(tok.text)

  # -- program ---------------------------------------------------------------
  def parse_program(self) -> ast.SodaProgram:
    fields = dict(border=None, burst_width=None, cluster=None, iterate=None,
                  app_name=None, unroll_factor=None)
    input_stmts, param_stmts, local_stmts, output_stmts = [], [], [], []
    while self.peek().kind != 'EOF':
      tok = self.peek()
      if tok.kind != 'ID':
        raise SodaSyntaxError('expected statement at line %d col %d, got %r' %
                              (tok.line, tok.col, tok.text))
      kw = tok.text
      if kw == 'border':
        self.next(); self.expect(':')
        fields['border'] = self.expect_kind('ID').text
      elif kw == 'burst':
        self.next(); self.expect('width'); self.expect(':')
        fields['burst_width'] = self._int()
      elif kw == 'cluster':
        self.next(); self.expect(':')
        fields['cluster'] = self.expect_kind('ID').text
      elif kw == 'iterate':
        self.next(); self.expect(':')
        fields['iterate'] = self._int()
      elif kw == 'kernel':
        self.next(); self.expect(':')
        fields['app_name'] = self.expect_kind('ID').text
      elif kw == 'unroll':
        self.next(); self.expect('factor'); self.expect(':')
        fields['unroll_factor'] = self._int()
      elif kw == 'input':
        input_stmts.append(self.parse_input())
      elif kw == 'param':
        param_stmts.append(self.parse_param())
      elif kw == 'local':
        local_stmts.append(self.parse_local_or_output(ast.LocalStmt))
      elif kw == 'output':
        output_stmts.append(self.parse_local_or_output(ast.OutputStmt))
      else:
        raise SodaSyntaxError('unknown statement %r at line %d' %
                              (kw, tok.line))
    missing = [k for k in ('burst_width', 'iterate', 'app_name',
                           'unroll_factor') if fields[k] is None]
    if missing:
      raise SodaSyntaxError('missing directive(s): %s' % ', '.join(missing))
    if not input_stmts:
      raise SodaSyntaxError('at least one input statement is required')
    if not output_stmts:
      raise SodaSyntaxError('at least one output statement is required')
    return ast.SodaProgram(input_stmts=tuple(input_stmts),
                           param_stmts=tuple(param_stmts),
                           local_stmts=tuple(local_stmts),
                           output_stmts=tuple(output_stmts), **fields)

  def _parse_dram(self) -> Tuple[int, ...]:
    if not self.accept('dram'):
      return ()
    # a bank list like `0.1.2` lexes as NUM('0.1') NUM('.2'); reassemble
    # the dotted text and split
    text = self.expect_kind('NUM').text
    while ((self.peek().kind == 'NUM' and self.peek().text.startswith('.'))
           or (self.peek().kind == 'OP' and self.peek().text == '.')):
      text += self.next().text
      if text.endswith('.'):  # `0.` `1` from `0.1`? keep consuming NUM
        text += self.expect_kind('NUM').text
    try:
      return tuple(int(x) for x in text.split('.'))
    except ValueError:
      raise SodaSyntaxError('invalid dram bank list: %r' % text)

  def _parse_type(self) -> Type:
    tok = self.expect_kind('ID')
    if not is_type_name(tok.text):
      raise SodaSyntaxError('expected a type, got %r at line %d' %
                            (tok.text, tok.line))
    return Type(tok.text)

  def parse_input(self) -> ast.InputStmt:
    self.expect('input')
    dram = self._parse_dram()
    dtype = self._parse_type()
    self.expect(':')
    name = self.expect_kind('ID').text
    tile_size: Tuple[int, ...] = ()
    if self.accept('('):
      sizes = []
      while not self.accept('*'):
        sizes.append(self._int())
        self.expect(',')
      self.expect(')')
      tile_size = tuple(sizes)
    return ast.InputStmt(dtype=dtype, dram=dram, name=name,
                         tile_size=tile_size)

  def parse_param(self) -> ast.ParamStmt:
    self.expect('param')
    dram = self._parse_dram()
    dtype = self._parse_type()
    attrs = []
    while self.accept(','):
      attrs.append(self._parse_param_attr())
    self.expect(':')
    name = self.expect_kind('ID').text
    size = []
    while self.accept('['):
      size.append(self._int())
      self.expect(']')
    return ast.ParamStmt(dtype=dtype, dram=dram, attr=tuple(attrs),
                         name=name, size=tuple(size))

  def _parse_param_attr(self) -> ast.ParamAttr:
    if self.accept('dup'):
      return ast.ParamAttr(dup=self._int(), partitioning=None)
    self.expect('partition')
    strategy = self.expect_kind('ID').text
    if strategy not in ('complete', 'cyclic'):
      raise SodaSyntaxError('unknown partition strategy %r' % strategy)
    factor = None
    dim = None
    if strategy == 'cyclic':
      self.expect('factor'); self.expect('=')
      factor = self._int()
    if self.accept('dim'):
      self.expect('=')
      dim = self._int()
    return ast.ParamAttr(
        dup=None,
        partitioning=ast.Partitioning(strategy=strategy, factor=factor,
                                      dim=dim))

  def parse_local_or_output(self, cls):
    kw = 'local' if cls is ast.LocalStmt else 'output'
    self.expect(kw)
    dram = self._parse_dram() if cls is ast.OutputStmt else ()
    dtype = self._parse_type()
    self.expect(':')
    lets = []
    while True:
      # a let is TYPE ID '=' or ID '=' ; a store ref is ID '(' ints ')'
      t0, t1, t2 = self.peek(0), self.peek(1), self.peek(2)
      if (t0.kind == 'ID' and is_type_name(t0.text) and t1.kind == 'ID' and
          t2.text == '='):
        let_type = self._parse_type()
        name = self.expect_kind('ID').text
        self.expect('=')
        lets.append(ir.Let(dtype=let_type, name=name, expr=self.parse_expr()))
      elif t0.kind == 'ID' and t1.text == '=' and t1.kind == 'OP':
        name = self.expect_kind('ID').text
        self.expect('=')
        lets.append(ir.Let(dtype=None, name=name, expr=self.parse_expr()))
      else:
        break
    ref = self._parse_ref()
    self.expect('=')
    expr = self.parse_expr()
    kwargs = dict(dtype=dtype, let=tuple(lets), ref=ref, expr=expr)
    if cls is ast.OutputStmt:
      kwargs['dram'] = dram
    return cls(**kwargs)

  def _parse_ref(self) -> ir.Ref:
    name = self.expect_kind('ID').text
    self.expect('(')
    idx = [self._int()]
    while self.accept(','):
      idx.append(self._int())
    self.expect(')')
    lat = None
    if self.accept('~'):
      lat = self._int()
    return ir.Ref(name=name, idx=tuple(idx), lat=lat)

  # -- expressions -------------------------------------------------------------
  def parse_expr(self, level: int = 0) -> ir.Node:
    if level == len(_LEVELS):
      return self._parse_unary()
    cls, ops = _LEVELS[level]
    operands = [self.parse_expr(level + 1)]
    operators = []
    while self.peek().kind == 'OP' and self.peek().text in ops:
      operators.append(self.next().text)
      operands.append(self.parse_expr(level + 1))
    if len(operands) == 1:
      return operands[0]
    return cls(operand=tuple(operands), operator=tuple(operators))

  def _parse_unary(self) -> ir.Node:
    ops = []
    while self.peek().kind == 'OP' and self.peek().text in ('+', '-', '~',
                                                            '!'):
      ops.append(self.next().text)
    operand = self._parse_operand()
    if not ops:
      return operand
    # fold a single '-' into a numeric literal
    if (ops == ['-'] and isinstance(operand, ir.Num) and
        not operand.lexeme.startswith('-')):
      return ir.Num(lexeme='-' + operand.lexeme, value=-operand.value,
                    dtype=operand.dtype)
    return ir.Unary(operator=tuple(ops), operand=operand)

  def _parse_operand(self) -> ir.Node:
    tok = self.peek()
    if tok.text == '(' and tok.kind == 'OP':
      self.next()
      expr = self.parse_expr()
      self.expect(')')
      return expr
    if tok.kind == 'NUM':
      self.next()
      return _make_literal(tok.text)
    if tok.kind != 'ID':
      raise SodaSyntaxError('unexpected token %r at line %d col %d' %
                            (tok.text, tok.line, tok.col))
    name = self.next().text
    if self.peek().text == '(' and self.peek().kind == 'OP':
      if is_type_name(name):
        self.next()
        expr = self.parse_expr()
        self.expect(')')
        return ir.Cast(expr=expr, dtype=Type(name))
      if name in ir.FUNCS:
        self.next()
        args = [self.parse_expr()]
        while self.accept(','):
          args.append(self.parse_expr())
        self.expect(')')
        return ir.Call(name=name, operand=tuple(args))
      # tensor reference: back up and reuse _parse_ref
      self.i -= 1
      return self._parse_ref()
    idx = []
    while self.accept('['):
      idx.append(self._int())
      self.expect(']')
    return ir.Var(name=name, idx=tuple(idx))


def _make_literal(lexeme: str) -> ir.Num:
  if lexeme.endswith('f'):
    return ir.Num(lexeme=lexeme, value=float(lexeme[:-1]),
                  dtype=Type('float'))
  if '.' in lexeme or 'e' in lexeme or 'E' in lexeme:
    return ir.Num(lexeme=lexeme, value=float(lexeme), dtype=Type('double'))
  return ir.Num(lexeme=lexeme, value=int(lexeme), dtype=None)


def parse(source: str) -> ast.SodaProgram:
  """Parse SODA DSL text into a SodaProgram."""
  return Parser(source).parse_program()


def parse_file(path: str) -> ast.SodaProgram:
  with open(path) as f:
    return parse(f.read())
