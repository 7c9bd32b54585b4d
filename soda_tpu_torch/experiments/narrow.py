"""The 16-bit and op-rate probes' kernels, their plain versions and bounds.

One hand-written CUDA source, ``csrc/probe_narrow.cu`` (``narrow_probe``),
replaces 13 Pallas probes of six JAX scripts in ``experiments/``:
exp13_narrow_i16.py:57 and :195, exp29_pack_i16.py:72,
exp16_swar_erosion.py:76 and :126, exp1_value_mode.py:50 and :76,
exp2_diag.py:87 and :148, exp12_mosaic_reprobe.py:68, :147, :161 and
:174. Each body of those probes is a ``NarrowBody``: the script's case,
the kernel's form and op, its block's shape and type, the least
operations its function needs per cell (or per 32-bit word of two packed
int16) and iteration, and its plain version. Four forms (see the
source): ``binary`` and ``fold`` run once (a body of two blocks, or of
shifted slices of one); ``ew`` and ``strip`` chain a body ``n`` times in
one launch (in registers; wrap-around shifts along whole lines a CTA
holds). The strip kernel also runs exp24's shift chains for
``probes.chain_probe`` (``EXP24_SHIFT``), and every shift chain's plain
version is ``probes._shift_step``. A strip body of one chained phase runs
the strip kernel with no grid barrier, one of several phases (exp16's
two stages, exp24's roll10) a grid barrier a phase. A MinI32 body of
independent phases along the lanes whose block one cluster holds
(exp24's indep10; ``NarrowBody.cluster``, fixed by its plan) runs
``strip_cluster``: the block held in one thread-block cluster's
registers for all n iterations, a band of rows a CTA, the cross taps'
margin rows read from the next band's CTA after a cluster barrier
(``NarrowBody.barriers``); the strip kernel stays for comparisons
(``launch(..., _old=True)``).

The blocks' types on the card: int16, int32, float32; an unsigned 16-bit
block travels as the int16 tensor of its bits, an unsigned 32-bit one
(and a word of two packed int16, the low half first) as the int32 tensor
of its bits. The plain versions compute 16-bit values in 32 bits and
wrap them to 16, 32-bit ones in 64 bits and wrap them to 32, as the
scripts' numpy ``want`` values do. A packed body's intrinsic form
(``__vmins2``, the signed pair min, one VIMNMX.S16x2 on sm_90;
``__vadd2``; ``__byte_perm``) and its bitwise form (the script's own
sequence) share one plain version.

``narrow_probe`` launches the kernel for CUDA tensors (raising if CUDA
refuses) and runs the plain version only for CPU tensors; each launch
adds one to ``probes.LAUNCHES[('probe_narrow', body name)]``. On the
card the one-shot forms run ``vec_binary`` and ``tile_fold``; the first
``binary`` and ``fold`` kernels stay for comparisons
(``launch(..., _old=True)``), as does the strip kernel for a
``strip_cluster`` body. ``narrow_oneshot`` times the one-shot bodies
replayed from a CUDA graph.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import os
import re
import statistics
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from soda_tpu_torch import profiling, utils
from soda_tpu_torch.experiments import probes

SOURCE = 'probe_narrow.cu'
KERNEL = 'probe_narrow'  # probes.LAUNCHES' key: (KERNEL, body name)
# each script's file in experiments/, and the iterations its slope runs
# between: the scripts' own n_small and n_big, but exp2's n_big, raised
# from 512: its register chains take a tenth of a µs an iteration on an
# H100, and between 32 and 512 iterations the slope did not resolve
# beside the launch's own spread (-0.022 to 0.038 µs)
SCRIPTS = {'exp13': 'exp13_narrow_i16', 'exp29': 'exp29_pack_i16',
           'exp16': 'exp16_swar_erosion', 'exp12': 'exp12_mosaic_reprobe',
           'exp1': 'exp1_value_mode', 'exp2': 'exp2_diag'}
SLOPE = {'exp13': (32, 512), 'exp2': (32, 16384), 'exp16': (64, 2048),
         'exp29': (64, 16384)}
FORMS = ('binary', 'ew', 'fold', 'strip')
# the old one-shot kernels' form indices (the first binary and fold, kept
# byte for byte for comparisons; the public path never passes them)
OLD_FORMS = {'binary': 4, 'fold': 5}
# strip_cluster: its form index, its builds (the source's
# SODA_CLUSTER_FORMS: op -> rows a band (a CTA), 32-bit words a row), its
# most CTAs (one non-portable cluster) and a tap's furthest distance (its
# kMaxDist)
CLUSTER_FORM = 6
CLUSTER_FORMS = {'MinI32': (16, 1024)}
CLUSTER_MAX_CTAS = 16
CLUSTER_MAX_DIST = 8
MAX_STEPS = 10  # the most steps of a strip phase (the source's kMaxSteps)
_I16, _I32, _F32 = torch.int16, torch.int32, torch.float32
# the SASS opcodes each body's row shows (cuobjdump -sass), beside the
# total: integer min (sm_90's VIMNMX; IMNMX before it), the packed pair
# min and add (VIMNMX.S16x2, VIADD.16x2), the byte permute (PRMT), adds,
# logic, funnel shifts, compares and selects, float ops, barriers and
# shared-memory traffic
SASS_OPS = ('IMNMX', 'VIMNMX', 'VIMNMX.S16x2', 'PRMT', 'IADD3', 'VIADD',
            'VIADD.16x2', 'LOP3', 'SHF', 'LEA', 'ISETP', 'SEL', 'IMAD',
            'FADD', 'FMUL', 'FFMA', 'BAR', 'LDS', 'STS')
EW_UNROLL = 16  # the source's kUnroll: ew iterations a trip of its main loop
# integer issue lanes per SM and clock (Hopper): the ALU pipe's alone
# (probes.UNIT_LANES: min, max, logic, compares, selects, shifts, byte
# permutes, packed mins), and the ALU's with the FMA pipe's, which takes
# an add (IMAD, VIADD; a packed VIADD.16x2 too: a chain of them ran at
# 1.07 of the ALU's rate alone on an H100), subtract, multiply or left
# shift as well
INT_ANY_LANES = 2 * probes.UNIT_LANES['int32']
# a body whose time is below its bound (the least time the card could
# take) by more than this fails: its bound, or its kernel, is wrong
MAX_SHARE = 1.05


# -- integer semantics of the plain versions ---------------------------------

def _wrap16(v: torch.Tensor) -> torch.Tensor:
  """The low 16 bits of an integer tensor as int16 (two's complement)."""
  return (((v.to(torch.int64) + 0x8000) & 0xFFFF) - 0x8000).to(_I16)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
  """The low 32 bits of an integer tensor as int32 (two's complement)."""
  return (((v.to(torch.int64) + 2**31) & 0xFFFFFFFF) - 2**31).to(_I32)


def _w(v: torch.Tensor) -> torch.Tensor:
  return v.to(torch.int64)


def _u32(v: torch.Tensor) -> torch.Tensor:
  """The unsigned value of an int32 tensor of 32-bit words (int64)."""
  return v.to(torch.int64) & 0xFFFFFFFF


def halves(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """(low, high) int16 values of int32 words of two packed int16, each
  sign-extended to int64 (``pltpu.unpack_elementwise`` index 0, 1)."""
  w = w.to(torch.int64)
  return ((w & 0xFFFF) ^ 0x8000) - 0x8000, w >> 16


def pack(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
  """int32 words of the low 16 bits of ``lo`` (low half) and ``hi``."""
  return _wrap32((_w(lo) & 0xFFFF) | ((_w(hi) & 0xFFFF) << 16))


def pair_min(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """Per-half signed min of packed words: ``__vmins2``, and the
  function of exp12's, exp13's and exp16's bitwise SWAR sequences."""
  (xl, xh), (yl, yh) = halves(x), halves(y)
  return pack(torch.minimum(xl, yl), torch.minimum(xh, yh))


def elem_shift(v: torch.Tensor, d: int) -> torch.Tensor:
  """Packed words shifted by ``d`` int16 elements along the lanes
  (exp16's ``elem_shift``; exp13's lane_swar_pk funnel at d = 1)."""
  k, odd = divmod(d, 2)
  v0 = probes._roll(v, 1, k)
  if not odd:
    return v0
  return _wrap32(((_w(v0) >> 16) & 0xFFFF) |
                 (_w(probes._roll(v0, 1, 1)) << 16))


# -- the bodies ---------------------------------------------------------------

# binary bodies: the kernel's op -> the plain function of (a, b)
_BINARY = {
    'I16Min': torch.minimum,
    'I16Max': torch.maximum,
    'I16Add': lambda a, b: _wrap16(_w(a) + _w(b)),
    'I16Mul': lambda a, b: _wrap16(_w(a) * _w(b)),
    'U16Min': lambda a, b: _wrap16(torch.minimum(_w(a) & 0xFFFF,
                                                 _w(b) & 0xFFFF)),
    'I32Mix': lambda a, b: _wrap32(((_w(a) & 0xFFFF) | (_w(b) << 16)) ^
                                   ((_w(a) >> 15) & 0x10001)),
    'U32Min': lambda a, b: _wrap32(torch.minimum(_u32(a), _u32(b))),
    'SwarMinSimd': pair_min,
    'SwarMinBias': pair_min,
    'SwarAddV2': lambda a, b: _wrap32((_u32(a) & 0x7FFF7FFF) +
                                      (_u32(b) & 0x7FFF7FFF)),
    'I16WhereMin': lambda a, b: torch.where(a < b, a, b),
    'I16Sub': lambda a, b: _wrap16(_w(a) - _w(b)),
    'I16SynthSub': lambda a, b: _wrap16(_w(a) + (_w(b) ^ -1) + 1),
    'I16AndOrXor': lambda a, b: (a & b) | (a ^ b),
    'I16ShlShr': lambda a, b: _wrap16((_w(a) << 2) + (_w(b) >> 3)),
    'I16MaskMin': lambda a, b: _wrap16(
        _w(b) + ((_w(a) - _w(b)) & -(a < b).to(torch.int64))),
    'I16Less': lambda a, b: (a < b).to(_I16),
}
_BINARY['SwarAddGuard'] = _BINARY['SwarAddV2']

# ew bodies: the kernel's op -> one iteration of the plain chain
_EW = {
    'EwMul3Min': lambda v: torch.minimum(v, _wrap32(_w(v) * 3 + 1)),
    'EwAddXor16': lambda v: _wrap16((_w(v) + _w(v)) ^ 3),
    'EwAddXor32': lambda v: _wrap32((_w(v) + _w(v)) ^ 3),
    # pack_roundtrip: unpack, the low half + 1 (32767 + 1 wraps to
    # -32768 in its 16 bits), the high half as it was, pack
    'PackRoundtrip': lambda v: pack(halves(v)[0] + 1, halves(v)[1]),
    'MinPlusOne16': lambda v: torch.minimum(v, _wrap16(_w(v) + 1)),
    'Fma32': lambda v: v * np.float32(1.0000001) + np.float32(1e-9),
    'Double32': lambda v: _wrap32(_w(v) + _w(v)),
    'Double16': lambda v: _wrap16(_w(v) + _w(v)),
}


def _wrap_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return (_wrap16 if a.dtype == _I16 else _wrap32)(_w(a) + _w(b))


def _pair_shift(v: torch.Tensor, axis: int, d: int) -> torch.Tensor:
  """Packed words shifted by ``d`` int16 elements along the lanes, or by
  ``d`` words along the sublanes."""
  return elem_shift(v, d) if axis == 1 else probes._roll(v, axis, d)


def _strided_shift(v: torch.Tensor, axis: int, d: int) -> torch.Tensor:
  """exp29's roll_strided: column j is v[(i + d - j) % rows, j]."""
  rows, cols = v.shape
  i = torch.arange(rows).view(-1, 1)
  j = torch.arange(cols).view(1, -1)
  return v.gather(0, ((i + d - j) % rows).to(v.device))


# strip ops -> (combine, shift) of their steps in probes._shift_step, the
# plain version of every shift chain
_STRIP = {
    'MinI32': (torch.minimum, probes._roll),
    'MinI16': (torch.minimum, probes._roll),
    'WideMinI16': (torch.minimum, probes._roll),
    'AddI32': (_wrap_add, probes._roll),
    'AddI16': (_wrap_add, probes._roll),
    'AddF32': (torch.add, probes._roll),
    'RollStrided': (lambda _, s: _wrap32(_w(s) + 1), _strided_shift),
    'PairMinSimd': (pair_min, _pair_shift),
    'Swar13': (pair_min, _pair_shift),
    'Swar16': (pair_min, _pair_shift),
}


def phase_taps(phases) -> Tuple[Tuple[int, int, bool], ...]:
  """A strip body's phases as ``probes._shift_step``'s taps: each step of
  a chained phase a phase of its own; an independent phase's taps along
  its axis and its cross taps, one phase."""
  taps: List[Tuple[int, int, bool]] = []
  for axis, dists, *cross in phases:
    if not cross:
      taps += [(axis, d, True) for d in dists]
      continue
    group = [(axis, d) for d in dists] + [(1 - axis, d) for d in cross[0]]
    taps += [(a, d, k == len(group) - 1) for k, (a, d) in enumerate(group)]
  return tuple(taps)


def taps_phases(taps) -> Tuple[tuple, ...]:
  """``probes._shift_step``'s taps of a min chain as strip phases: a run
  of phases of one tap each along one axis one chained phase of that
  many steps (up to MAX_STEPS: the same function, each step reading the
  one before); a phase of several taps an independent phase along the
  axis most of them take (the lanes at a tie), the others its cross
  taps."""
  phases, group = [], []
  for axis, d, last in taps:
    group.append((axis, d))
    if not last:
      continue
    if len(group) == 1:
      prev = phases[-1] if phases else None
      if (prev is not None and len(prev) == 2 and prev[0] == axis and
          len(prev[1]) < MAX_STEPS):
        phases[-1] = (axis, prev[1] + (d,))
      else:
        phases.append((axis, (d,)))
    else:
      along = int(2 * sum(a for a, _ in group) >= len(group))
      phases.append((along, tuple(d for a, d in group if a == along),
                     tuple(d for a, d in group if a != along)))
    group = []
  return tuple(phases)


@dataclasses.dataclass(frozen=True)
class NarrowBody:
  """One body of the six scripts' probes.

  ``name`` is '<script> <case>' (``case`` as the script prints it, with
  the type and shape where the script runs one case at several);
  ``line`` the line of the script's ``pallas_call`` it replaces;
  ``form`` and ``op`` the kernel's; ``shape`` and ``dtype`` the output
  block's (and but for a fold the inputs'); ``kshape`` the 2-D block a
  strip kernel walks (a 3-D block's axes merged); ``taps`` a fold's
  (row, lane) offsets into its input of ``in_shape``; ``phases`` a
  strip's phases, each (axis, distances): steps that each read the cell
  that distance further on, wrapping, from the step before; or (axis,
  distances, cross distances): an independent phase, one min over its
  values and their shifts by the distances along the axis and by the
  cross distances along the other. ``ops`` the (ALU-only integer,
  integer, fp32) operations per cell, or per packed word, and iteration
  that the body's function needs at least, shared by every form of it:
  a min (a packed pair's too), a logic function of up to three inputs
  or a byte permute one ALU op; an add (a packed pair's too), subtract,
  multiply(-add) or left shift one integer op, which either integer
  pipe takes; a float add or multiply one fp32 op; a shift of the block
  none. ``steps`` and
  ``elems`` the scripts' element-ops per iteration and int16 elements
  per cell (their ps per element-op); ``exact`` whether the script
  holds its output to a numpy ``want``; ``library`` one PyTorch call
  that computes the same function (a chain's: one iteration of it),
  where one exists."""
  name: str
  script: str
  case: str
  line: int
  form: str
  op: str
  shape: Tuple[int, ...]
  dtype: torch.dtype
  ops: Tuple[float, float, float]
  kshape: Optional[Tuple[int, int]] = None
  in_shape: Optional[Tuple[int, int]] = None
  taps: Tuple[Tuple[int, int], ...] = ()
  phases: Tuple[Tuple[int, Tuple[int, ...]], ...] = ()
  steps: int = 1
  elems: int = 1
  exact: bool = False
  library: Optional[Callable] = None

  @property
  def chain(self) -> bool:
    """Whether the body runs n iterations in one launch."""
    return self.form in ('ew', 'strip')

  @property
  def n_inputs(self) -> int:
    return 2 if self.form == 'binary' else 1

  @property
  def input_shape(self) -> Tuple[int, ...]:
    return self.in_shape or self.shape

  @property
  def cooperative(self) -> bool:
    """Whether the strip kernel takes a grid barrier a phase for the body
    (a strip of several phases, or of an independent one)."""
    return self.form == 'strip' and (
        len(self.phases) > 1 or any(len(p) > 2 for p in self.phases))

  @property
  def cluster(self) -> bool:
    """Whether the body runs ``strip_cluster``, fixed by its plan: a
    strip body of independent phases along the lanes (exp24's indep10)
    whose op and block the kernel is built for (``CLUSTER_FORMS``: whole
    bands, at most CLUSTER_MAX_CTAS), every tap and cross tap 1 to
    CLUSTER_MAX_DIST cells on. Any other strip body runs the strip
    kernel."""
    form = CLUSTER_FORMS.get(self.op)
    if self.form != 'strip' or form is None or not self.phases:
      return False
    band, words = form
    rows, cols = self.kshape or self.shape
    return (cols * self.dtype.itemsize == 4 * words and rows % band == 0 and
            rows // band <= CLUSTER_MAX_CTAS and
            all(len(p) > 2 and p[0] == 1 and
                all(1 <= d <= CLUSTER_MAX_DIST for d in p[1] + p[2])
                for p in self.phases))

  @property
  def barriers(self) -> probes.Barriers:
    """Grid and cluster barriers per iteration on the card: on
    ``strip_cluster``, a cluster barrier a phase with cross taps (its
    margin's exchange); else the strip kernel's (``old_barriers``)."""
    if self.cluster:
      return probes.Barriers(0, sum(bool(p[2]) for p in self.phases))
    return self.old_barriers

  @property
  def old_barriers(self) -> probes.Barriers:
    """The strip kernel's barriers, which ``launch(..., _old=True)`` runs
    for a ``strip_cluster`` body: a grid barrier a phase of a cooperative
    plan."""
    return probes.Barriers(len(self.phases) if self.cooperative else 0, 0)

  @property
  def cells(self) -> int:
    return int(np.prod(self.shape))

  def plain(self, *xs: torch.Tensor, n: int = 1) -> torch.Tensor:
    """The body's function in plain PyTorch, ``n`` iterations."""
    if self.form == 'binary':
      return _BINARY[self.op](*xs)
    if self.form == 'fold':
      x, = xs
      rows, cols = self.shape
      v = None
      for di, dj in self.taps:
        s = torch.roll(x, (-di, -dj), dims=(0, 1))[:rows, :cols]
        if v is None:
          v = s
        elif self.op == 'FoldMinI16':
          v = torch.where(s < v, s, v)
        else:
          v = (_wrap16 if x.dtype == _I16 else _wrap32)(_w(v) + _w(s))
      return v.contiguous()
    v, = xs
    if self.form == 'ew':
      for _ in range(n):
        v = _EW[self.op](v)
      return v
    step = probes._shift_step(phase_taps(self.phases), *_STRIP[self.op])
    v = v.reshape(self.kshape or self.shape)
    for _ in range(n):
      v = step(v)
    return v.reshape(self.shape).contiguous()


def _body(script, case, line, form, op, shape, dtype, ops, **kw):
  return NarrowBody('%s %s' % (script, case), script, case, line, form, op,
                    tuple(shape), dtype, tuple(float(o) for o in ops), **kw)


# a fold body's input margin along its taps' axis, past its output
MARGIN = 32


def _sliced_add(axis: int, d: int) -> Callable:
  """The library call of a two-tap add fold: two slices of x, 0 and
  ``d`` along ``axis``, added (any shape with the margin)."""
  def call(x):
    n = x.shape[axis] - MARGIN
    return torch.add(x.narrow(axis, 0, n), x.narrow(axis, d, n))
  return call


def _windowed(reduce: Callable, axis: int, taps: int, **kw) -> Callable:
  """The library call of a ``taps``-tap fold along ``axis``: ``reduce``
  over x's sliding windows (any shape with the margin)."""
  def call(x):
    n = x.shape[axis] - MARGIN
    return reduce(x.unfold(axis, taps, 1).narrow(axis, 0, n), -1, **kw)
  return call


# the least operations of a body's function (NarrowBody.ops)
_ALU, _INT = (1, 0, 0), (0, 1, 0)

# experiments/exp13_narrow_i16.py: legal_probes (:43-143), chain_time
# (:162-209, the kinds of main() :219-233)
_LANE = tuple((0, i) for i in range(19))
EXP13_LEGAL = tuple(
    _body('exp13', case, 57, 'binary', op, (256, 512), _I16, ops, exact=exact,
          library=lib)
    for case, op, ops, exact, lib in (
        ('i16 where(a<b,a,b) [cmp+select min]', 'I16WhereMin', _ALU, True,
         torch.minimum),
        ('i16 sub', 'I16Sub', _INT, True, torch.sub),
        ('i16 synth-sub a+(b^-1)+1', 'I16SynthSub', _INT, True, torch.sub),
        # (a & b) | (a ^ b) is a | b
        ('i16 and/or/xor', 'I16AndOrXor', _ALU, False, torch.bitwise_or),
        ('i16 shl/shr const', 'I16ShlShr', (1, 1, 0), True, None),
        # b + ((a - b) & -(a < b)) is min(a, b)
        ('i16 mask-min b+((a-b)&-(a<b))', 'I16MaskMin', _ALU, True,
         torch.minimum),
        # a < b: the sign of a - b
        ('i16 compare only (to bool->i16 add)', 'I16Less', (1, 1, 0), True,
         None))) + (
    _body('exp13', 'i16 lane-shifted slice add (off 3)', 57, 'fold',
          'FoldAddI16', (256, 512), _I16, _INT, in_shape=(256, 544),
          taps=((0, 0), (0, 3)), exact=True, library=_sliced_add(1, 3)),
    _body('exp13', 'i16 sublane-shifted slice add (off 5)', 57, 'fold',
          'FoldAddI16', (256, 512), _I16, _INT, in_shape=(288, 512),
          taps=((0, 0), (5, 0)), exact=True, library=_sliced_add(0, 5)),
    _body('exp13', 'i16 19-tap lane add fold', 57, 'fold', 'FoldAddI16',
          (256, 512), _I16, (0, 18, 0), in_shape=(256, 544), taps=_LANE,
          exact=True, library=_windowed(torch.sum, 1, 19, dtype=_I16)),
    _body('exp13', 'i16 19-tap lane where-min fold', 57, 'fold',
          'FoldMinI16', (256, 512), _I16, (18, 0, 0), in_shape=(256, 544),
          taps=_LANE, exact=True, library=_windowed(torch.amin, 1, 19)),
    _body('exp13', 'i16 19-tap sublane where-min fold', 57, 'fold',
          'FoldMinI16', (256, 512), _I16, (18, 0, 0), in_shape=(288, 512),
          taps=tuple((i, 0) for i in range(19)), exact=True,
          library=_windowed(torch.amin, 0, 19)),
)
_DT = {'int32': _I32, 'int16': _I16}
_STRIP_OP = {('min', 'int32'): 'MinI32', ('add', 'int32'): 'AddI32',
             ('min', 'int16'): 'MinI16', ('add', 'int16'): 'AddI16'}
EXP13_CHAIN = tuple(
    _body('exp13', '%s %s' % (kind, dt), 195, 'strip',
          _STRIP_OP[(kind.split('_')[1], dt)], (512, 2048), _DT[dt],
          _ALU if kind.endswith('min') else _INT,
          phases=((1 if kind.startswith('lane') else 0, (1,)),))
    for kind in ('lane_min', 'lane_add', 'sub_min', 'sub_add')
    for dt in ('int32', 'int16')) + (
    _body('exp13', 'lane_nmin int32', 195, 'strip', 'MinI32', (512, 2048),
          _I32, _ALU, phases=((1, (1,)),)),
    # a pair min and a byte permute (the shift by one element) a word
    _body('exp13', 'lane_swar_pk int32', 195, 'strip', 'PairMinSimd',
          (512, 1024), _I32, (2, 0, 0), phases=((1, (1,)),), elems=2),
    _body('exp13', 'lane_swar_pk int32 [bitwise]', 195, 'strip', 'Swar13',
          (512, 1024), _I32, (2, 0, 0), phases=((1, (1,)),), elems=2),
)

# experiments/exp29_pack_i16.py:242-371 (DISTS :200, rolled the
# pltpu.roll way: v[(i - d) % S])
EXP29_DISTS = (1, 2, 4, 8, 3, 1, 2, 4, 8, 3)
_ROLL10 = ((0, tuple(-d for d in EXP29_DISTS)),)
EXP29 = (
    _body('exp29', 'ew_i32', 72, 'ew', 'EwMul3Min', (256, 1024), _I32,
          (1, 1, 0)),
    _body('exp29', 'ew_i16_addxor', 72, 'ew', 'EwAddXor16', (256, 1024), _I16,
          (1, 1, 0)),
    _body('exp29', 'ew_i32_addxor', 72, 'ew', 'EwAddXor32', (256, 1024), _I32,
          (1, 1, 0)),
    _body('exp29', 'roll10_i32', 72, 'strip', 'MinI32', (256, 1024), _I32,
          (10, 0, 0), phases=_ROLL10, steps=10),
    _body('exp29', 'roll10_packed', 72, 'strip', 'PairMinSimd', (256, 512),
          _I32, (10, 0, 0), phases=_ROLL10, steps=10, elems=2),
    # a packed add
    _body('exp29', 'pack_roundtrip', 72, 'ew', 'PackRoundtrip', (256, 512),
          _I32, _INT, elems=2),
    _body('exp29', 'roll_strided', 72, 'strip', 'RollStrided', (256, 1024),
          _I32, _INT, phases=((0, (-1,)),)),
    # a 16-bit add, then a 16-bit min (a pair min on the low halves)
    _body('exp29', 'min_i16', 72, 'ew', 'MinPlusOne16', (256, 1024), _I16,
          (1, 1, 0)),
)

# experiments/exp16_swar_erosion.py: DISTS (:29) along the sublanes,
# then the lanes, the concatenate way (v[(i + d) % S])
EXP16_DISTS = (1, 2, 4, 8, 3)
_TWO_STAGE = ((0, EXP16_DISTS), (1, EXP16_DISTS))
EXP16 = (
    _body('exp16', 'wide', 76, 'strip', 'WideMinI16', (512, 2048), _I16,
          (10, 0, 0), phases=_TWO_STAGE, steps=10),
    # a pair min a step, a byte permute for each odd lane distance (1, 3)
    _body('exp16', 'swar', 126, 'strip', 'PairMinSimd', (512, 1024), _I32,
          (12, 0, 0), phases=_TWO_STAGE, steps=10, elems=2),
    _body('exp16', 'swar [bitwise]', 126, 'strip', 'Swar16', (512, 1024),
          _I32, (12, 0, 0), phases=_TWO_STAGE, steps=10, elems=2),
)

# experiments/exp12_mosaic_reprobe.py:72-179, in order
EXP12 = (
    _body('exp12', 'native i16 min', 68, 'binary', 'I16Min', (256, 512), _I16,
          _ALU, exact=True, library=torch.minimum),
    _body('exp12', 'native i16 max', 68, 'binary', 'I16Max', (256, 512), _I16,
          _ALU, exact=True, library=torch.maximum),
    _body('exp12', 'native i16 add', 68, 'binary', 'I16Add', (256, 512), _I16,
          _INT, exact=True, library=torch.add),
    _body('exp12', 'native i16 mul', 68, 'binary', 'I16Mul', (256, 512), _I16,
          _INT, exact=True, library=torch.mul),
    _body('exp12', 'native u16 min', 68, 'binary', 'U16Min', (256, 512), _I16,
          _ALU, exact=True),
    # a byte permute (a's low half, b's as the high), a shift, a logic op
    _body('exp12', 'i32 and/or/xor/shifts mix', 68, 'binary', 'I32Mix',
          (256, 512), _I32, (3, 0, 0)),
    _body('exp12', 'u32 unsigned compare select', 68, 'binary', 'U32Min',
          (256, 512), _I32, _ALU, exact=True),
    _body('exp12', 'SWAR i16x2 min (sign-bias + lane masks)', 68, 'binary',
          'SwarMinSimd', (256, 512), _I32, _ALU, exact=True, elems=2),
    _body('exp12', 'SWAR i16x2 min (sign-bias + lane masks) [bitwise]', 68,
          'binary', 'SwarMinBias', (256, 512), _I32, _ALU, exact=True,
          elems=2),
    # two masks and an add
    _body('exp12', 'SWAR i16x2 guarded add', 68, 'binary', 'SwarAddV2',
          (256, 512), _I32, (2, 1, 0), exact=True, elems=2),
    _body('exp12', 'SWAR i16x2 guarded add [bitwise]', 68, 'binary',
          'SwarAddGuard', (256, 512), _I32, (2, 1, 0), exact=True, elems=2),
) + tuple(
    _body('exp12', '%d-operand shifted add-chain' % n, 147, 'fold',
          'FoldAddI32', (256, 512), _I32, (0, n - 1, 0), in_shape=(256, 544),
          taps=tuple((0, i) for i in range(n)),
          library=_windowed(torch.sum, 1, n, dtype=_I32))
    for n in (8, 13, 16, 24)) + (
    _body('exp12', 'pltpu.roll axis=0 wide 2-D', 161, 'fold', 'RollI32',
          (256, 2048), _I32, (0, 0, 0), taps=((-3, 0),),
          library=lambda x: torch.roll(x, 3, 0)),
    _body('exp12', 'i16 load->i32 compute->i16 store', 174, 'binary',
          'I16Min', (256, 512), _I16, _ALU, exact=True,
          library=torch.minimum),
)

# experiments/exp1_value_mode.py:214-269 and exp2_diag.py:446-472 (the
# i16 probe twice), exp2's vpu_chain cases (:480-491)
_I16_OPS = (('min', 'I16Min', _ALU, torch.minimum),
            ('add', 'I16Add', _INT, torch.add),
            ('mul', 'I16Mul', _INT, torch.mul))
EXP1 = tuple(
    _body('exp1', 'i16 %s' % name, 50, 'binary', op, (32, 256), _I16, ops,
          exact=True, library=lib) for name, op, ops, lib in _I16_OPS) + tuple(
    _body('exp1', 'roll axis=%d' % axis, 76, 'fold', 'RollF32', (32, 256),
          _F32, (0, 0, 0), taps=((-3, 0),) if axis == 0 else ((0, -3),),
          exact=True, library=functools.partial(
              lambda axis, x: torch.roll(x, 3, axis), axis))
    for axis in (0, 1))
_FLAT, _CUBE = (512, 2048), (128, 32, 128)
_F32_ADD = (0, 0, 1)
EXP2_I16 = tuple(
    _body('exp2', 'i16 %s' % name, 148, 'binary', op, (32, 256), _I16, ops,
          exact=True, library=lib) for name, op, ops, lib in _I16_OPS)
EXP2_CHAIN = (
    # a multiply and an add, each rounded (--fmad=false)
    _body('exp2', 'fma float32 (512, 2048)', 87, 'ew', 'Fma32', _FLAT, _F32,
          (0, 0, 2)),
    _body('exp2', 'add int32 (512, 2048)', 87, 'ew', 'Double32', _FLAT, _I32,
          _INT, library=lambda v: torch.add(v, v)),
    _body('exp2', 'add int16 (512, 2048)', 87, 'ew', 'Double16', _FLAT, _I16,
          _INT, library=lambda v: torch.add(v, v)),
    _body('exp2', 'sublane_shift_add float32 (512, 2048)', 87, 'strip',
          'AddF32', _FLAT, _F32, _F32_ADD, phases=((0, (1,)),)),
    _body('exp2', 'sublane_roll_add float32 (512, 2048)', 87, 'strip',
          'AddF32', _FLAT, _F32, _F32_ADD, phases=((0, (-1,)),)),
    _body('exp2', 'lane_roll_add float32 (512, 2048)', 87, 'strip', 'AddF32',
          _FLAT, _F32, _F32_ADD, phases=((1, (-1,)),)),
    _body('exp2', 'major_shift_add float32 (128, 32, 128)', 87, 'strip',
          'AddF32', _CUBE, _F32, _F32_ADD, kshape=(128, 32 * 128),
          phases=((0, (1,)),)),
    _body('exp2', 'lane_roll_add float32 (128, 32, 128)', 87, 'strip',
          'AddF32', _CUBE, _F32, _F32_ADD, kshape=(128 * 32, 128),
          phases=((1, (-1,)),)),
)
BODIES: Dict[str, NarrowBody] = {
    b.name: b for b in (EXP13_LEGAL + EXP13_CHAIN + EXP29 + EXP16 + EXP12 +
                        EXP1 + EXP2_I16 + EXP2_CHAIN)}

# exp24's shift chains (probes.CHAIN_BODIES of form 'shift'), which the
# strip kernel runs for probes.chain_probe: a grid barrier for each phase
# of the script's taps (roll10's ten, indep10's one)
EXP24_SHIFT: Dict[str, NarrowBody] = {
    name: _body('exp24', name, 75, 'strip', 'MinI32', probes.SHAPE, _I32,
                (len(b.taps), 0, 0), phases=taps_phases(b.taps),
                steps=b.steps)
    for name, b in probes.CHAIN_BODIES.items() if b.form == 'shift'}


def _np_inputs(body: NarrowBody) -> Tuple[np.ndarray, ...]:
  return _script_inputs(body.script)[body.name]


@functools.lru_cache(maxsize=None)
def _script_inputs(script: str) -> Dict[str, Tuple[np.ndarray, ...]]:
  """Each body's inputs as its script makes them (its generator, seed and
  order of draws; every group of exp12 drawn, as its default run does).
  exp13's and exp2's chains run on zeros in the scripts; here they take
  seeded random blocks, so that a check can tell a wrong kernel."""
  out: Dict[str, Tuple[np.ndarray, ...]] = {}
  if script == 'exp13':
    rng = np.random.RandomState(0)
    a = rng.randint(-3000, 3000, (256, 512), np.int16)
    b = rng.randint(-3000, 3000, (256, 512), np.int16)
    wide = rng.randint(-3000, 3000, (256, 512 + 32), np.int16)
    tall = rng.randint(-3000, 3000, (256 + 32, 512), np.int16)
    for body in EXP13_LEGAL:
      out[body.name] = ((a, b) if body.form == 'binary' else
                        (wide,) if body.in_shape == (256, 544) else (tall,))
    chain = np.random.RandomState(0).randint(-3000, 3000, (512, 2048),
                                             np.int16)
    for body in EXP13_CHAIN:
      out[body.name] = ((chain.view(np.int32),) if body.elems == 2 else
                        (chain.astype(_np_dtype(body.dtype)),))
  elif script == 'exp29':
    rng = np.random.default_rng(0)
    x32 = rng.integers(-2**14, 2**14, (256, 1024), dtype=np.int32)
    x16 = x32.astype(np.int16)
    xh = rng.integers(0, 2**32, (256, 512), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    for body in EXP29:
      out[body.name] = ((xh,) if body.elems == 2 else
                        (x16,) if body.dtype == _I16 else (x32,))
  elif script == 'exp16':
    raw = np.random.RandomState(0).randint(-3000, 3000, (512, 2048), np.int16)
    for body in EXP16:
      out[body.name] = (raw.view(np.int32) if body.elems == 2 else raw,)
  elif script == 'exp12':
    rng = np.random.RandomState(0)
    a16 = rng.randint(-3000, 3000, (256, 512), np.int16)
    b16 = rng.randint(-3000, 3000, (256, 512), np.int16)
    a32, b32 = a16.astype(np.int32), b16.astype(np.int32)
    au32 = rng.randint(0, 1 << 16, (256, 512)).astype(np.uint32)
    bu32 = rng.randint(0, 1 << 16, (256, 512)).astype(np.uint32)
    packed_a = (a32 & 0xFFFF) | (b32 << 16)
    c16 = rng.randint(-3000, 3000, (256, 512), np.int16)
    d16 = rng.randint(-3000, 3000, (256, 512), np.int16)
    packed_b = (c16.astype(np.int32) & 0xFFFF) | (d16.astype(np.int32) << 16)
    small = (packed_a & 0x0FFF0FFF, packed_b & 0x0FFF0FFF)
    folds = [rng.randint(0, 100, (256, 512 + 32), np.int32)
             for _ in range(4)]
    roll = rng.randint(0, 100, (256, 2048), np.int32)
    for body in EXP12:
      if body.form == 'fold':
        out[body.name] = ((roll,) if body.op == 'RollI32' else
                          (folds.pop(0),))
      elif body.op in ('I32Mix',):
        out[body.name] = (a32, b32)
      elif body.op == 'U32Min':
        out[body.name] = (au32.view(np.int32), bu32.view(np.int32))
      elif body.op.startswith('SwarMin'):
        out[body.name] = (packed_a, packed_b)
      elif body.op.startswith('SwarAdd'):
        out[body.name] = small
      else:
        out[body.name] = (a16, b16)
  elif script in ('exp1', 'exp2'):
    rng = np.random.default_rng(0)
    x = rng.integers(-30000, 30000, (32, 256), dtype=np.int16)
    y = rng.integers(-30000, 30000, (32, 256), dtype=np.int16)
    ramp = np.arange(32 * 256, dtype=np.float32).reshape(32, 256)
    for body in (EXP1 if script == 'exp1' else EXP2_I16):
      out[body.name] = (x, y) if body.form == 'binary' else (ramp,)
    if script == 'exp2':
      rng = np.random.RandomState(0)
      for body in EXP2_CHAIN:
        if body.dtype == _F32:
          out[body.name] = (rng.uniform(-1, 1, body.shape).astype(
              np.float32),)
        else:
          out[body.name] = (rng.randint(-3000, 3000, body.shape).astype(
              _np_dtype(body.dtype)),)
  else:
    raise utils.InputError('unknown script %r' % script)
  return out


def _np_dtype(dtype: torch.dtype):
  return {_I16: np.int16, _I32: np.int32, _F32: np.float32}[dtype]


def body_inputs(body, device) -> Tuple[torch.Tensor, ...]:
  """``body``'s inputs (see ``_script_inputs``) on ``device``."""
  body = _get(body)
  return tuple(torch.from_numpy(np.array(x)).to(device)
               for x in _np_inputs(body))


def _get(body) -> NarrowBody:
  if isinstance(body, NarrowBody):
    return body
  if body not in BODIES:
    raise utils.InputError('unknown narrow body %r' % (body,))
  return BODIES[body]


# -- the kernel ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> Dict[str, object]:
  from soda_tpu_torch.backend import build
  lib = build.load_library(build.csrc_source(SOURCE))
  c = ctypes
  names = build.bind(lib, 'probe_narrow_ops', [], c.c_char_p)().decode()
  return {
      'ops': dict(zip(FORMS, ([n for n in part.split(',') if n]
                              for part in names.split(';')))),
      'launch': build.bind(lib, 'probe_narrow_launch',
                           [c.c_int, c.c_int, c.POINTER(c.c_int), c.c_int] +
                           [c.c_int] * 4 + [c.c_void_p] * 4 +
                           [c.c_longlong, c.c_void_p, c.POINTER(c.c_int)]),
      'error': build.bind(lib, 'probe_narrow_error_string', [c.c_int],
                          c.c_char_p),
      'geometry': build.bind(lib, 'probe_narrow_geometry',
                             [c.c_int, c.c_int, c.POINTER(c.c_int), c.c_int] +
                             [c.c_int] * 4 + [c.POINTER(c.c_int)]),
  }


def _check(body: NarrowBody, xs: Sequence[torch.Tensor], n: int) -> None:
  if len(xs) != body.n_inputs:
    raise utils.InputError('narrow probe %s: %d inputs, got %d' % (
        body.name, body.n_inputs, len(xs)))
  for x in xs:
    if tuple(x.shape) != body.input_shape or x.dtype != body.dtype or \
        not x.is_contiguous():
      raise utils.InputError('narrow probe %s: contiguous %s blocks of %s, '
                             'got %s %s' % (body.name, body.dtype,
                                            body.input_shape, x.dtype,
                                            tuple(x.shape)))
    if x.device != xs[0].device:
      raise utils.InputError('narrow probe %s: inputs on one device' %
                             body.name)
  if n < 1 or (n > 1 and not body.chain):
    raise utils.InputError('narrow probe %s: n >= 1 (1 for a one-shot body), '
                           'got %d' % (body.name, n))


def launch_geometry(body: NarrowBody) -> Tuple[List[int], int, int, int,
                                                 int]:
  """(args, rows, cols, in_rows, in_cols) of ``body``'s launch: a fold's
  taps (row, lane offset each), a strip's phases (axis, whether
  independent, steps, the steps' distances, cross taps, their distances
  each); the block the kernel walks; a fold's input."""
  rows, cols = body.kshape or body.shape
  if body.form == 'fold':
    return ([v for tap in body.taps for v in tap], rows, cols,
            *body.input_shape)
  args: List[int] = []
  for axis, dists, *cross in body.phases:
    indep, cross = int(bool(cross)), (cross[0] if cross else ())
    args += [axis, indep, len(dists), *dists, len(cross), *cross]
  return args, rows, cols, rows, cols


def narrow_probe(body, *xs: torch.Tensor, n: int = 1,
                 ctas: Optional[List[int]] = None) -> torch.Tensor:
  """``body`` (a NarrowBody or its name) on its inputs ``xs``, ``n``
  iterations of a chain: the narrow probe kernel for CUDA tensors, its
  plain version for CPU tensors. ``ctas``, a list, receives the
  kernel's grid size."""
  body = _get(body)
  _check(body, xs, n)
  device = xs[0].device
  if device.type == 'cpu':
    return body.plain(*xs, n=n)
  if device.type != 'cuda':
    raise utils.InputError('narrow probe: cpu or cuda tensors, got %s' %
                           device)
  y = launch(body, xs, n, ctas)
  probes.LAUNCHES[(KERNEL, body.name)] += 1
  return y


def launch(body: NarrowBody, xs: Sequence[torch.Tensor], n: int,
           ctas: Optional[List[int]] = None,
           _old: bool = False) -> torch.Tensor:
  """One launch of ``body``'s kernel on the CUDA tensors ``xs`` (checked
  by the caller, which counts the launch), on the current stream; a
  refused launch raises (nothing falls back). ``_old`` (a one-shot or
  ``strip_cluster`` body; private to the tests, chip_smoke.py and
  ``narrow_oneshot``): the old form of its kernel, for comparisons (a
  ``strip_cluster`` body's: the strip kernel, a grid barrier a phase)."""
  form = FORMS.index(body.form)
  if _old:
    if body.form not in OLD_FORMS and not body.cluster:
      raise utils.InputError('narrow probe %s: no old form of a %s body' % (
          body.name, body.form))
    form = OLD_FORMS.get(body.form, form)
  elif body.cluster:
    form = CLUSTER_FORM
  device = xs[0].device
  lib = _lib()
  op = lib['ops'][body.form].index(body.op)
  flat, rows, cols, in_rows, in_cols = launch_geometry(body)
  args = (ctypes.c_int * max(len(flat), 1))(*flat)
  y = torch.empty(body.shape, dtype=body.dtype, device=device)
  tmp = (torch.empty_like(y) if body.cooperative and form != CLUSTER_FORM
         else None)
  b = xs[1].data_ptr() if body.n_inputs == 2 else None
  grid = ctypes.c_int(0)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream().cuda_stream
    status = lib['launch'](form, op, args, len(flat), rows,
                           cols, in_rows, in_cols, xs[0].data_ptr(), b,
                           y.data_ptr(),
                           tmp.data_ptr() if tmp is not None else None, n,
                           stream, ctypes.byref(grid))
  if status:
    raise RuntimeError('narrow probe kernel (%s) failed to launch: %s' % (
        body.name, lib['error'](status).decode()))
  if ctas is not None:
    ctas.append(grid.value)
  return y


def check_iters(body: NarrowBody, n_small: Optional[int] = None
                ) -> Tuple[int, ...]:
  """The iterations at which a kernel is held to its plain version: a
  chain's at probes.CHECK_ITERS (a register chain's also at a trip of
  its main loop and a rest) and ``n_small`` where given."""
  if not body.chain:
    return (1,)
  main = (EW_UNROLL + 5,) if body.form == 'ew' else ()
  return probes.CHECK_ITERS + main + ((n_small,) if n_small else ())


def narrow_check(body, xs: Sequence[torch.Tensor], iters: Sequence[int],
                 ctas: Optional[List[int]] = None) -> Tuple[float, float]:
  """(largest absolute, largest relative) difference of ``narrow_probe``
  from the plain version over ``iters`` iterations each."""
  body = _get(body)
  errs = [probes.max_error(narrow_probe(body, *xs, n=n, ctas=ctas),
                           body.plain(*xs, n=n)) for n in iters]
  return max(e[0] for e in errs), max(e[1] for e in errs)


def narrow_ok(body, abs_err: float, rel_err: float) -> bool:
  """Integers bit for bit; float32 within probes.CHAIN_RTOL relative."""
  if _get(body).dtype.is_floating_point:
    return rel_err <= probes.CHAIN_RTOL
  return abs_err == 0


# -- bounds and SASS ---------------------------------------------------------

def within_bound(bound: float, ms: float) -> bool:
  """Whether a time of ``ms`` can be right beside a bound of ``bound``
  ms: a share of at most MAX_SHARE."""
  return bound / ms <= MAX_SHARE


def ops_ms(ops: Sequence[float], cells: int, sms: int,
           clock_hz: float) -> float:
  """Least milliseconds for ``ops`` (ALU-only integer, integer, fp32; see
  NarrowBody) on each of ``cells`` cells on ``sms`` SMs at ``clock_hz``:
  the ALU-only ops over the ALU's lanes, all integer ops over both
  integer pipes', the fp32 ops over the fp32 lanes, whichever is
  longest."""
  alu, integer, fp32 = ops
  lane_cycles = max(alu / probes.UNIT_LANES['int32'],
                    (alu + integer) / INT_ANY_LANES,
                    fp32 / probes.UNIT_LANES['fp32'])
  return lane_cycles * cells / (sms * clock_hz) * 1e3


def cells_read(body) -> int:
  """Input cells a one-shot body reads: a fold's, the box its taps span
  in its input (the whole input where they wrap round it)."""
  body = _get(body)
  if body.form != 'fold':
    return body.n_inputs * int(np.prod(body.input_shape))
  span = 1
  for k, (out, size) in enumerate(zip(body.shape, body.input_shape)):
    offs = [tap[k] % size for tap in body.taps]
    span *= min(size, out + max(offs) - min(offs))
  return span


def bound_ms(body, sms: int, clock_hz: float) -> Tuple[float, str]:
  """(least milliseconds, 'bytes' or 'operations'): a chain's per
  iteration, its operations (``ops_ms``); a one-shot body's for the
  launch, the larger of that and its bytes (the cells it reads, once,
  and its output, written once, at the spec memory rate)."""
  body = _get(body)
  by_ops = ops_ms(body.ops, body.cells, sms, clock_hz)
  if body.chain:
    return by_ops, 'operations'
  cells = cells_read(body) + body.cells
  by_bytes = (cells * body.dtype.itemsize / profiling.H100_BYTES_PER_S *
              1e3)
  return (by_bytes, 'bytes') if by_bytes >= by_ops else (by_ops, 'operations')


# each form's kernel template in the source (the default one; the old
# one-shot forms keep their form's name)
KERNEL_NAMES = {'binary': 'vec_binary', 'ew': 'ew', 'fold': 'tile_fold',
                'strip': 'strip'}
CLUSTER = 'strip_cluster'  # the kernel of a ``NarrowBody.cluster`` body


def _mangled_op(kernel: str, op: str) -> str:
  """What the entry of ``op``'s kernel has in its mangled name: the
  template's identifier and the op's, each after its length."""
  return '%d%s' % (len(kernel), kernel), '%d%s' % (len(op), op)


def parse_listing(text: str) -> Dict[str, List[Tuple[int, str, str]]]:
  """``cuobjdump -sass`` output -> entry name -> its instructions, each
  (address, opcode with its modifiers, as in
  SYNCS.PHASECHK.TRANS64.TRYWAIT, operands); predicated instructions
  included."""
  out: Dict[str, List[Tuple[int, str, str]]] = {}
  current = None
  for line in text.splitlines():
    found = re.search(r'Function : (\S+)', line)
    if found:
      current = out.setdefault(found.group(1), [])
      continue
    found = re.match(r'\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?'
                     r'([A-Z][A-Z0-9_]*(?:\.\w+)*)([^;]*)', line)
    if found and current is not None:
      current.append((int(found.group(1), 16), found.group(2),
                      found.group(3).strip()))
  return out


def base_opcode(op: str) -> str:
  """An opcode with its modifiers dropped but a packed type's, as in
  VIMNMX.S16x2."""
  head, *mods = op.split('.')
  return '.'.join([head] + [m for m in mods if '16x2' in m])


def parse_sass(text: str) -> Dict[str, collections.Counter]:
  """``cuobjdump -sass`` output -> entry name -> base opcode counts."""
  return {entry: collections.Counter(base_opcode(op) for _, op, _ in listing)
          for entry, listing in parse_listing(text).items()}


def main_loop(listing: Sequence[Tuple[int, str, str]]
              ) -> List[Tuple[int, str, str]]:
  """The instructions of an entry's largest loop: from a backward
  branch's target to the branch."""
  best: List[Tuple[int, str, str]] = []
  for addr, op, operands in listing:
    target = re.search(r'0x([0-9a-f]+)', operands)
    if (base_opcode(op) == 'BRA' and target and
        int(target.group(1), 16) < addr):
      loop = [i for i in listing if int(target.group(1), 16) <= i[0] <= addr]
      best = max(best, loop, key=len)
  return best


def cuobjdump_sass(source) -> str:
  """``cuobjdump -sass`` of the library built from ``source`` (a
  KernelSource; built first if need be), with the cuobjdump beside
  nvcc."""
  from soda_tpu_torch.backend import build
  lib_path = build.build(source)
  cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), 'cuobjdump')
  return subprocess.run([cuobjdump, '-sass', str(lib_path)], check=True,
                        stdout=subprocess.PIPE, text=True).stdout


@functools.lru_cache(maxsize=None)
def sass_report(old: bool = False) -> Dict[Tuple[str, str],
                                           Dict[str, object]]:
  """(form, op) -> {'opcodes': counts, 'total', 'loop' (instructions of
  its largest loop), 'registers', 'spills' (bytes stored and loaded)} of
  each kernel as built: ``cuobjdump -sass`` of the library beside nvcc,
  and the ``-Xptxas -v`` report; (CLUSTER, op) too for each op of
  CLUSTER_FORMS. ``old``: the old one-shot forms' kernels
  (``OLD_FORMS``) in place of the default ones."""
  from soda_tpu_torch.backend import build
  source = build.csrc_source(SOURCE)
  listings = parse_listing(cuobjdump_sass(source))
  ptxas = build.ptxas_report(source)
  out = {}
  for form, ops in _lib()['ops'].items():
    if old and form not in OLD_FORMS:
      continue
    marks = {(form, op): _mangled_op(form if old else KERNEL_NAMES[form],
                                     op) for op in ops}
    if form == 'strip' and not old:
      # strip_cluster<rows a band, words a row>, one build an op
      marks.update({(CLUSTER, op): ('%d%s' % (len(CLUSTER), CLUSTER),
                                    'ILi%dELi%dE' % CLUSTER_FORMS[op])
                    for op in ops if op in CLUSTER_FORMS})
    for key, mark in marks.items():
      entries = [e for e in listings if all(m in e for m in mark)]
      regs = [r for e, r in ptxas.items() if all(m in e for m in mark)]
      if len(entries) != 1 or len(regs) != 1:
        raise RuntimeError('narrow probe: %d SASS and %d ptxas entries for '
                           '%s %s' % (len(entries), len(regs), *key))
      listing = listings[entries[0]]
      counts = collections.Counter(base_opcode(o) for _, o, _ in listing)
      out[key] = {
          'opcodes': counts, 'total': sum(counts.values()),
          'loop': len(main_loop(listing)),
          'registers': regs[0]['registers'],
          'spills': regs[0]['spill_stores'] + regs[0]['spill_loads']}
  return out


def sass_key(body, old: bool = False) -> Tuple[str, str]:
  """``sass_report(old)``'s key of the kernel ``body`` runs."""
  body = _get(body)
  return (CLUSTER if body.cluster and not old else body.form, body.op)


def sass_line(body, old: bool = False) -> str:
  """A body's kernel as the card runs it: registers, spilled bytes,
  instructions, the count of each of SASS_OPS it has, and for a
  register chain its main loop's instructions a trip (EW_UNROLL
  iterations). ``old``: a one-shot body's old form."""
  body = _get(body)
  rep = sass_report(old)[sass_key(body, old)]
  ops = ' '.join('%s %d' % (op, rep['opcodes'][op]) for op in SASS_OPS
                 if rep['opcodes'][op])
  loop = ('; main loop %d instrs for %d iterations' % (rep['loop'], EW_UNROLL)
          if body.form == 'ew' else '')
  return 'regs %d, spills %d B, %d instrs: %s%s' % (
      rep['registers'], rep['spills'], rep['total'], ops, loop)


# the SASS opcodes that carry an op under test: a scalar integer min
# (IMNMX, sm_90's VIMNMX) and the packed pair min and add, which ptxas
# also uses for one 16-bit min (the old binary where-min) and which a
# packed body asks for
KEY_OPS = ('IMNMX', 'VIMNMX', 'VIMNMX.S16x2', 'VIADD.16x2')
PACKED_OPS = ('VIMNMX.S16x2', 'VIADD.16x2')


def key_ops(body, old: bool = False) -> Dict[str, int]:
  """The count of each of KEY_OPS a body's kernel has (``old``: its old
  form's), those it has none of left out."""
  body = _get(body)
  counts = sass_report(old)[sass_key(body, old)]['opcodes']
  return {op: counts[op] for op in KEY_OPS if counts[op]}


def key_ops_kept(body) -> bool:
  """Whether a one-shot body's default kernel keeps its old form's key
  ops in kind: a packed op where the old form has one and nowhere else
  (no scalar op merged into a packed one), and each scalar one the old
  form has. (Its own index arithmetic may add a scalar min.)"""
  new, old = key_ops(body), key_ops(body, old=True)
  return ({op for op in new if op in PACKED_OPS} ==
          {op for op in old if op in PACKED_OPS} and set(old) <= set(new))


def geometry(body) -> Dict[str, int]:
  """A one-shot body's default launch as the card would make it, its
  pointers 16-byte aligned: 'ctas_per_sm' (resident at once), 'smem'
  (dynamic shared memory bytes), 'grid', and a fold's 'tile_rows' (a
  binary body's whole 16-byte 'vectors'). A fold whose box passes shared
  memory raises."""
  body = _get(body)
  if body.chain:
    raise utils.InputError('narrow probe %s: geometry of one-shot bodies '
                           'only' % body.name)
  lib = _lib()
  flat, rows, cols, in_rows, in_cols = launch_geometry(body)
  args = (ctypes.c_int * max(len(flat), 1))(*flat)
  out = (ctypes.c_int * 4)()
  status = lib['geometry'](FORMS.index(body.form),
                           lib['ops'][body.form].index(body.op), args,
                           len(flat), rows, cols, in_rows, in_cols, out)
  if status:
    raise RuntimeError('narrow probe kernel (%s): no launch: %s' % (
        body.name, lib['error'](status).decode()))
  last = 'tile_rows' if body.form == 'fold' else 'vectors'
  return dict(zip(('ctas_per_sm', 'smem', 'grid', last), out))


def ew_loop_holds_every_iteration(body) -> bool:
  """Whether a register chain's main loop holds, for each of its
  EW_UNROLL iterations, at least the instructions of the body's least
  operations (none folded into another), and a branch."""
  body = _get(body)
  return sass_report()[('ew', body.op)]['loop'] >= (
      EW_UNROLL * sum(body.ops) + 1)


# -- the entry points' common run ----------------------------------------------

# a one-shot body's cold-L2 calls (their median the cold ms; 20 before
# the replayed times took their place, cut to keep chip_smoke.py's phase
# 17 inside its time)
COLD_REPS = 5
SETTLE_S = 0.1  # seconds of a one-shot body's calls before it is replayed


def run_bodies(bodies: Sequence[NarrowBody], device='cuda', n_small: int = 32,
               n_big: int = 512, log: Callable[[str], None] = print,
               reps: int = 5) -> List[Dict[str, object]]:
  """Each body on its script's inputs. On the card: the kernel against
  its plain version (a chain at CHECK_ITERS and ``n_small``
  iterations), its time (a one-shot body's device µs a call replayed
  from a CUDA graph, and its library call's, the time with no host
  between calls; further, its cold-L2 median ms, and the host's and the
  device's µs a call back to back from Python, which read the wrapper's
  enqueue; a chain's µs per iteration, the slope from ``n_small`` to
  ``n_big``),
  ps per element-op, grid barriers, the bound and its share, the plain
  version's time, the library call's (a chain's: one call, one
  iteration), the SASS row. A body fails where its kernel differs from
  its plain version, or its share of the bound exceeds MAX_SHARE. On
  the CPU: the plain version at one iteration, of the body's shape and
  type, and finite. One line per body; returns a row per body."""
  device = probes._device(device)
  rows = []
  if device.type == 'cuda':
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = profiling.max_sm_clock_hz()
  for body in bodies:
    xs = body_inputs(body, device)
    row = {'body': body.name, 'barriers': body.barriers, 'ops': body.ops,
           'chain': body.chain}
    rows.append(row)
    if device.type == 'cpu':
      got = narrow_probe(body, *xs)
      row['ok'] = ok = (tuple(got.shape) == body.shape and
                        got.dtype == body.dtype and
                        bool(torch.isfinite(got.to(torch.float64)).all()))
      log('%-52s plain %s; %d grid barriers/iter on the card; least ops '
          'per %s: ALU %g, integer %g, fp32 %g' % (
              body.name, 'OK' if ok else 'WRONG', body.barriers.grid,
              'word' if body.elems == 2 else 'cell', *body.ops))
      continue
    ctas: List[int] = []
    abs_err, rel_err = narrow_check(body, xs, check_iters(body, n_small),
                                    ctas)
    bound, bound_by = bound_ms(body, sms, clock_hz)
    lib_ms = None
    if body.chain:
      us = probes.slope_us(lambda n: narrow_probe(body, *xs, n=n), n_small,
                           n_big, reps)
      ms = us / 1e3
      plain_ms = profiling.cuda_times_ms(
          lambda: body.plain(*xs, n=n_small), reps=1, warmup=0)[0] / n_small
      if body.library is not None:
        lib_ms = probes.warm_ms(lambda: body.library(*xs))
      per_op = us * 1e6 / (body.cells * body.elems * body.steps)
      timing = '%9.3f us/iter  %8.3f ps/elem-op' % (us, per_op)
    else:
      ms = statistics.median(profiling.cuda_times_ms(
          lambda: narrow_probe(body, *xs), reps=COLD_REPS))
      plain_ms = statistics.median(profiling.cuda_times_ms(
          lambda: body.plain(*xs), reps=5))
      if body.library is not None:
        lib_ms = statistics.median(profiling.cuda_times_ms(
            lambda: body.library(*xs), reps=COLD_REPS))
      row['host_us'], row['b2b_us'] = profiling.back_to_back_us(
          lambda: narrow_probe(body, *xs))
      # the device alone: replayed from one CUDA graph after a settle run
      # (the timing launches are not counted)
      kernel = lambda: launch(body, xs, 1)
      profiling.settle(kernel, SETTLE_S)
      row['replay_us'] = profiling.replay_us(kernel)
      row['library_replay_us'] = (
          profiling.replay_us(lambda: body.library(*xs))
          if body.library is not None else None)
      per_op = row['replay_us'] * 1e6 / (body.cells * body.elems)
      timing = ('%9.3f us a call replayed (library %s; cold %.4f ms; back '
                'to back: host %.1f, device %.1f us a call)  %8.3f '
                'ps/elem' % (row['replay_us'], '%.3f us' % row[
                    'library_replay_us'] if lib_ms is not None else 'none',
                             ms, row['host_us'], row['b2b_us'], per_op))
    right = narrow_ok(body, abs_err, rel_err)
    ok = right and within_bound(bound, ms)
    row.update(ok=ok, ms=ms, bound_ms=bound, bound_by=bound_by,
               plain_ms=plain_ms, library_ms=lib_ms, abs_err=abs_err,
               rel_err=rel_err, ctas=ctas[0], sass=sass_line(body))
    verdict = (('PASS (exact)' if body.exact else 'PASS') if ok else
               'WRONG' if not right else 'OVER ITS BOUND')
    log('%-52s %s  %d barriers/iter  bound %.4g %s (%s, share %.3f)  plain '
        '%.4g ms  library %s  %d CTAs  max err %.3g (rel %.3g)  %s  [%s]' % (
            body.name, timing, body.barriers.grid,
            bound * (1e3 if body.chain else 1),
            'us' if body.chain else 'ms', bound_by, bound / ms, plain_ms,
            '%.4f ms' % lib_ms if lib_ms is not None else 'none', ctas[0],
            abs_err, rel_err, verdict, row['sass']))
  return rows
