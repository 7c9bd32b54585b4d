"""exp32's copy-shift probe: its kernel, its plain versions and bounds.

One hand-written CUDA source, ``csrc/probe_copy.cu`` (``copy_probe``),
replaces the Pallas probes of experiments/exp32_dma_shift.py:81
(``_pallas``, built by ``make_dma_chain``, ``make_store_chain`` and
``make_overlap_chain``) and :226 (``make_fan_chain``): shared memory
copied into shared memory at an offset by the bulk-copy engine
(``cp.async.bulk`` with ``mbarrier`` completion), used as a shift. The
script's rotate baseline (``make_rot_chain``, :153) runs in the narrow
probe's strip kernel (``csrc/probe_narrow.cu``): its threads' offset
shared-memory reads are the other engine.

Each ``CopyCase`` is a case of the script's ``main()`` or ``check()``:
its tag there, its kind (``store``, ``rotate``, ``copy``, ``overlap``,
``fan``), the copy's axis, the distances of an iteration's steps (the
store control's xor keys), its line. The plain versions are the script's
NumPy oracles in torch, stale tail included: b starts as x, and a copy of
``copy_len`` rows or lanes overwrites only b's start.

``copy_probe`` launches the kernel for a CUDA tensor (raising if CUDA
refuses) and runs the plain version only for a CPU tensor; each launch
adds one to ``probes.LAUNCHES[('probe_copy', case name)]`` (a rotate
control's to ``('probe_narrow', 'exp32 <name>')``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from soda_tpu_torch import utils
from soda_tpu_torch.experiments import narrow, probes

SOURCE = 'probe_copy.cu'
KERNEL = 'probe_copy'  # probes.LAUNCHES' key: (KERNEL, case name)
SCRIPT = 'exp32_dma_shift'
# experiments/exp32_dma_shift.py:43-48
SHAPE = probes.SHAPE
SUB_DISTS = (1, 3, 8)
LANE_DISTS = (1, 8, 128)
FAN_DISTS = (1, 3, 6, 9)
STORE_KEYS = (0, 1, 2, 3, 4)
CHECK_N = 3  # check()'s iterations
# the kernel's kinds, in the source's order (a rotate control is none)
KINDS = ('store', 'copy', 'overlap', 'fan')
# shared memory's rate: bytes a clock an SM (Hopper: 32 banks of 4 bytes)
SMEM_BYTES_PER_CLOCK = 128
# a thread's cell slots: probe_copy.cu's kMaxPer
CELL_SLOTS = 8
_I32 = torch.int32


def copy_len(shape: Tuple[int, int], axis: int) -> int:
  """Rows (axis 0) or lanes (axis 1) a copy moves: the script's
  ``ROWS_CP`` (rows - 16, room for d <= 16) and ``COLS_CP`` (lanes - 128)
  at ``shape``."""
  return shape[0] - 16 if axis == 0 else shape[1] - 128


@dataclasses.dataclass(frozen=True)
class CopyCase:
  """One case of exp32: its tag in the script (a check case: the
  assertion's), its kind, the copy's axis (0: rows, 1: lanes), the
  distances of an iteration's steps (the store control's xor keys; a
  fan's four copies of one step), the script's ``steps`` (its slots per
  step divisor), and the line of the ``pallas_call`` it replaces."""
  name: str
  kind: str
  axis: int
  dists: Tuple[int, ...]
  steps: int
  line: int

  @property
  def engine(self) -> str:
    """What moves the shifted cells on the card."""
    return {'store': 'threads (st/ld.shared, no copy)',
            'rotate': 'strip kernel (threads\' offset shared reads)'}.get(
                self.kind, 'bulk copy (cp.async.bulk + mbarrier)')


def _case(name, kind, axis, dists, steps=None, line=81):
  return CopyCase(name, kind, axis, tuple(dists),
                  len(dists) if steps is None else steps, line)


# experiments/exp32_dma_shift.py:316-329, in order
MAIN_CASES = (
    (_case('store5', 'store', 0, STORE_KEYS),
     _case('rot5_sub_d3', 'rotate', 0, (3,) * 5, line=153),
     _case('rot5_lane_d8', 'rotate', 1, (8,) * 5, line=153)) +
    tuple(_case('dma5_sub_d%d' % d, 'copy', 0, (d,) * 5) for d in SUB_DISTS) +
    tuple(_case('dma5_lane_d%d' % d, 'copy', 1, (d,) * 5)
          for d in LANE_DISTS) +
    (_case('dmaover5_d3', 'overlap', 0, (3,) * 5),
     _case('dmafan4_sub', 'fan', 0, FAN_DISTS, line=226)))
# check() (:272-290): one distance an iteration, the fan, the overlap
CHECK_CASES = (
    tuple(_case('check sub d=%d' % d, 'copy', 0, (d,)) for d in SUB_DISTS) +
    tuple(_case('check lane d=%d' % d, 'copy', 1, (d,)) for d in LANE_DISTS) +
    (_case('check fan', 'fan', 0, FAN_DISTS, line=226),
     _case('check overlap', 'overlap', 0, (3,) * 5)))
CASES: Dict[str, CopyCase] = {c.name: c for c in MAIN_CASES + CHECK_CASES}


def rotate_body(case: CopyCase) -> narrow.NarrowBody:
  """A rotate control as a strip body: one chained phase of its five
  shifted mins along its axis (a CTA holds whole lines, as the copy
  kernel's do; no grid barrier), exp24's ``--dists`` function
  (``probes._shift_body(..., _chained([(axis, d)] * 5), 5)``) on the same
  block."""
  return narrow._body('exp32', case.name, case.line, 'strip', 'MinI32', SHAPE,
                      _I32, (len(case.dists), 0, 0),
                      phases=((case.axis, case.dists),), steps=case.steps)


ROTATE: Dict[str, narrow.NarrowBody] = {
    c.name: rotate_body(c) for c in MAIN_CASES if c.kind == 'rotate'}


def copy_input(seed: int, device) -> torch.Tensor:
  """The script's block: ``RandomState(0).randint(-30000, 30000, SHAPE,
  np.int32)`` for the timed run (main), ``RandomState(7).randint(-30000,
  30000, SHAPE).astype(np.int32)`` for check()."""
  rng = np.random.RandomState(seed)
  if seed == 0:
    x = rng.randint(-30000, 30000, SHAPE, np.int32)
  else:
    x = rng.randint(-30000, 30000, SHAPE).astype(np.int32)
  return torch.from_numpy(x).to(device)


def _get(case) -> CopyCase:
  if isinstance(case, CopyCase):
    return case
  if case not in CASES:
    raise utils.InputError('unknown exp32 case %r (one of %s)' % (
        case, ', '.join(CASES)))
  return CASES[case]


# -- the plain versions: the script's NumPy oracles in torch -----------------

def dma_chain_plain(x: torch.Tensor, dists, axis: int, n: int) -> torch.Tensor:
  """``np_dma_chain`` (:235): each step copies a[d:d+CP] (a = v) to
  b[0:CP] along ``axis``, b starting as x and keeping its tail, and takes
  v = min(v, b)."""
  cp = copy_len(tuple(x.shape), axis)
  v, b = x.clone(), x.clone()
  for _ in range(n):
    for d in dists:
      a = v
      if axis == 0:
        b[0:cp] = a[d:d + cp]
      else:
        b[:, 0:cp] = a[:, d:d + cp]
      v = torch.minimum(v, b)
  return v


def fan_chain_plain(x: torch.Tensor, dists, n: int) -> torch.Tensor:
  """``np_fan_chain`` (:248): one store, a copy of a[d:d+CP] rows into
  each distance's slab (each starting as x), then the min over them."""
  cp = copy_len(tuple(x.shape), 0)
  v = x.clone()
  dst = [x.clone() for _ in dists]
  for _ in range(n):
    a = v
    for j, d in enumerate(dists):
      dst[j][0:cp] = a[d:d + cp]
    for j in range(len(dists)):
      v = torch.minimum(v, dst[j])
  return v


def _chain_b(vb: torch.Tensor) -> torch.Tensor:
  """Chain B's step: vb = min(vb, vb ^ 0x5A5A); vb += vb >> 3 (int32
  wrapping)."""
  vb = torch.minimum(vb, vb ^ 0x5A5A)
  return narrow._wrap32(narrow._w(vb) + (narrow._w(vb) >> 3))


def overlap_chain_plain(x: torch.Tensor, dists, n: int) -> torch.Tensor:
  """``np_overlap_chain`` (:260): chain A as ``dma_chain_plain`` along the
  rows, chain B's register step beside each of its steps; va ^ vb."""
  cp = copy_len(tuple(x.shape), 0)
  va, vb, b = x.clone(), x.clone(), x.clone()
  for _ in range(n):
    for d in dists:
      a = va
      vb = _chain_b(vb)
      b[0:cp] = a[d:d + cp]
      va = torch.minimum(va, b)
  return va ^ vb


def store_chain_plain(x: torch.Tensor, keys, n: int) -> torch.Tensor:
  """``make_store_chain``'s function (:117): a = v ^ k; v = min(v, a),
  for each key k, n times."""
  v = x
  for _ in range(n):
    for k in keys:
      v = torch.minimum(v, v ^ k)
  return v


def copy_plain(case, x: torch.Tensor, n: int) -> torch.Tensor:
  """``case``'s function in plain PyTorch, ``n`` iterations."""
  case = _get(case)
  if case.kind == 'store':
    return store_chain_plain(x, case.dists, n)
  if case.kind == 'rotate':
    return ROTATE[case.name].plain(x, n=n)
  if case.kind == 'copy':
    return dma_chain_plain(x, case.dists, case.axis, n)
  if case.kind == 'overlap':
    return overlap_chain_plain(x, case.dists, n)
  return fan_chain_plain(x, case.dists, n)


# -- the kernel ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> Dict[str, object]:
  from soda_tpu_torch.backend import build
  lib = build.load_library(build.csrc_source(SOURCE))
  c = ctypes
  return {
      'launch': build.bind(lib, 'probe_copy_launch',
                           [c.c_int, c.c_int, c.POINTER(c.c_int), c.c_int,
                            c.c_int, c.c_int, c.c_int, c.c_void_p,
                            c.c_void_p, c.c_longlong, c.c_void_p,
                            c.POINTER(c.c_int)]),
      'error': build.bind(lib, 'probe_copy_error_string', [c.c_int],
                          c.c_char_p),
  }


def _check(case: CopyCase, x: torch.Tensor, n: int) -> None:
  if x.dim() != 2 or x.dtype != _I32 or not x.is_contiguous():
    raise utils.InputError('copy probe %s: a contiguous 2-D int32 block, got '
                           '%s %s' % (case.name, x.dtype, tuple(x.shape)))
  if case.kind == 'rotate' and tuple(x.shape) != SHAPE:
    raise utils.InputError('copy probe %s: the strip kernel runs it on %s, '
                           'got %s' % (case.name, SHAPE, tuple(x.shape)))
  if case.kind not in ('store', 'rotate'):
    len_ = x.shape[case.axis]
    cp = copy_len(tuple(x.shape), case.axis)
    if cp < 1 or max(case.dists) + cp > len_:
      raise utils.InputError('copy probe %s: copies of %d from distances %s '
                             'leave a block of %s' % (
                                 case.name, cp, case.dists, tuple(x.shape)))
  if n < 1:
    raise utils.InputError('copy probe: n >= 1, got %d' % n)


def copy_probe(case, x: torch.Tensor, n: int,
               ctas: Optional[List[int]] = None) -> torch.Tensor:
  """``case`` (a CopyCase or its name), ``n`` iterations on the int32
  block ``x``: the copy-shift kernel (a rotate control: the narrow
  probe's strip kernel) for a CUDA tensor, its plain version for a CPU
  tensor. ``ctas``, a list, receives the kernel's grid size."""
  case = _get(case)
  _check(case, x, n)
  if x.device.type == 'cpu':
    return copy_plain(case, x, n)
  if x.device.type != 'cuda':
    raise utils.InputError('copy probe: a cpu or cuda tensor, got %s' %
                           x.device)
  if case.kind == 'rotate':
    return narrow.narrow_probe(ROTATE[case.name], x, n=n, ctas=ctas)
  lib = _lib()
  args = (ctypes.c_int * len(case.dists))(*case.dists)
  rows, cols = x.shape
  y = torch.empty_like(x)
  grid = ctypes.c_int(0)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = lib['launch'](KINDS.index(case.kind), case.axis, args,
                           len(case.dists), rows, cols,
                           copy_len((rows, cols), case.axis), x.data_ptr(),
                           y.data_ptr(), n, stream, ctypes.byref(grid))
  if status:
    raise RuntimeError('copy probe kernel (%s) failed to launch: %s' % (
        case.name, lib['error'](status).decode()))
  probes.LAUNCHES[(KERNEL, case.name)] += 1
  if ctas is not None:
    ctas.append(grid.value)
  return y


def copy_check(case, x: torch.Tensor, iters, ctas: Optional[List[int]] = None
               ) -> float:
  """Largest absolute difference of ``copy_probe`` from ``copy_plain``
  over ``iters`` iterations each."""
  case = _get(case)
  return max(probes.max_error(copy_probe(case, x, n, ctas),
                              copy_plain(case, x, n))[0]
             for n in iters)


# -- bounds and SASS ---------------------------------------------------------

def counts(case, shape: Tuple[int, int] = SHAPE
           ) -> Tuple[Tuple[float, float, float], float]:
  """(least operations per cell and iteration as narrow.NarrowBody.ops
  counts them: ALU-only integer, integer, fp32; least shared-memory bytes
  per cell and iteration) of ``case``'s function on a ``shape`` block, one
  count for every form of it. A rotate step: a min, and a store and an
  offset read of every cell (8 bytes: it wraps). A copy step (chain A of
  the overlap too): a min, and a store and a read of the copied lines
  alone (8 bytes a cell of ``copy_len`` of the axis' lines: b's tail
  keeps x, which the kernel holds in registers); the fan a step: one
  store of the lines its copies read (rows ``min(d)`` to
  ``max(d) + copy_len``), four reads of ``copy_len`` rows and four mins;
  the overlap's chain B an xor and a min (the ALU) and a shift-add (one
  LEA, either integer pipe's at best) a step; the store control an xor
  and a min a key, none for key 0 (its step is the identity), and no
  shared memory (the function needs none)."""
  case = _get(case)
  steps = len(case.dists)
  if case.kind == 'store':
    return (2.0 * sum(1 for k in case.dists if k), 0.0, 0.0), 0.0
  if case.kind == 'rotate':
    return (float(steps), 0.0, 0.0), 8.0 * steps
  cp, len_ = copy_len(shape, case.axis), shape[case.axis]
  if case.kind == 'fan':
    stored = max(case.dists) + cp - min(case.dists)
    return (float(steps), 0.0, 0.0), (16.0 * cp + 4.0 * stored) / len_
  copied = 8.0 * cp / len_ * steps
  if case.kind == 'overlap':
    return (3.0 * steps, 1.0 * steps, 0.0), copied
  return (float(steps), 0.0, 0.0), copied


def bound_ms(case, sms: int, clock_hz: float,
             shape: Tuple[int, int] = SHAPE) -> Tuple[float, str]:
  """(least milliseconds per iteration of ``case`` on a ``shape`` block,
  on ``sms`` SMs at ``clock_hz``; 'bytes' (shared memory's) or
  'operations'): the larger of its operations (``narrow.ops_ms``) and
  its shared-memory bytes at SMEM_BYTES_PER_CLOCK an SM."""
  ops, smem = counts(case, shape)
  cells = shape[0] * shape[1]
  by_ops = narrow.ops_ms(ops, cells, sms, clock_hz)
  by_smem = smem * cells / (SMEM_BYTES_PER_CLOCK * sms * clock_hz) * 1e3
  return (by_smem, 'bytes') if by_smem > by_ops else (by_ops, 'operations')


@functools.lru_cache(maxsize=None)
def sass_report() -> Dict[str, Dict[str, object]]:
  """kind -> {'loop': its largest loop's instructions (address, opcode
  with its modifiers, operands), 'registers', 'spills'} of each kernel as
  built (``cuobjdump -sass`` and the ``-Xptxas -v`` report)."""
  from soda_tpu_torch.backend import build
  source = build.csrc_source(SOURCE)
  listings = narrow.parse_listing(narrow.cuobjdump_sass(source))
  ptxas = build.ptxas_report(source)
  out = {}
  for k, kind in enumerate(KINDS):
    mark = 'copy_chainILi%dE' % k
    entries = [e for e in listings if mark in e]
    regs = [r for e, r in ptxas.items() if mark in e]
    if len(entries) != 1 or len(regs) != 1:
      raise RuntimeError('copy probe: %d SASS and %d ptxas entries for %s' % (
          len(entries), len(regs), kind))
    out[kind] = {'loop': narrow.main_loop(listings[entries[0]]),
                 'registers': regs[0]['registers'],
                 'spills': regs[0]['spill_stores'] + regs[0]['spill_loads']}
  return out


def overlap_order(loop) -> Dict[str, int]:
  """In the overlap kernel's main loop, chain B's instructions (LOP3,
  IMNMX/VIMNMX, SHF, LEA, IADD3) between the step's last copy issue (a
  UBLKCP) and the wait on its barrier (the first SYNCS with TRYWAIT; the
  arrives that arm the barrier are SYNCS too), and after the wait (chain
  A's mins among them): {'between', 'after', 'issue', 'wait'} (issue and
  wait: their positions, -1 if not found)."""
  ops = [op for _, op, _ in loop]
  wait = next((i for i, op in enumerate(ops)
               if op.startswith('SYNCS') and 'TRYWAIT' in op), -1)
  issue = max((i for i, op in enumerate(ops[:max(wait, 0)])
               if narrow.base_opcode(op) == 'UBLKCP'), default=-1)
  b_ops = ('LOP3', 'IMNMX', 'VIMNMX', 'SHF', 'LEA', 'IADD3')
  bases = [narrow.base_opcode(op) for op in ops]
  between = sum(op in b_ops for op in bases[issue + 1:wait]) if (
      issue >= 0) else 0
  after = sum(op in b_ops for op in bases[wait + 1:]) if wait >= 0 else 0
  return {'between': between, 'after': after, 'issue': issue, 'wait': wait}


def store_loop_counts(loop) -> Dict[str, int]:
  """The store control's main loop: its STS, LDS and integer mins
  (IMNMX/VIMNMX): a store and a reload a cell slot, neither forwarded."""
  bases = [narrow.base_opcode(op) for _, op, _ in loop]
  return {'STS': bases.count('STS'), 'LDS': bases.count('LDS'),
          'min': bases.count('IMNMX') + bases.count('VIMNMX')}


def sass_line(case) -> str:
  """``case``'s kernel as built: registers, spilled bytes, its main
  loop's instructions (the overlap: chain B's between the issue and the
  wait; the store control: its stores, reloads and mins)."""
  case = _get(case)
  if case.kind == 'rotate':
    return narrow.sass_line(ROTATE[case.name])
  rep = sass_report()[case.kind]
  extra = ''
  if case.kind == 'overlap':
    order = overlap_order(rep['loop'])
    extra = ('; chain B: %d instrs between the copy\'s issue and its wait, '
             '%d after' % (order['between'], order['after']))
  elif case.kind == 'store':
    extra = '; %(STS)d STS, %(LDS)d LDS, %(min)d mins' % store_loop_counts(
        rep['loop'])
  return 'regs %d, spills %d B, main loop %d instrs%s' % (
      rep['registers'], rep['spills'], len(rep['loop']), extra)

