"""Analytic performance and resource model of the fused kernel on the H100.

The counterpart of soda_tpu/model/estimate.py. It describes the kernel
that ``FusedExecutor(stencil, shape, **kernel_opts)`` builds; it does not
choose one (the tile rules of backend/tile_plan.py do, and nothing here
feeds them). For that plan (``tile_plan.kernel_plan``, the executor's
own call) it reports

  * the plan's geometry: its form (short, many-stage, the old default
    form, a mode or a layout form), tile, shared memory, resident CTAs,
    tiles and waves, stage evaluations and input cells filled an output,
    barriers a tile, launches;
  * the bound (``profiling.bound_ms``: unique traffic over the spec
    memory rate, or operations over the float32 instruction rate) as
    ``ideal_time_s``, the same number PERF.md's shares divide;
  * an expected time (``est_time_s``) from per-output-cell costs of what
    the kernel does: instructions by operation class, shared-memory
    bytes, device-memory bytes with the refilled halo, barriers a tile
    per wave of CTAs, and launches, each priced by one named constant
    taken from the ported probes or fitted by model/fit.py;
  * ``ceiling_frac``, an upper bound on the bound's share by
    construction: bytes at the spec rate, every operation at its
    cheapest lowering on the card, no barrier or launch cost.

Analytic: it builds nothing, calls no nvcc and touches no CUDA unless
``device`` names a card.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from soda_tpu_torch import profiling, utils
from soda_tpu_torch.backend import tile_plan
from soda_tpu_torch.backend.plan import make_plan
from soda_tpu_torch.ir import nodes as ir

# (substring of the card's name, memory GB/s, float32 operations a
# second, SMs, SM clock Hz, shared-memory bytes a clock an SM)
DEVICE_TABLE = profiling.DEVICE_TABLE

# -- the expected model's prices ----------------------------------------------
# Printed by ``python -m soda_tpu_torch.model.fit --fit
# soda_tpu_torch/model/h100_record.json``, the committed record of a run
# of ``fit --measure`` on an NVIDIA H100 80GB HBM3 at 700 W (302 kernel
# rows, 30 probe rows); each comment names the rows it comes from.
#
# Share of the spec memory rate a streaming pass reaches: the best of the
# record's exp27/exp30 streaming cases (K6.1-K6.2, a 64 MiB float32 pass
# through shared memory: exp27 'grid sync').
STREAM_EFF = 0.7934
# Share of the float32 instruction rate a chain of dependent float32
# operations reaches: exp45's fma10 (K6.4, 20 operations an iteration).
INSTR_EFF = 0.8896
# Instruction slots of one operation of a float32 stage, in units of a
# float32 add at INSTR_EFF. div and transcendental: exp45's div10 and
# sqrt10 (K6.4; IEEE division and square root, --fmad=false), each less
# its chain's add; min, max and the 'other' class run on the ALU at half
# the float32 lanes (K6.5-K6.7: a min, logic op or permute 64 lanes an
# SM a clock), priced by exp24's ew10 (K6.3, 15 ALU operations an
# iteration).
OP_COST = {'add': 1.0, 'mul': 1.0, 'div': 15.63, 'minmax': 2.05, 'transcendental': 10.93, 'other': 2.05}
# The same for an integer stage (16-bit ones are computed as int32, and
# an int16 operation costs what an int32 one does, K6.5): ew10 prices
# mul, minmax and other; an add runs on either integer pipe (K6.5); a
# division, by a constant in every corpus kernel, is no probe's row:
# priced at its lowering (multiply-high, shift and sign correction).
INT_OP_COST = {'add': 1.0, 'mul': 2.05, 'div': 4.0, 'minmax': 2.05, 'transcendental': 10.93, 'other': 2.05}
# Scale of the largest of the three rate terms (memory, instructions,
# shared memory) and the share of the other two that does not hide
# under it: fitted (non-negative least squares on the record's
# back-to-back times, each row weighted by the inverse of its time).
PEAK_SCALE = 0.5161
OVERLAP = 0.341
# Seconds of latency one stage evaluation adds to its thread's sequence
# where the SM has too few warps to hide it, per evaluation a thread runs
# in sequence (evaluations an output x a tile's cells over its 512
# threads x waves): fitted.
EVAL_LATENCY_S = 1.736e-08
# Seconds a CTA barrier costs, per barrier a tile and wave of resident
# CTAs: fitted (the record's many-stage rows run one tile with 34 to 114
# barriers). exp24's grid barrier (K6.3: roll10, 10 barriers of every
# CTA an iteration, 2.5 us each) is a barrier of another kind and bounds
# it from above.
BARRIER_S = 5.567e-08
# Seconds a launch costs back to back beyond its work (the first wave's
# fill and the last one's drain): fitted. PERF.md section 7 ("one-shot
# probes are launch-bound": a 0.0002 ms body reads 0.006 ms cold) is
# where it was first seen.
LAUNCH_S = 9.563e-06

# the constants a model file may set, by name (hbm_gbps, gops and name
# besides)
PRICE_KEYS = ('STREAM_EFF', 'INSTR_EFF', 'OP_COST', 'INT_OP_COST',
              'PEAK_SCALE', 'OVERLAP', 'EVAL_LATENCY_S', 'BARRIER_S',
              'LAUNCH_S')
# threads of a CTA of the fused kernel
THREADS = 32 * tile_plan.WARPS
MODEL_KEYS = ('hbm_gbps', 'gops', 'name') + PRICE_KEYS

# -- the ceiling's prices (upper bound by construction) -----------------------
# Instructions an operation takes at its cheapest lowering on the card:
# one each (the bound's count), a packed 16-bit pair one for two
# (VIMNMX.S16x2, __vadd2: K6.5-K6.7) where the pair's class has one. A
# float multiply and add stay two instructions (the kernels build with
# --fmad=false); an integer a * b + c is one IMAD (--fmad governs only
# floating point). Besides the instruction slots, the ALU classes (min, max,
# other) run at 64 lanes an SM a clock and division and transcendentals
# need at least one special-function instruction at 16 (exp45's rsqrt10
# reads 0.87 of that rate, K6.4); each pipe's time is a lower bound too.
CEIL_PACKED = ('add', 'minmax', 'other')
ALU_LANES = 64
SFU_LANES = 16
CEIL_ALU = ('minmax', 'other')
CEIL_SFU = ('div', 'transcendental')


def device_params(device=None) -> Dict[str, object]:
  """The DEVICE_TABLE row of ``device`` (a card's name, a torch.device,
  'cpu', or None for the first card if there is one): name, memory
  GB/s, operations a second, SMs, clock, shared-memory bytes a clock an
  SM. With no card, or for the CPU, the H100 row, its name saying it was
  assumed; a CPU device never initialises CUDA."""
  import torch
  name = None
  if isinstance(device, str) and device not in ('cpu', 'cuda') and \
      not device.startswith('cuda:'):
    name = device
  elif device is not None and torch.device(device).type == 'cuda':
    if torch.cuda.is_available():
      name = torch.cuda.get_device_name(torch.device(device))
  elif device is None and torch.cuda.is_available():
    name = torch.cuda.get_device_name(0)
  row = next((r for r in DEVICE_TABLE if name and r[0] in name.lower()),
             None)
  if row is None:
    row = DEVICE_TABLE[0]
    name = '%s (assumed: %s)' % (row[0].upper(), 'no card named' if name is
                                 None else 'unknown card %r' % name)
  return {'device': name, 'hbm_gbps': row[1], 'ops_per_s': row[2],
          'sms': row[3], 'clock_hz': row[4], 'smem_bytes_per_clock': row[5]}


# -- operation counts over the IR (copied from the JAX package) ---------------

def _count_ops_into(counts: Dict[str, float], *nodes) -> None:
  """Accumulate arithmetic op counts of expression trees (shared by
  the whole-program roofline and the per-stage op model — one
  classification, no drift)."""

  def visit(node, _):
    if isinstance(node, ir.AddSub):
      counts['add'] += len(node.operator)
    elif isinstance(node, ir.MulDiv):
      for op in node.operator:
        counts['mul' if op == '*' else 'div'] += 1
    elif isinstance(node, ir.Call):
      if node.name in ('min', 'max'):
        counts['minmax'] += len(node.operand) - 1
      elif node.name in ('select', 'abs'):
        counts['other'] += 1
      else:
        counts['transcendental'] += 1
    return node

  for node in nodes:
    node.visit(visit)


def _zero_counts() -> Dict[str, float]:
  return {'add': 0, 'mul': 0, 'div': 0, 'minmax': 0,
          'transcendental': 0, 'other': 0}


def count_ops(stencil) -> Dict[str, float]:
  """Per-output-cell operation counts summed over all stages."""
  counts = _zero_counts()
  for stmt in stencil.local_stmts + stencil.output_stmts:
    _count_ops_into(counts, stmt.expr, *stmt.let)
  return counts


def _stage_op_counts(tensor) -> Dict[str, float]:
  """Arithmetic op counts of one stage's expression."""
  counts = _zero_counts()
  _count_ops_into(counts, tensor.expr, *tensor.lets)
  return counts


# -- the plan's geometry ------------------------------------------------------

def stage_op_classes(stage) -> Dict[str, int]:
  """Operations one evaluation of ``stage`` applies, by class
  (profiling.OP_CLASSES; their sum is what the bound counts)."""
  counts = profiling.op_classes(stage.tensor.expr)
  for let in stage.tensor.lets:
    for key, n in profiling.op_classes(let.expr).items():
      counts[key] += n
  return counts


def form(plan) -> str:
  """'short', 'many-stage', 'layout', 'mode' or 'default' ('mode' and
  'default': the old default form, which ``_short=()`` keeps for the
  public keys)."""
  if plan.short is not None:
    return 'short'
  if plan.deep is not None:
    return 'many-stage'
  if plan.layout is not None:
    return 'layout'
  return 'default' if plan.config.is_default else 'mode'


def _itemsize(stencil, name: str) -> int:
  return stencil.tensors[name].dtype.np_dtype.itemsize


def _extent_cells(plan, name: str) -> int:
  return math.prod(plan.extent(name))


def evaluations(plan) -> Tuple[Dict[str, float], Dict[str, float]]:
  """(stage -> cells a CTA evaluates per output cell, buffered input ->
  cells a CTA fills per output cell). The short form's as ShortForm
  counts them (a register stage's at each cell of its readers, rows of
  a walk's later steps fresh only); every other form's the extents."""
  tile_cells = math.prod(plan.tile)
  inputs = [n for n in plan.stencil.input_names if n in plan.offsets]
  short = plan.short
  if short is None:
    evals = {s.name: _extent_cells(plan, s.name) / tile_cells
             for s in plan.stages}
    return evals, {n: _extent_cells(plan, n) / tile_cells for n in inputs}
  shape, tile = plan.shape, plan.tile
  last = len(shape) - 1
  walk = short.has('walk') and len(shape) >= 2
  tile0 = tile[0] if last else 1

  def rows(name):
    neg, pos = plan.spans[name]
    ext0 = tile[0] + neg[0] + pos[0] if last else 1
    fresh = (tile_plan.walk_rows(plan.stencil, name, tile0, plan.spans)
             if walk else ext0)
    return (ext0 + (plan.steps - 1) * fresh) / plan.steps

  def cross(name):
    neg, pos = plan.spans[name]
    return math.prod(t + a + b for t, a, b in zip(
        tile[1:-1], neg[1:-1], pos[1:-1])) * sum(short.frames[name])

  by_name = {s.name: s for s in plan.stages}
  evals = dict.fromkeys(by_name, 0.0)
  for stage in plan.stages:
    if stage.name in short.values:
      continue
    each = rows(stage.name) * cross(stage.name) / tile_cells
    evals[stage.name] += each
    for value in tile_plan.value_closure(stage, by_name, short.values):
      evals[value.name] += each
  return evals, {n: rows(n) * cross(n) / tile_cells for n in inputs}


def barriers_per_tile(plan) -> int:
  """Barriers a tile: the form's schedule, else one a stage."""
  form_ = plan.short or plan.deep
  return len(form_.barriers) if form_ is not None else len(plan.stages)


def plan_fields(plan) -> Dict[str, object]:
  """The plan's fields ``estimate`` reports."""
  evals, fills = evaluations(plan)
  ctas = tile_plan.resident_ctas(plan.smem_bytes)
  return {
      'form': form(plan),
      'tile': list(plan.tile),
      'smem_bytes': plan.smem_bytes,
      'smem_ok': plan.smem_bytes <= tile_plan.SMEM_LIMIT,
      'ctas_per_sm': ctas,
      'tiles': plan.n_tiles,
      'waves': -(-plan.n_tiles // (tile_plan.SMS * max(ctas, 1))),
      'evaluations_per_output': sum(evals.values()),
      'fills_per_output': sum(fills.values()),
      'barriers_per_tile': barriers_per_tile(plan),
      'launches': 1,
  }


# -- the op model ---------------------------------------------------------------

def _prices(model_params: Optional[Dict[str, object]]) -> Dict[str, object]:
  """The price constants, with a model file's overrides."""
  prices = {key: globals()[key] for key in PRICE_KEYS}
  for key, value in (model_params or {}).items():
    if key not in PRICE_KEYS:
      continue
    try:
      if isinstance(prices[key], dict):
        unknown = sorted(set(value) - set(prices[key]))
        if unknown:
          raise utils.InputError('unknown %s classes %s (known: %s)' % (
              key, unknown, ', '.join(prices[key])))
        prices[key] = dict(prices[key], **{k: float(v)
                                           for k, v in value.items()})
      else:
        prices[key] = float(value)
    except (AttributeError, TypeError, ValueError):
      raise utils.InputError('model-file %s: %r is not a %s' % (
          key, value, 'mapping of classes to numbers' if isinstance(
              prices[key], dict) else 'number')) from None
  return prices


def check_model_params(model_params) -> None:
  """A model file's keys must be MODEL_KEYS."""
  unknown = sorted(set(model_params or {}) - set(MODEL_KEYS))
  if unknown:
    raise utils.InputError('unknown model-file keys %s (known: %s)' % (
        ', '.join(unknown), ', '.join(MODEL_KEYS)))


def op_model(stencil, plan, mode: str = 'expected',
             model_params: Optional[Dict[str, object]] = None
             ) -> Dict[str, object]:
  """What the kernel of ``plan`` does per output cell.

  'expected': the stage evaluations (``evaluations``) times each stage's
  operations by class (``arith``: 'f32' and 'int' stages apart),
  priced by OP_COST / INT_OP_COST into instruction slots; shared-memory
  bytes (each buffered stage's stores, the loads of its register rows,
  in whole units where a thread owns several cells, and the input
  fills); device-memory bytes (the outputs, and the inputs' fills with
  their refilled halo).

  'ceiling': every stage once over its valid cells (as the bound counts
  it), at CEIL prices: ``slots_per_cell`` instruction slots (a float multiply
  and add two, an integer multiply-add pair one, a 16-bit integer
  stage's add, min, max and 'other' half), ``alu_per_cell`` and
  ``sfu_per_cell`` the ALU and special-function instructions; per
  output cell of the grid."""
  if mode == 'ceiling':
    return _ceiling_model(stencil, plan)
  prices = _prices(model_params)
  evals, fills = evaluations(plan)
  arith = {'f32': dict.fromkeys(profiling.OP_CLASSES, 0.0),
           'int': dict.fromkeys(profiling.OP_CLASSES, 0.0)}
  smem = 0.0
  by_name = {s.name: s for s in plan.stages}
  values = plan.short.values if plan.short is not None else ()
  for stage in plan.stages:
    kind = 'f32' if stage.dtype.is_float else 'int'
    for key, n in stage_op_classes(stage).items():
      arith[kind][key] += n * evals[stage.name]
    if stage.name in values:  # evaluated in its readers' registers
      continue
    own = evals[stage.name]
    if stage.name in plan.offsets:
      smem += own * _itemsize(stencil, stage.name)
    if plan.short is not None:
      for (parent, _), (lo, hi) in tile_plan.register_rows(
          stencil, stage, by_name, values, plan.short.vec).items():
        smem += own * (hi - lo) / plan.short.vec * _itemsize(stencil, parent)
    else:
      for parent, offsets in stage.load_offsets.items():
        if parent in plan.offsets:
          smem += own * len(set(offsets)) * _itemsize(stencil, parent)
  hbm = sum(_itemsize(stencil, n) for n in stencil.output_names)
  for name in stencil.input_names:
    each = fills.get(name, 1.0) * _itemsize(stencil, name)
    hbm += each
    smem += each if name in fills else 0.0
  return {'evaluations': evals, 'fills': fills, 'arith': arith,
          'instructions': instructions(arith, prices), 'smem_bytes': smem,
          'hbm_bytes': hbm}


def instructions(arith: Dict[str, Dict[str, float]],
                 prices: Dict[str, object]) -> float:
  """Instruction slots an output of op_model's ``arith`` counts."""
  return sum(prices['OP_COST'][k] * n for k, n in arith['f32'].items()) + \
      sum(prices['INT_OP_COST'][k] * n for k, n in arith['int'].items())


def _ceiling_model(stencil, plan) -> Dict[str, float]:
  cells = float(np.prod(plan.shape))
  slots = alu = sfu = 0.0
  arith = dict.fromkeys(profiling.OP_CLASSES, 0.0)
  fma_fusable = 0.0
  for stage in plan.stages:
    lo, hi = plan.margins[stage.name]
    valid = float(np.prod([s - a - b for s, a, b in zip(plan.shape, lo,
                                                         hi)]))
    counts = stage_op_classes(stage)
    dtype = stage.dtype
    packed = not dtype.is_float and dtype.width_in_bits == 16
    stage_slots = 0.0
    for key, n in counts.items():
      arith[key] += n * valid
      stage_slots += n * (0.5 if packed and key in CEIL_PACKED else 1.0)
      if key in CEIL_ALU:
        alu += n * valid * (0.5 if packed else 1.0)
      if key in CEIL_SFU:
        sfu += n * valid
    if not dtype.is_float:
      # an integer a * b + c is one IMAD
      pairs = min(counts['add'], counts['mul'])
      fma_fusable += pairs * valid
      stage_slots -= pairs * (0.5 if packed else 1.0)
    slots += stage_slots * valid
  return {'slots_per_cell': slots / cells, 'alu_per_cell': alu / cells,
          'sfu_per_cell': sfu / cells, 'int_fma_pairs': fma_fusable / cells,
          'arith': {k: v / cells for k, v in arith.items()}}


def _device_and_rates(device, model_params):
  params = device_params(device)
  model_params = model_params or {}
  check_model_params(model_params)
  try:
    bw = float(model_params.get('hbm_gbps', params['hbm_gbps']))
    ops = float(model_params.get('gops', params['ops_per_s'] / 1e9)) * 1e9
  except (TypeError, ValueError):
    raise utils.InputError('model-file hbm_gbps and gops are numbers, got '
                           '%r' % model_params) from None
  name = str(model_params.get('name', params['device']))
  return params, name, bw, ops


def ceiling_frac(stencil, shape: Sequence[int], device=None,
                 model_params: Optional[Dict[str, object]] = None,
                 plan=None) -> float:
  """Upper bound on the bound's share (bound / time) a kernel can reach:
  the bound over the least time the card's rates allow, the largest of
  the unique bytes at the spec memory rate, the instruction slots at the
  float32 instruction rate, the ALU and the special-function
  instructions at their lanes' rates (op_model's 'ceiling'); no barrier
  or launch cost. At most 1: the bound is itself a least time. A
  measured share above it (tests/test_torch_estimate.py holds the
  committed record to it, chip_smoke.py the card's run) means the model
  or the bound is stale."""
  params, _, bw, ops = _device_and_rates(device, model_params)
  plan = plan or tile_plan.kernel_plan(stencil, tuple(shape))
  cells = float(np.prod(shape))
  in_b, out_b = profiling.stream_bytes(stencil, shape)
  ceil = op_model(stencil, plan, 'ceiling')
  lane_rate = ops / 128  # lane-clocks a second over the card
  least = max((in_b + out_b) / (bw * 1e9),
              ceil['slots_per_cell'] * cells / ops,
              ceil['alu_per_cell'] * cells / (lane_rate * ALU_LANES),
              ceil['sfu_per_cell'] * cells / (lane_rate * SFU_LANES))
  ideal = _ideal_time_s(stencil, shape, bw, ops)[0]
  return min(1.0, ideal / least)


def _ideal_time_s(stencil, shape, bw, ops) -> Tuple[float, str]:
  """profiling.bound_ms in seconds, at the rates ``bw`` GB/s and ``ops``
  a second (the card's, or a model file's)."""
  in_b, out_b = profiling.stream_bytes(stencil, shape)
  by_bytes = (in_b + out_b) / (bw * 1e9)
  by_ops = profiling.op_count(stencil, shape) / ops
  return (by_bytes, 'bytes') if by_bytes >= by_ops else (by_ops, 'operations')


def features(model: Dict[str, object], fields: Dict[str, object],
             cells: float, params: Dict[str, object], bw: float, ops: float,
             prices: Dict[str, object]) -> Dict[str, float]:
  """What the fitted constants multiply: the memory, instruction and
  shared-memory times at the probes' rates (``hbm_s``, ``instr_s``,
  ``smem_s``), the largest of them (``peak_s``) and the sum of the other
  two (``rest_s``), the evaluations a thread runs in sequence
  (``chain``), barriers a tile times waves (``barrier_waves``) and
  launches."""
  smem_rate = params['sms'] * params['smem_bytes_per_clock'] * \
      params['clock_hz']
  rates = {
      'hbm_s': model['hbm_bytes'] * cells / (bw * 1e9 *
                                             prices['STREAM_EFF']),
      'instr_s': instructions(model['arith'], prices) * cells / (
          ops * prices['INSTR_EFF']),
      'smem_s': model['smem_bytes'] * cells / smem_rate,
  }
  peak = max(rates.values())
  out = dict(rates, peak_s=peak, rest_s=sum(rates.values()) - peak)
  out['chain'] = fields['evaluations_per_output'] * math.prod(
      fields['tile']) / THREADS * fields['waves']
  out['barrier_waves'] = fields['barriers_per_tile'] * fields['waves']
  out['launches'] = fields['launches']
  return out


# the fitted constant that multiplies each feature
FITTED = (('PEAK_SCALE', 'peak_s'), ('OVERLAP', 'rest_s'),
          ('EVAL_LATENCY_S', 'chain'), ('BARRIER_S', 'barrier_waves'),
          ('LAUNCH_S', 'launches'))


def times(model: Dict[str, object], fields: Dict[str, object], cells: float,
          params: Dict[str, object], bw: float, ops: float,
          prices: Dict[str, object]) -> Dict[str, float]:
  """The expected model's terms in seconds (``features``) and the time
  ``est_s``: PEAK_SCALE x the largest of the memory, instruction and
  shared-memory times, OVERLAP x the other two, and the latency,
  barrier and launch terms (``kernel_s``: the first two alone)."""
  out = features(model, fields, cells, params, bw, ops, prices)
  out['kernel_s'] = prices['PEAK_SCALE'] * out['peak_s'] + \
      prices['OVERLAP'] * out['rest_s']
  out['est_s'] = sum(prices[key] * out[name] for key, name in FITTED)
  return out


def estimate(stencil, shape: Sequence[int], device=None,
             model_params: Optional[Dict[str, object]] = None,
             kernel_opts: Optional[Dict[str, object]] = None
             ) -> Dict[str, object]:
  """Analytic estimate of the fused kernel ``FusedExecutor(stencil,
  shape, **kernel_opts)`` builds. ``model_params`` (the --model-file
  JSON) may set ``hbm_gbps``, ``gops``, ``name`` and any price constant
  by its name (PRICE_KEYS; OP_COST and INT_OP_COST by class); another
  key raises utils.InputError naming the known ones. ``device``: as
  device_params."""
  shape = tuple(int(s) for s in shape)
  params, name, bw, ops = _device_and_rates(device, model_params)
  prices = _prices(model_params)
  try:
    plan = tile_plan.kernel_plan(stencil, shape, **dict(kernel_opts or {}))
  except (TypeError, ValueError) as e:
    raise utils.InputError(str(e)) from None
  fusion = make_plan(stencil, 'full')
  cells = float(np.prod(shape))
  in_b, out_b = profiling.stream_bytes(stencil, shape)
  traffic = in_b + out_b
  ops_per_cell = count_ops(stencil)
  ideal, bound = _ideal_time_s(stencil, shape, bw, ops)
  fields = plan_fields(plan)
  model = op_model(stencil, plan, model_params=model_params)
  terms = times(model, fields, cells, params, bw, ops, prices)
  out = {
      'device': name,
      'peak_hbm_gbps': bw,
      'peak_gops': ops / 1e9,
      'cells': cells,
      'hbm_bytes': traffic,
      'arithmetic_intensity': sum(ops_per_cell.values()) * cells / traffic,
      'ops_per_cell': ops_per_cell,
      'bound': bound,
      'op_model': dict(model, terms=terms),
      'model_roofline_frac': round(min(1.0, ideal / terms['kernel_s']), 4),
      'ceiling_frac': round(ceiling_frac(stencil, shape, device,
                                         model_params, plan), 4),
      'ideal_time_s': ideal,
      'ideal_cells_per_s': cells * stencil.iterate / ideal,
      'ideal_effective_gbps': traffic / ideal / 1e9,
      'est_time_s': terms['est_s'],
      'est_roofline_frac': round(min(1.0, ideal / terms['est_s']), 4),
      'halo': {'lo': fusion.halo_lo, 'hi': fusion.halo_hi},
      'stages': len(fusion.stages),
      'total_reuse_distance': getattr(stencil, 'total_reuse_distance', None),
  }
  out.update(fields)
  return out


def print_estimation(stencil, shape, file, device=None,
                     model_params=None, kernel_opts=None) -> None:
  json.dump(estimate(stencil, shape, device, model_params, kernel_opts),
            file, indent=2, default=str)
  file.write('\n')
