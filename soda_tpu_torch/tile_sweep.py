"""Time the fused kernel of benchmark cells at every tile that fits.

    python -m soda_tpu_torch.tile_sweep [CELL ...]

The measurement behind ``tile_plan.MAX_TILE_CELLS``. For each named
cell of ``testing.CELLS`` (default: blur, jacobi2d, erosion), builds
the default form's kernel (``_short=()``; an explicit tile otherwise
builds the short form) at every candidate tile of
``tile_plan.candidate_tiles``,
with the cap lifted, whose buffers fit shared memory, from 1,024 output
cells up. Each kernel is checked against the plain version
(``testing.check_outputs``) and timed from a cold L2 cache (median of
20 CUDA-event times). Needs a CUDA device; prints one line per tile.

    python -m soda_tpu_torch.tile_sweep --deep [CELL ...]

The measurement behind ``tile_plan._deep_tile`` and the form's barrier
elements: the many-stage form of each named cell (default: contrast)
at every tile of ``DEEP_TILES`` that leaves a resident CTA, each with
the elements ``deep_schedules`` lists (a barrier a stage, then each
barrier element of ``tile_plan.DEEP_ELEMENTS`` added in turn), all
built at once. Each kernel is held bit for bit against the cell's
default-form kernel and printed with its resident CTAs, barriers a
tile, stage evaluations an output, registers and spills and its
cold-L2 median; a tile's schedules are timed back to back (device µs a
call) in the order first, ..., last, last, ..., first, and each line
gives its mean and its ratio to the first.

    python -m soda_tpu_torch.tile_sweep --short [CELL ...]

The measurement behind ``tile_plan._short_tile`` and ``short_default``: for
each named cell (default: the 11 benchmark cells other than contrast),
the short form's element steps (``short_steps``) at the default form's
tile, then the form with every element but 'walk' and 'tile' at each
tile of ``tile_plan.short_tiles`` whose buffers fit, then with 'walk'
at each of its tiles (3-D: runs for one and for two waves), all built
at once. Each kernel is
held bit for bit against the cell's default-form kernel and printed
with its shared memory, resident CTAs (the plan's and the card's),
registers and spills, cells a thread on the minor axis, stage
evaluations and input cells filled an output and barriers a tile; the
steps are timed back to back in the order first, ..., last, last, ...,
first, each line with its mean and its ratio to the step before, the
tiles likewise with the ratio to the default form's tile.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import sys

import torch

from soda_tpu_torch import profiling, testing, utils
from soda_tpu_torch.backend import build, cuda_source, tile_plan
from soda_tpu_torch.backend.fused import FusedExecutor, fused_stencil_plain
from soda_tpu_torch.backend.tile_plan import (DEEP_ELEMENTS, SMEM_LIMIT,
                                               SHORT_ELEMENTS,
                                               candidate_tiles,
                                               make_tile_plan, short_default,
                                               short_tiles)
from soda_tpu_torch.model.compiled import compiled_stats

MIN_CELLS = 1024
NO_CAP = 1 << 30
# the many-stage form's tiles swept (2-D cells): 256 to 1024 outputs
DEEP_TILES = ((4, 64), (4, 128), (8, 32), (8, 64), (16, 16), (16, 32),
              (16, 64), (32, 16), (32, 32), (64, 16))
# back-to-back calls a measurement (1.5-3 ms a call at contrast's shape)
DEEP_CALLS = 50


def short_steps(dim):
  """(label, elements) of the short form's element steps in a ``dim``-D
  grid: the default form, then 'cells' with 'interior', then each later
  element of tile_plan.short_default(dim) in turn."""
  elements = short_default(dim)
  return [('default form', ()), ('+cells+interior', elements[:2])] + [
      ('+' + e, elements[:k + 1]) for k, e in enumerate(elements) if k >= 2]


# back-to-back calls a measurement (0.03-0.5 ms a call; 100 calls of
# blur, 4 ms, spread 0.6x-1.6x between two measurements on an H100)
SHORT_CALLS = 400


def deep_schedules():
  """The element sets ``--deep`` times at each tile: the form with a
  barrier a stage (its elements before 'barriers'), then each later
  element of tile_plan.DEEP_ELEMENTS added in turn."""
  first = DEEP_ELEMENTS.index('barriers')
  return [DEEP_ELEMENTS[:k] for k in range(first, len(DEEP_ELEMENTS) + 1)]


def sweep(name: str, smi: str) -> None:
  shape, overrides = next((s, o) for n, s, o in testing.CELLS if n == name)
  stencil = testing.build_cell(name, overrides)
  inputs = testing.make_test_inputs(stencil, shape)
  params = testing.make_test_params(stencil)
  default = make_tile_plan(stencil, shape, _deep=(), _short=()).tile
  plain = None
  for tile in candidate_tiles(shape, NO_CAP):
    cells = 1
    for t in tile:
      cells *= t
    if cells < MIN_CELLS:
      continue
    if make_tile_plan(stencil, shape, tile,
                      _short=()).smem_bytes > SMEM_LIMIT:
      break
    ex = FusedExecutor(stencil, shape, tile=tile, _short=())
    args = ex.prepare(inputs, params)
    if plain is None:
      n_in = len(stencil.input_names)
      plain = dict(zip(stencil.output_names,
                       fused_stencil_plain(stencil, args[:n_in], args[n_in:])))
    got = dict(zip(stencil.output_names, ex.fn(*args)))
    testing.check_outputs(stencil, shape, got, plain, name)
    times = profiling.cuda_times_ms(lambda: ex.fn(*args))
    q1, _, q3 = statistics.quantiles(times, n=4)
    print('[sweep] %-10s tile %-14s smem %6d B  %6d CTAs  %.4f ms '
          '(quartiles %.4f-%.4f, n=%d)%s | %s' % (
              name, tile, ex.plan.smem_bytes, ex.plan.n_tiles,
              statistics.median(times), q1, q3, len(times),
              '  <- default' if tile == default else '', smi), flush=True)


def deep_runs(stencil, shape):
  """The many-stage form's plans ``--deep`` times: for each tile of
  DEEP_TILES that leaves a resident CTA under every schedule, one plan a
  schedule of ``deep_schedules``."""
  rows = []
  for tile in DEEP_TILES:
    plans = [make_tile_plan(stencil, shape, tile, _deep=elements)
             for elements in deep_schedules()]
    if min(p.deep.ctas for p in plans) >= 1:
      rows.append(plans)
  return rows


def deep_sweep(name: str, smi: str) -> None:
  shape, overrides = next((s, o) for n, s, o in testing.CELLS if n == name)
  stencil = testing.build_cell(name, overrides)
  inputs = testing.make_test_inputs(stencil, shape)
  params = testing.make_test_params(stencil)
  rows = deep_runs(stencil, shape)
  default = make_tile_plan(stencil, shape, _deep=())
  build.build_all([cuda_source.generate(p)
                   for p in [default] + [p for r in rows for p in r]])
  base = FusedExecutor(stencil, shape, _deep=())
  args = base.prepare(inputs, params)
  want = dict(zip(stencil.output_names, base.fn(*args)))
  chosen = make_tile_plan(stencil, shape)
  for plans in rows:
    exs = [FusedExecutor(stencil, shape, tile=p.tile, _deep=p.deep.elements)
           for p in plans]
    for ex in exs:
      got = dict(zip(stencil.output_names, ex.fn(*args)))
      testing.check_exact(stencil, shape, got, want, '%s %s %s' % (
          name, ex.plan.tile, '+'.join(ex.plan.deep.elements)))
    del got
    device_us = {i: [] for i in range(len(exs))}
    order = list(range(len(exs)))
    for i in order + order[::-1]:
      device_us[i].append(profiling.back_to_back_us(
          lambda: exs[i].fn(*args), calls=DEEP_CALLS)[1])
    first = statistics.mean(device_us[0])
    for i, ex in enumerate(exs):
      plan, deep = ex.plan, ex.plan.deep
      ms = statistics.median(profiling.cuda_times_ms(lambda: ex.fn(*args)))
      stats = compiled_stats(ex)['kernels'][0]
      us = statistics.mean(device_us[i])
      print('[deep-sweep] %-10s tile %-10s %-34s smem %6d B  %d CTA(s)/SM '
            '(card %d)  %3d barriers  %.1f evaluations/output  %d '
            'registers, spills %d/%d B  %.4f ms cold  back to back %s us/call'
            ' (mean %.1f, %.3fx the first)  == default form bit for bit%s | '
            '%s' % (
                name, plan.tile, '+'.join(deep.elements), plan.smem_bytes,
                deep.ctas, stats['ctas_per_sm'], len(deep.barriers),
                deep.evaluations, stats['registers'], stats['spill_stores'],
                stats['spill_loads'], ms,
                '/'.join('%.1f' % u for u in device_us[i]), us, us / first,
                '  <- chosen' if (plan.tile, deep.elements) == (
                    chosen.tile, chosen.deep.elements) else '', smi),
            flush=True)


@contextlib.contextmanager
def _waves(waves):
  """tile_plan.WALK_WAVES set to ``waves`` (None: as it was)."""
  saved = tile_plan.WALK_WAVES
  tile_plan.WALK_WAVES = waves or saved
  try:
    yield
  finally:
    tile_plan.WALK_WAVES = saved


def short_runs(names):
  """(name, shape, stencil, steps, tiles) of ``--short``'s cells: the
  steps and the tiles as (label, tile or None, elements, waves) runs,
  the steps at the default form's tile (or, where the form does not
  fit it, the next smaller candidate), the tiles then the walk's tiles
  (3-D: runs for one and for two waves) where they fit."""
  walk = SHORT_ELEMENTS[:SHORT_ELEMENTS.index('walk') + 1]
  before = tuple(e for e in walk if e != 'walk')
  built = []
  for name in names:
    shape, overrides = next((s, o) for n, s, o in testing.CELLS
                            if n == name)
    stencil = testing.build_cell(name, overrides)
    steps = [(label, None, elements, None)
             for label, elements in short_steps(len(shape))]
    tiles = []
    for elements, cands, waves in ((before, short_tiles(shape, False),
                                    (None,)),
                                   (walk, short_tiles(shape, True),
                                    (1, 2) if len(shape) > 2 else (1,))):
      for t in cands:
        for w in waves:
          try:
            with _waves(w):
              make_tile_plan(stencil, shape, t, _short=elements)
          except utils.InputError:
            continue  # past the shared memory a block may use
          tiles.append(('walk, %d wave(s)' % w if w else 'tile', t,
                        elements, w))
    built.append((name, shape, stencil, steps, tiles))
  return built


def short_sweep(names, smi: str) -> None:
  """``--short``: build every run of ``short_runs`` at once, then per
  cell hold each against the default form and time the steps, then the
  tiles, back to back."""
  built = short_runs(names)
  sources = []
  for name, shape, stencil, steps, tiles in built:
    for _, tile, elements, waves in steps + tiles:
      with _waves(waves):
        sources.append(cuda_source.generate(make_tile_plan(
            stencil, shape, tile, _short=elements)))
  build.build_all(sources)
  for name, shape, stencil, steps, tiles in built:
    base = FusedExecutor(stencil, shape, _short=())
    args = base.prepare(testing.make_test_inputs(stencil, shape),
                        testing.make_test_params(stencil))
    want = dict(zip(stencil.output_names, base.fn(*args)))
    default = make_tile_plan(stencil, shape)
    for tag, runs in (('short-steps', steps), ('short-sweep', tiles)):
      exs = []
      for label, tile, elements, waves in runs:
        with _waves(waves):
          ex = FusedExecutor(stencil, shape, tile=tile, _short=elements)
        got = dict(zip(stencil.output_names, ex.fn(*args)))
        testing.check_exact(stencil, shape, got, want, '%s %s %s' % (
            name, label, ex.plan.tile))
        exs.append(ex)
      del got
      us = {i: [] for i in range(len(exs))}
      order = list(range(len(exs)))
      profiling.settle(lambda: exs[0].fn(*args))
      for i in order + order[::-1]:
        us[i].append(profiling.back_to_back_us(
            lambda: exs[i].fn(*args), calls=SHORT_CALLS)[1])
      means = [statistics.mean(us[i]) for i in order]
      tile = make_tile_plan(stencil, shape, _short=()).tile
      ref = next((m for ex, m in zip(exs, means)
                  if ex.plan.tile == tile and ex.plan.short is not None and
                  not ex.plan.short.has('walk')), None)
      for i, ex in enumerate(exs):
        plan, short = ex.plan, ex.plan.short
        stats = compiled_stats(ex)['kernels'][0]
        if tag == 'short-steps':
          ratio, what = means[i] / means[max(i - 1, 0)], 'the step before'
        else:
          ratio, what = means[i] / (ref or float('nan')), \
              'the default form\'s tile'
        print('[%s] %-12s %-28s tile %-14s smem %6d B  %d CTA(s)/SM (card '
              '%d)  %d registers, spills %d/%d B  vec %d  %d steps  %.2f '
              'evaluations, %.2f fills/output  %2d barriers  back to back %s '
              'us/call (mean %.2f, %.3fx %s)  == default form bit for bit%s '
              '| %s' % (
                  tag, name, runs[i][0], plan.tile, plan.smem_bytes,
                  short.ctas if short else 0, stats['ctas_per_sm'],
                  stats['registers'], stats['spill_stores'],
                  stats['spill_loads'], short.vec if short else 1,
                  plan.steps, short.evaluations if short else 0,
                  short.fills if short else 0,
                  len(short.barriers) if short else len(plan.stages),
                  '/'.join('%.1f' % u for u in us[i]), means[i], ratio, what,
                  '  <- default' if short and (
                      plan.tile, short.elements, plan.steps) == (
                          default.tile, default.short.elements,
                          default.steps) else '', smi),
              flush=True)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--deep', action='store_true',
                      help='sweep the many-stage form\'s tiles')
  parser.add_argument('--short', action='store_true',
                      help='time the short form\'s steps and sweep its tiles')
  parser.add_argument('cells', nargs='*')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('tile_sweep: no CUDA device', file=sys.stderr)
    return 1
  smi = profiling.nvidia_smi_line()
  if args.short:
    short_sweep(args.cells or [n for n, _, _ in testing.CELLS
                               if n != 'contrast'], smi)
    return 0
  for name in args.cells or (['contrast'] if args.deep else
                             ['blur', 'jacobi2d', 'erosion']):
    (deep_sweep if args.deep else sweep)(name, smi)
  return 0


if __name__ == '__main__':
  sys.exit(main())
