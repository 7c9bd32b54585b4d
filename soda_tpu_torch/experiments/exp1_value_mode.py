"""Experiment 1 on the H100: stage values in registers against the
default kernel, and the int16 op and roll probes.

The port of experiments/exp1_value_mode.py (its Pallas probes,
probe_i16_ops at :50 and probe_sublane_roll at :76): int16 min, add and
mul on (32, 256) blocks, and a roll by 3 along each axis of a (32, 256)
float32 ramp (see narrow.narrow_probe). Then its roofline part, the
script's four CASES (blur, jacobi2d, seidel2d, erosion at (8192, 2048),
greedy computation reuse where listed) through ``get_executor``, each in
``stage_mode`` 'value' (L1: stages in registers) against 'vmem' (the
default kernel): bit for bit equal on each output's valid region (the
forms leave the cells outside it as they fall), and each its cold-L2
median as a share of ``profiling.bound_ms``. A configuration the tile plan refuses
before any launch prints ``refused: <reason>``, as the script prints
FAILED for a Mosaic refusal; anything else fails the run.

    python -m soda_tpu_torch.experiments.exp1_value_mode [--device cpu]

``--device cpu`` runs the plain versions, the CASES at the small shapes
of ``testing.seed_small``.
"""

from __future__ import annotations

import statistics
import sys

import torch

import soda_tpu_torch
from soda_tpu_torch import corpus, profiling, testing, utils
from soda_tpu_torch.backend import reference
from soda_tpu_torch.experiments import narrow, probes

# exp1_value_mode.py:89-99
CASES = (
    ('blur', (8192, 2048), {'tile_size': (2048, 0)}),
    ('jacobi2d', (8192, 2048), {'tile_size': (2048, 0)}),
    ('seidel2d', (8192, 2048), {'tile_size': (2048, 0),
                                'optimizations': {'computation-reuse':
                                                  'greedy'}}),
    ('erosion', (8192, 2048), {'tile_size': (2048, 0),
                               'optimizations': {'computation-reuse':
                                                 'greedy'}}),
)
MODES = ('value', 'vmem')


def roofline(device, log=print):
  """Each case in each stage mode: the outputs of one call, 'value' bit
  for bit against 'vmem' on each output's valid region; on the card the
  cold-L2 median, the bound and its share. Returns a row per case and
  mode."""
  rows = []
  for name, shape, overrides in CASES:
    if device.type == 'cpu':
      shape, overrides = testing.seed_small(name, shape, overrides)
    stencil = soda_tpu_torch.build_stencil(corpus.CORPUS[name], **overrides)
    inputs = reference.make_test_inputs(stencil, shape)
    outs = {}
    for mode in MODES:
      label = 'exp1 %s [%s]' % (name, mode)
      try:
        ex = soda_tpu_torch.get_executor(stencil, shape, 'fused',
                                         device=device, stage_mode=mode)
      except utils.InputError as err:
        log('>>> %s %s refused: %s' % (label, shape, err))
        rows.append({'body': label, 'ok': True, 'refused': str(err)})
        continue
      args = ex.prepare(inputs)
      ex.launches = 0
      outs[mode] = ex.fn(*args)
      row = {'body': label, 'launches': ex.launches, 'ok': True}
      rows.append(row)
      if device.type == 'cuda':
        ms = statistics.median(profiling.cuda_times_ms(lambda: ex.fn(*args)))
        bound, bound_by = profiling.bound_ms(stencil, shape)
        row.update(ms=ms, bound_ms=bound, bound_by=bound_by)
        log('>>> %s %s roofline=%.3f (%.4f ms, bound %.4f ms %s)' % (
            label, shape, bound / ms, ms, bound, bound_by))
    if len(outs) == 2:
      regions = [reference.output_valid_slices(stencil, shape, out)
                 for out in stencil.output_names]
      same = all(torch.equal(a[region], b[region]) for a, b, region in
                 zip(outs['value'], outs['vmem'], regions))
      for row in rows[-2:]:
        row['ok'] = same
      log('%s %s: value %s vmem' % (name, shape, '==' if same else '!='))
  return rows


def run(device='cuda', log=print):
  device = probes._device(device)
  return narrow.run_bodies(narrow.EXP1, device, log=log) + roofline(device,
                                                                    log)


def main(argv=None) -> int:
  args = probes.parse_args(__doc__, argv)
  return probes.entry(lambda: run(args.device))


if __name__ == '__main__':
  sys.exit(main())
