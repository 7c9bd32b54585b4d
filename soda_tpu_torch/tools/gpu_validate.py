"""The card's corpus validation sweep.

The counterpart of soda_tpu/tools/tpu_validate.py: runs every corpus
kernel's fused CUDA kernel on the card and compares it with the NumPy
oracle (the hardware analog of the reference's software gate,
tests/test-cpp-host.sh), prints a PASS/FAIL table and exits nonzero on
any FAIL or ERROR. All the sweep's kernels are built at once
(``build.build_all``: one nvcc per source) before the first case runs.

    python -m soda_tpu_torch.tools.gpu_validate [--variants] [--cpu]
        [--shape-scale N] [--only TAG,TAG,...]

``--variants`` adds the optimization variants (``VARIANTS``, as the JAX
package's) and the kernel-config variants (``EX_VARIANTS``: the JAX
package's rows with their full keys, the layout keys among them), then
the contrast float64-truth check. ``--cpu`` runs the same matrix through the kernels' plain
PyTorch versions, as ``--interpret`` runs the JAX gate without a TPU.
``--only`` runs the named rows. At these shapes a grid has fewer than
2 x ``tile_plan.MIN_CTAS`` tiles, so a ``stream_loop`` row walks one
tile per CTA; the streaming loop's runs of several steps are checked at
the benchmark shapes by chip_smoke.py and tests/test_torch_gpu.py.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

SHAPES = {
    'blur': (512, 2048),
    'contrast': (512, 512),
    'denoise2d': (512, 512),
    'denoise3d': (128, 32, 128),
    'erosion': (512, 512),
    'heat3d': (256, 32, 128),
    'jacobi2d': (512, 512),
    'jacobi3d': (256, 32, 128),
    'seidel2d': (512, 512),
    'sobel2d': (512, 512),
    'xcorr': (512, 512),
}

TILE = {
    'blur': (2048, 0), 'contrast': (512, 0), 'erosion': (512, 0),
    'xcorr': (512, 0), 'heat3d': (128, 32, 0), 'jacobi3d': (128, 32, 0),
    'denoise3d': (128, 32, 0), 'jacobi2d': (512, 0),
    'seidel2d': (512, 0), 'sobel2d': (512, 0), 'denoise2d': (512, 0),
}

# The reference's squared-form criterion (frt/host.py:633-657) at the
# JAX package's thresholds (tests/checks.py); the kernel is built with
# --fmad=false, so every float operation rounds as the oracle's does.
THRESHOLD = 1e-4
# contrast cancels +-100-coefficient sums of ~5e3 magnitude
KERNEL_THRESHOLDS = {'contrast': 1e-3}

# optimization-variant sweep (--variants), as the JAX package's
# (tpu_validate.py:128-154): the analog of the reference's
# tests/test-cluster.sh re-running the corpus per knob
VARIANTS = (
    ('erosion+cr', 'erosion',
     {'optimizations': {'computation-reuse': 'greedy'}}),
    ('seidel2d+cr', 'seidel2d',
     {'optimizations': {'computation-reuse': 'greedy'}}),
    ('heat3d+distribute', 'heat3d', {'optimizations': {'distribute': True}}),
    ('contrast+extcr', 'contrast',
     {'optimizations': {'computation-reuse': 'yes'}}),
    ('jacobi2d+iterate4', 'jacobi2d', {'iterate': 4}),
    ('blur+preserve', 'blur', {'border': 'preserve'}),
    # cluster granularity across the FULL corpus: per-stage-group
    # kernels with a device-memory handoff ('fine' == 'coarse')
    ('blur+coarse', 'blur', {'cluster': 'coarse'}),
    ('sobel2d+coarse', 'sobel2d', {'cluster': 'coarse'}),
    ('contrast+coarse', 'contrast', {'cluster': 'coarse'}),
    ('denoise2d+coarse', 'denoise2d', {'cluster': 'coarse'}),
    ('denoise3d+coarse', 'denoise3d', {'cluster': 'coarse'}),
    ('erosion+coarse', 'erosion', {'cluster': 'coarse'}),
    ('heat3d+coarse', 'heat3d', {'cluster': 'coarse'}),
    ('jacobi2d+coarse', 'jacobi2d', {'cluster': 'coarse'}),
    ('jacobi3d+coarse', 'jacobi3d', {'cluster': 'coarse'}),
    ('seidel2d+coarse', 'seidel2d', {'cluster': 'coarse'}),
    ('xcorr+coarse', 'xcorr', {'cluster': 'coarse'}),
)

_GREEDY = {'optimizations': {'computation-reuse': 'greedy'}}
_DISTRIBUTE = {'optimizations': {'distribute': True}}
# the round-3 roll-shift seeds (value stages, every shifted read a roll)
ROLL = {'stage_mode': 'value', 'shift_mode': 'roll'}
# kernel-config variants: the rows of the JAX package's EX_VARIANTS
# (tpu_validate.py:159-241; the line of each is cited), with their tags,
# stencil overrides and full keys: the structural ones (block_rows,
# stream_loop, prefetch, dma_split) and the layout ones (stage_mode,
# shift_mode, transpose_lanes, lane_shift, narrow), which select the
# fused kernel's layout forms.
EX_VARIANTS = (
    ('jacobi3d+roll', 'jacobi3d', {}, ROLL),  # :160
    ('heat3d+roll', 'heat3d', _DISTRIBUTE, ROLL),  # :161
    ('seidel2d+roll', 'seidel2d', _GREEDY, ROLL),  # :163
    ('xcorr+roll', 'xcorr', _GREEDY, ROLL),  # :165
    ('denoise2d+roll', 'denoise2d', {}, ROLL),  # :167
    ('denoise3d+roll', 'denoise3d', {}, dict(ROLL, block_rows=64)),  # :168
    ('erosion+hybrid', 'erosion', _GREEDY,
     dict(ROLL, transpose_lanes='on', block_rows=256)),  # :170
    ('xcorr+hybrid', 'xcorr', _GREEDY,
     dict(ROLL, transpose_lanes='on', block_rows=256)),  # :173
    # a ragged last tile (512 = 320 + 192)
    ('xcorr+hybrid320', 'xcorr', _GREEDY,
     dict(ROLL, transpose_lanes='on', block_rows=320,
          lane_shift='rotate')),  # :178
    ('blur+roll', 'blur', {}, dict(ROLL, block_rows=512)),  # :182
    ('blur+stream_loop', 'blur', {}, dict(ROLL, block_rows=512,
                                          stream_loop=True)),  # :187
    ('jacobi3d+peel', 'jacobi3d', {}, {'stream_loop': 'peel'}),  # :189
    ('jacobi2d+peel', 'jacobi2d', {}, {'stream_loop': 'peel'}),  # :192
    ('seidel2d+roll+peel', 'seidel2d', _GREEDY,
     dict(ROLL, block_rows=128, stream_loop='peel')),  # :193
    ('denoise2d+roll+peel', 'denoise2d', {},
     dict(ROLL, block_rows=64, stream_loop='peel')),  # :196
    ('erosion+hybrid+peel', 'erosion', _GREEDY,
     dict(ROLL, transpose_lanes='on', block_rows=256,
          stream_loop='peel')),  # :198
    ('jacobi3d+prefetch3', 'jacobi3d', {},
     {'stream_loop': 'peel', 'prefetch': 3}),  # :204
    ('jacobi3d+peel+split', 'jacobi3d', {},
     {'stream_loop': 'peel', 'dma_split': 2}),  # :208
    ('heat3d+roll+split', 'heat3d', _DISTRIBUTE,
     dict(ROLL, dma_split=2)),  # :210
    ('xcorr+narrow+roll', 'xcorr', _GREEDY, dict(ROLL, narrow='on')),  # :216
    # a ragged last tile (512 = 352 + 160)
    ('xcorr+hybrid352', 'xcorr', _GREEDY,
     dict(ROLL, transpose_lanes='on', block_rows=352,
          lane_shift='rotate')),  # :223
    ('erosion+hybrid+pf2', 'erosion', _GREEDY,
     dict(ROLL, transpose_lanes='on', block_rows=512,
          lane_shift='rotate', prefetch=2)),  # :227
    ('sobel2d+slice+pf2', 'sobel2d', {},
     {'lane_shift': 'slice', 'prefetch': 2}),  # :231
    ('denoise3d+roll+pf2', 'denoise3d', {},
     dict(ROLL, block_rows=64, prefetch=2)),  # :233
    ('jacobi3d+peel+pf2', 'jacobi3d', {},
     {'stream_loop': 'peel', 'prefetch': 2}),  # :235
    ('denoise3d+peel16', 'denoise3d', {},
     dict(ROLL, block_rows=16, stream_loop='peel')),  # :239
)


# the contrast float64-truth check's stencil overrides
F64_VARIANTS = {'optimizations': {'computation-reuse': 'yes'}}


def _stencil(name, variants=(), cache=None):
  """The case's stencil; ``cache`` (a dict the caller keeps for one
  sweep) holds those built already: the computation-reuse scheduler
  takes seconds on contrast, and many rows share a stencil."""
  from soda_tpu_torch import corpus
  key = (name, json.dumps(dict(variants), sort_keys=True))
  if cache is not None and key in cache:
    return cache[key]
  overrides = dict(variants)
  if name in TILE:
    overrides.setdefault('tile_size', TILE[name])
  stencil = corpus.build(name, **overrides)
  if cache is not None:
    cache[key] = stencil
  return stencil


def _executor(stencil, shape, ex_opts, device):
  from soda_tpu_torch.backend import get_executor
  return get_executor(stencil, shape, 'auto', device=device,
                      **(ex_opts or {}))


def sources(name, variants=(), ex_opts=None, cache=None):
  """The kernel sources ``check`` builds for a case (one per stage group
  under ``cluster: coarse/fine``); ``cache`` as ``_stencil``'s."""
  from soda_tpu_torch.backend import cuda_source, grouped, tile_plan
  stencil = _stencil(name, variants, cache)
  subs = ([stencil] if (stencil.cluster or 'none') not in ('coarse', 'fine')
          else grouped.group_stencils(stencil)[1])
  return [cuda_source.generate(tile_plan.kernel_plan(sub, SHAPES[name],
                                                     **(ex_opts or {})))
          for sub in subs]


def check(name, variants=(), ex_opts=None, device='cuda', cache=None):
  """(cells failing the rule, worst error) of one case on ``device``;
  ``cache`` as ``_stencil``'s."""
  from soda_tpu_torch.backend import reference
  stencil = _stencil(name, variants, cache)
  shape = SHAPES[name]
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  want = reference.run(stencil, inputs, params)
  ex = _executor(stencil, shape, ex_opts, device)
  got = ex(inputs, params)
  worst = 0.0
  bad_total = 0
  for out_name in stencil.output_names:
    if stencil.preserve_border:
      region = tuple(slice(None) for _ in shape)  # every cell defined
    else:
      region = reference.output_valid_slices(stencil, shape, out_name)
    g = got[out_name].cpu().numpy()[region]
    w_ = want[out_name][region]
    if stencil.symbol_table[out_name].is_float:
      d2 = (g.astype(np.float64) - w_.astype(np.float64)) ** 2
      w2 = w_.astype(np.float64) ** 2
      t2 = KERNEL_THRESHOLDS.get(name, THRESHOLD) ** 2
      bad = (d2 > t2) & (d2 > t2 * w2)
      worst = max(worst, float(np.sqrt(d2.max())))
    else:
      bad = g != w_
      worst = max(worst, float(np.abs(
          g.astype(np.int64) - w_.astype(np.int64)).max()))
    bad_total += int(bad.sum())
  return bad_total, worst


def contrast_f64_check(device='cuda', cache=None):
  """Measured justification for contrast's looser threshold: the
  kernel's error against the float64 truth (the same program in
  ``double``, evaluated by the oracle in NumPy float64) must be no worse
  than the float32 oracle's own (tests/checks.py's argument, made a
  measured fact).

  Returns (executor_vs_f64_max, oracle32_vs_f64_max). ``cache`` as
  ``_stencil``'s.
  """
  from soda_tpu_torch import api, corpus
  from soda_tpu_torch.backend import reference
  from soda_tpu_torch.backend.fused import FusedExecutor
  shape = SHAPES['contrast']
  overrides = dict(F64_VARIANTS, tile_size=TILE['contrast'])
  st32 = _stencil('contrast', F64_VARIANTS, cache)
  st64 = api.build_stencil(
      corpus.CORPUS['contrast'].replace(' float:', ' double:'), **overrides)
  inputs = reference.make_test_inputs(st32, shape)
  inputs64 = {k: np.asarray(v, np.float64) for k, v in inputs.items()}
  truth = reference.run(st64, inputs64)['output']
  oracle32 = reference.run(st32, inputs)['output'].astype(np.float64)
  got = FusedExecutor(st32, shape, device=device)(inputs)['output']
  got = got.cpu().numpy().astype(np.float64)
  region = reference.output_valid_slices(st32, shape)
  err_exec = float(np.abs(got[region] - truth[region]).max())
  err_orac = float(np.abs(oracle32[region] - truth[region]).max())
  return err_exec, err_orac


def cases(do_variants):
  """(tag, kernel, stencil overrides, kernel options) of every row the
  sweep runs: the corpus, then with ``do_variants`` VARIANTS and
  EX_VARIANTS."""
  from soda_tpu_torch import corpus
  out = [(name, name, {}, None) for name in sorted(corpus.CORPUS)]
  if do_variants:
    out += [(tag, kernel, dict(ov), None) for tag, kernel, ov in VARIANTS]
    out += [(tag, kernel, dict(ov), dict(opts))
            for tag, kernel, ov, opts in EX_VARIANTS]
  return out


def main(argv=None) -> int:
  argv = list(sys.argv[1:] if argv is None else argv)
  device = 'cpu' if '--cpu' in argv else 'cuda'
  do_variants = '--variants' in argv
  only = None
  if '--only' in argv:
    only = argv[argv.index('--only') + 1].split(',')
  if '--shape-scale' in argv:
    # scale the streaming extent (the unbounded axis) of every case
    k = int(argv[argv.index('--shape-scale') + 1])
    for name, shp in list(SHAPES.items()):
      SHAPES[name] = (shp[0] * k,) + tuple(shp[1:])
    print('shape-scale %dx: %s' % (k, SHAPES))
  rows_run = cases(do_variants)
  if only is not None:
    unknown = set(only) - {c[0] for c in rows_run} - {'contrast+f64truth'}
    if unknown:
      print('unknown rows: %s' % ', '.join(sorted(unknown)), file=sys.stderr)
      return 2
    rows_run = [c for c in rows_run if c[0] in only]
  do_f64 = do_variants and (only is None or 'contrast+f64truth' in only)
  built = {}  # the sweep's stencils, each built once
  if device == 'cuda':
    import torch
    if not torch.cuda.is_available():
      print('gpu_validate: no CUDA device (--cpu runs the plain versions)',
            file=sys.stderr)
      return 1
    from soda_tpu_torch import profiling
    from soda_tpu_torch.backend import build
    print('device: %s | %s' % (torch.cuda.get_device_name(0),
                                profiling.nvidia_smi_line()), flush=True)
    srcs = []
    for _, kernel, variants, ex_opts in rows_run:
      try:
        srcs += sources(kernel, variants, ex_opts, built)
      except Exception:  # noqa: BLE001 - the case reports it below
        pass
    if do_f64:
      srcs += sources('contrast', F64_VARIANTS, cache=built)
    srcs = list({s.digest: s for s in srcs}.values())
    t = time.time()
    build.build_all(srcs)
    print('built %d kernels at once (%.1fs)' % (len(srcs), time.time() - t),
          flush=True)
  else:
    print('device: cpu (the kernels\' plain PyTorch versions)', flush=True)
  failures = 0
  rows = []
  for tag, kernel, variants, ex_opts in rows_run:
    try:
      bad, worst = check(kernel, variants, ex_opts, device, built)
      status = 'PASS' if bad == 0 else 'FAIL(%d bad, worst %.3g)' % (
          bad, worst)
      failures += bad != 0
    except Exception as e:  # noqa: BLE001 - report, keep sweeping
      status = 'ERROR: %s' % str(e)[:90].replace('\n', ' ')
      failures += 1
    rows.append((tag, status))
    print('%-20s %s' % (tag, status), flush=True)
  if do_f64:
    # the kernel must be at least as close to the float64 truth as the
    # f32 oracle (1.05x slack for rounding luck on individual cells)
    try:
      err_exec, err_orac = contrast_f64_check(device, built)
      ok = err_exec <= err_orac * 1.05 + 1e-9
      status = ('PASS (exec %.3g <= oracle %.3g vs f64 truth)' if ok else
                'FAIL (exec %.3g > oracle %.3g vs f64 truth)') % (
                    err_exec, err_orac)
      failures += not ok
    except Exception as e:  # noqa: BLE001 - report, keep sweeping
      status = 'ERROR: %s' % str(e)[:90].replace('\n', ' ')
      failures += 1
    rows.append(('contrast+f64truth', status))
    print('%-20s %s' % ('contrast+f64truth', status), flush=True)
  print('%d/%d cases pass' % (len(rows) - failures, len(rows)))
  return 1 if failures else 0


if __name__ == '__main__':
  sys.exit(main())
