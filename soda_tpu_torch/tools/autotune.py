"""Probe the fused kernel's configurations on the card; cache the winner.

The counterpart of soda_tpu/tools/autotune.py. The fastest
configuration of the fused kernel (its tile, and the modes of
``FusedExecutor``: ``stream_loop``, ``prefetch``, ``dma_split``,
``out_dma``) is a property of (stencil, shape, card): probe it once on
the card and cache it under a key of the stencil text, the shape and
the card's name (``torch.cuda.get_device_name``), as the reference
caches its floorplan under the stencil text (cluster.py:104-160).

Usage:
  from soda_tpu_torch.tools.autotune import tune, tuned_executor
  cfg = tune(stencil, shape)               # {'stream_loop': 'peel', ...}
  ex = tuned_executor(stencil, shape)      # FusedExecutor built with cfg

CLI: ``python -m soda_tpu_torch FILE --run --tune``.

Each candidate is timed back to back after a one-second settle run of
its own (``profiling.settle``): device µs a call over REPS calls
replayed from one CUDA graph (``profiling.replay_us``), the metric the
port compares kernels by. Cold-L2 medians spread by a quarter within
one call, and calls enqueued from Python (``back_to_back_us``) read the
host's time where a kernel runs in under about 60 µs, as the default
kernels of half the cells do. A candidate replaces the default kernel
(``{}``, the first) only where it is faster by more than KEEP_MARGIN,
on a second reading of both as on the first.
The tuner needs the card: on any other device it raises
utils.InputError.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Dict, Tuple

from soda_tpu_torch import utils

_logger = logging.getLogger().getChild(__name__)

DEFAULT_CACHE = '~/.cache/soda_tpu_torch_tune.json'
# calls per candidate timed back to back (one CUDA graph, after a
# settle run)
REPS = 200
# a candidate replaces the default kernel only where its time is below
# (1 - KEEP_MARGIN) of the default's: the two back-to-back readings of
# one kernel in a call after a settle run agree within about 1% but for
# rare transients that slow one reading (one twin of 106 read 1.6x the
# other, PERF.md), so a closer win is noise, and a win is read twice
KEEP_MARGIN = 0.03
# the tiles the tuner offers besides the rule's own: those of
# tile_plan.short_tiles next to it by the rule's key
NEXT_TILES = 2


def _key(stencil, shape, device_kind: str) -> str:
  text = '%s|%s|%s' % (stencil, shape, device_kind)
  return hashlib.sha256(text.encode()).hexdigest()[:24]


def _load(path: str) -> Dict:
  try:
    with open(path) as f:
      return json.load(f)
  except (OSError, ValueError):
    return {}


def _store(path: str, table: Dict) -> None:
  os.makedirs(os.path.dirname(path), exist_ok=True)
  tmp = path + '.tmp'
  with open(tmp, 'w') as f:
    json.dump(table, f, indent=1)
  os.replace(tmp, path)


def _device_kind(device) -> str:
  """The card's name; utils.InputError unless ``device`` is a usable
  CUDA device (the tuner times kernels, which only the card runs)."""
  import torch
  device = torch.device(device)
  if device.type != 'cuda' or not torch.cuda.is_available():
    raise utils.InputError(
        'tuning times the kernel on the card: it needs a CUDA device, got '
        '%s%s' % (device, '' if torch.cuda.is_available() else
                  ' (no CUDA device is visible)'))
  return torch.cuda.get_device_name(device)


def _time_config(stencil, shape, cfg: Dict, device='cuda',
                 reps: int = REPS) -> float:
  """Seconds a call of the kernel built with ``cfg`` takes on the card
  back to back (build excluded): ``reps`` calls replayed from one CUDA
  graph after a one-second settle run (a first measurement after a
  pause or another kernel's work reads up to 1.6x its later ones)."""
  from soda_tpu_torch import profiling
  from soda_tpu_torch.backend import reference
  from soda_tpu_torch.backend.fused import FusedExecutor

  ex = FusedExecutor(stencil, shape, device=device, **cfg)
  args = ex.prepare(reference.make_test_inputs(stencil, shape),
                    reference.make_test_params(stencil))
  profiling.settle(lambda: ex.fn(*args))
  return profiling.replay_us(lambda: ex.fn(*args), calls=reps) / 1e6


def _build_candidates(stencil, shape, candidates) -> None:
  """Build every candidate's kernel at once (one nvcc per source); a
  candidate whose build fails fails again, alone, when it is timed."""
  from soda_tpu_torch.backend import build, cuda_source, tile_plan
  try:
    build.build_all([cuda_source.generate(tile_plan.kernel_plan(
        stencil, shape, **cfg)) for cfg in candidates])
  except RuntimeError as e:
    _logger.info('tune: a candidate did not build (%s)',
                 str(e).splitlines()[0][:80])


def candidate_configs(stencil, shape) -> Tuple[Dict, ...]:
  """The configurations ``tune`` probes. First ``{}``, the default kernel
  (the short or the many-stage form at its rule's tile). Then the short
  form at the tiles of ``tile_plan.short_tiles`` nearest the rule's
  (its tile for this grid, where the default is another form): its
  axis-0 extent halved and doubled, and the next NEXT_TILES by the
  rule's own key (``tile_plan.short_tile_order``). Then the modes on the
  short form: the walk (``stream_loop``, prefetch 2 and 3; 'peel' builds
  the same kernel as True) where a CTA would walk more than one tile,
  split fills on 3-D grids, staged stores. Last the JAX tuner's layout
  candidates (soda_tpu/tools/autotune.py:81-130), which build the short
  form with its layout element (tile_plan.Region), at the rule's axis-0
  extent and twice it: lane rotates on 2-D rows wider than 256, roll,
  and roll with transposed lane regions on 2-D grids; chunked stage
  loops (``compute_chunk=8``, the short form at that mid tile) at the
  largest mid tiles where a 3-D grid's cross-section is wider than a
  tile holds. A candidate whose plan does not fit is left out."""
  from soda_tpu_torch.backend import tile_plan

  shape = tuple(shape)
  default = tile_plan.make_tile_plan(stencil, shape)
  rule = default if default.short is not None else tile_plan.make_tile_plan(
      stencil, shape, _short=tile_plan.short_default(len(shape)))
  cands = [{}]
  order = tile_plan.short_tile_order(stencil, shape)
  near = [(rule.tile[0] // 2,) + rule.tile[1:],
          (rule.tile[0] * 2,) + rule.tile[1:]]
  tiles = [t for t in near if t in order]
  tiles += [t for t in order if t not in tiles and t != rule.tile
            ][:NEXT_TILES]
  cands += [{'tile': t} for t in tiles]
  try:
    runs = tile_plan.kernel_plan(stencil, shape, stream_loop=True).steps > 1
  except utils.InputError:
    runs = False
  if runs:
    cands += [{'stream_loop': True, 'prefetch': p} for p in (2, 3)]
  if len(shape) >= 3:
    cands.append({'dma_split': 2})
  cands.append({'out_dma': True})
  # the layout keys build the short form, at its rule's tile rows
  rows = rule.tile[0]
  roll = {'stage_mode': 'value', 'shift_mode': 'roll'}
  if len(shape) == 2 and shape[-1] > 256:
    cands += [{'block_rows': r, 'lane_shift': 'rotate'}
              for r in (rows, 2 * rows)]
  cands += [dict(roll, block_rows=r) for r in (rows, 2 * rows)]
  if len(shape) == 2:
    cands.append(dict(roll, block_rows=rows, transpose_lanes='on'))
  if len(shape) == 3 and shape[1] * shape[2] > tile_plan.MAX_TILE_CELLS:
    mids = [m for m in (8, 16, 32, 64, 128) if m < shape[1]]
    cands += [{'mid_tile': m, 'compute_chunk': 8} for m in mids[-3:]]
  out = []
  for cfg in cands:
    try:
      plan = tile_plan.kernel_plan(stencil, shape, **cfg)
    except utils.InputError:
      continue
    if plan.smem_bytes <= tile_plan.SMEM_LIMIT:
      out.append(cfg)
  return tuple(out)


def tune(stencil, shape, cache_path: str = DEFAULT_CACHE,
         force: bool = False, device='cuda') -> Dict:
  """Probe candidate configs on the card; cache the winner.

  Returns FusedExecutor keyword arguments (``{}`` when every candidate
  failed, which is not cached: the next call probes again). Raises
  utils.InputError without a CUDA device.
  """
  device_kind = _device_kind(device)
  path = os.path.expanduser(cache_path)
  key = _key(stencil, tuple(shape), device_kind)
  table = _load(path)
  if not force and key in table:
    cfg = dict(table[key]['config'])
    if 'tile' in cfg:  # JSON keeps the tile as a list
      cfg['tile'] = tuple(cfg['tile'])
    return cfg

  best_cfg: Dict = {}
  best_dt = float('inf')
  probes = {}
  try:
    candidates = candidate_configs(stencil, shape)
  except utils.InputError as e:  # e.g. a plan that fits no tile
    _logger.warning('tune: cannot build candidates (%s); untuned',
                    str(e).splitlines()[0][:80])
    return {}
  _build_candidates(stencil, shape, candidates)
  default_dt = None
  for cfg in candidates:
    t0 = time.time()
    try:
      dt = _time_config(stencil, shape, cfg, device)
    except (RuntimeError, utils.InputError) as e:  # a build or launch
      _logger.info('tune: %s failed (%s)', cfg, str(e).splitlines()[0][:80])
      continue
    _logger.info('tune: %s -> %.4f ms (%.0fs)', cfg, dt * 1e3,
                 time.time() - t0)
    probes[json.dumps(cfg, sort_keys=True)] = round(dt * 1e3, 6)
    if not cfg:
      default_dt = dt
    if dt < best_dt:
      best_dt, best_cfg = dt, dict(cfg)
  if best_dt == float('inf'):
    # every candidate failed: do not pin the failure in the cache
    _logger.warning('tune: all candidates failed; not caching')
    return {}
  if (default_dt is not None and best_cfg and
      best_dt < (1 - KEEP_MARGIN) * default_dt):
    # a transient only slows a reading: confirm the win with a second
    # reading of both, each kernel's faster one counting
    default_dt = min(default_dt, _time_config(stencil, shape, {}, device))
    best_dt = min(best_dt, _time_config(stencil, shape, best_cfg, device))
  if default_dt is not None and best_dt >= (1 - KEEP_MARGIN) * default_dt:
    best_dt, best_cfg = default_dt, {}  # no win beyond the noise
  # merge-on-write: entries written meanwhile by another process survive
  table = _load(path)
  table[key] = {
      'stencil': stencil.app_name,
      'shape': list(shape),
      'device': device_kind,
      'config': best_cfg,
      'ms': round(best_dt * 1e3, 6),
      'probes': probes,
  }
  try:
    _store(path, table)
  except OSError as e:  # pragma: no cover
    _logger.warning('tune cache not written: %r', e)
  return dict(best_cfg)


def tuned_executor(stencil, shape, cache_path: str = DEFAULT_CACHE,
                   device='cuda', **kwargs):
  """A FusedExecutor built with ``tune``'s winner (``kwargs`` on top);
  a stencil the fused kernel cannot take goes through
  ``get_executor(..., 'auto')`` instead."""
  from soda_tpu_torch.backend import get_executor
  from soda_tpu_torch.backend.fused import FusedExecutor
  cfg = tune(stencil, shape, cache_path, device=device)
  cfg.update(kwargs)
  try:
    return FusedExecutor(stencil, shape, device=device, **cfg)
  except utils.InputError:
    return get_executor(stencil, shape, 'auto', device=device)
