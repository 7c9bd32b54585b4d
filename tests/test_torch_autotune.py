"""The tuner's probe-and-cache mechanics on the CPU (the port's
tools/autotune.py, mirroring tests/test_autotune.py).

The timing itself runs on the card (tests/test_torch_gpu.py); here the
timer is a stand-in, the card's name a fixed string, and the candidate
builds are skipped. The reference analog is the AutoBridge floorplan
cache keyed by the stencil text (cluster.py:104-160): an expensive
deterministic probe runs once per (stencil, shape, card) and later runs
reuse it.
"""

import json

import numpy as np
import pytest

from soda_tpu_torch import corpus, utils
from soda_tpu_torch.backend import reference, tile_plan
from soda_tpu_torch.tools import autotune


def _label(cfg):
  return json.dumps(cfg, sort_keys=True)


def _fake_timer(times, seen=None):
  def timer(stencil, shape, cfg, device='cuda', reps=autotune.REPS):
    if seen is not None:
      seen.append(cfg)
    if _label(cfg) not in times:
      raise RuntimeError('candidate rejected')
    return times[_label(cfg)]
  return timer


@pytest.fixture
def card(monkeypatch):
  """A stand-in card: a fixed name, no builds."""
  built = []
  monkeypatch.setattr(autotune, '_device_kind', lambda device: 'fake card')
  monkeypatch.setattr(autotune, '_build_candidates',
                      lambda stencil, shape, cands: built.append(list(cands)))
  return built


def test_tune_picks_fastest_and_caches(tmp_path, monkeypatch, card):
  cache = str(tmp_path / 'tune.json')
  stencil = corpus.build('jacobi2d')
  shape = (256, 64)
  monkeypatch.setattr(tile_plan, 'MIN_CTAS', 1)
  cands = autotune.candidate_configs(stencil, shape)
  times = {_label(c): 3e-3 for c in cands}
  best = {'stream_loop': True, 'prefetch': 3}
  times[_label(best)] = 1e-3
  seen = []
  monkeypatch.setattr(autotune, '_time_config', _fake_timer(times, seen))
  cfg = autotune.tune(stencil, shape, cache_path=cache)
  assert cfg == best
  # built at once; the win read a second time, with the default's
  assert seen == list(cands) + [{}, best] and card == [list(cands)]
  table = json.load(open(cache))
  (entry,) = table.values()
  assert entry['stencil'] == 'jacobi2d' and entry['device'] == 'fake card'
  assert entry['config'] == cfg and entry['ms'] == 1.0
  assert len(entry['probes']) == len(cands)
  # second call: a cache hit (the timer would now reject everything)
  monkeypatch.setattr(autotune, '_time_config', _fake_timer({}, seen))
  del seen[:]
  assert autotune.tune(stencil, shape, cache_path=cache) == cfg
  assert not seen
  # the cache is keyed by the card: another card probes again
  monkeypatch.setattr(autotune, '_device_kind', lambda device: 'other card')
  assert autotune.tune(stencil, shape, cache_path=cache) == {}
  assert seen


def test_tune_keeps_other_entries(tmp_path, monkeypatch, card):
  """Merge-on-write: an entry written by another process while this one
  probed survives."""
  cache = str(tmp_path / 'tune.json')
  stencil = corpus.build('blur')
  shape = (64, 256)
  cands = autotune.candidate_configs(stencil, shape)

  def timer(stencil_, shape_, cfg, device='cuda', reps=autotune.REPS):
    autotune._store(cache, {'other': {'config': {}}})
    return 1e-3

  monkeypatch.setattr(autotune, '_time_config', timer)
  cfg = autotune.tune(stencil, shape, cache_path=cache)
  assert cfg == cands[0]
  assert set(json.load(open(cache))) == {'other', autotune._key(
      stencil, shape, 'fake card')}


def test_tune_survives_all_candidates_failing(tmp_path, monkeypatch, card):
  cache = tmp_path / 'tune.json'
  stencil = corpus.build('jacobi2d')
  monkeypatch.setattr(autotune, '_time_config', _fake_timer({}))
  assert autotune.tune(stencil, (24, 32), cache_path=str(cache)) == {}
  assert not cache.exists()  # a failure is not pinned in the cache


def test_tuned_executor_matches_oracle(tmp_path, monkeypatch, card):
  cache = str(tmp_path / 'tune.json')
  stencil = corpus.build('blur')
  shape = (256, 64)
  monkeypatch.setattr(tile_plan, 'MIN_CTAS', 1)
  pick = {'stream_loop': True, 'prefetch': 2}
  monkeypatch.setattr(autotune, '_time_config',
                      _fake_timer({_label(pick): 1e-3}))
  ex = autotune.tuned_executor(stencil, shape, cache_path=cache,
                               device='cpu')
  assert ex.config.stream_loop is True and ex.plan.steps > 1
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = ex(inputs)
  region = reference.output_valid_slices(stencil, shape)
  assert np.array_equal(got['blur_y'].numpy()[region], want['blur_y'][region])


def test_tuned_executor_falls_back_to_the_dispatch(tmp_path, monkeypatch,
                                                   card):
  """A cached config the fused kernel cannot take (here a tile past the
  shared memory with a deep ring) goes through get_executor('auto')."""
  cache = str(tmp_path / 'tune.json')
  stencil = corpus.build('blur')
  shape = corpus.TEST_DIMS['blur']
  table = {autotune._key(stencil, shape, 'fake card'): {
      'config': {'tile': [4096, 4096], 'stream_loop': True, 'prefetch': 4}}}
  autotune._store(cache, table)
  ex = autotune.tuned_executor(stencil, shape, cache_path=cache,
                               device='cpu')
  assert ex.config.is_default


def test_tune_needs_the_card(tmp_path):
  stencil = corpus.build('blur')
  with pytest.raises(utils.InputError, match='CUDA device'):
    autotune.tune(stencil, (64, 256), cache_path=str(tmp_path / 't.json'),
                  device='cpu')


def test_candidates_2d():
  """The default kernel (``{}``: blur's short form at its rule's tile),
  the short form at the rule's tile with its axis-0 extent halved
  (doubled leaves short_tiles' cells here) and at the next tiles by the
  rule's key, the walk (prefetch 2 and 3; 'peel' builds the same kernel
  as True) where a CTA walks several tiles, staged stores; no split
  fills on a 2-D grid. A grid of few tiles gets no streaming candidate
  (one step per CTA)."""
  stencil = corpus.build('blur', tile_size=(2048, 0))
  shape = (8192, 2048)
  many = autotune.candidate_configs(stencil, shape)
  rule = tile_plan.make_tile_plan(stencil, shape).tile
  order = tile_plan.short_tile_order(stencil, shape)
  assert many[0] == {} and order[0] == rule
  assert {'tile': (rule[0] // 2,) + rule[1:]} in many
  assert {'tile': (rule[0] * 2,) + rule[1:]} not in many
  tiles = [c['tile'] for c in many if 'tile' in c]
  assert len(tiles) == 1 + autotune.NEXT_TILES and rule not in tiles
  assert tiles[1:] == [t for t in order[1:] if t not in tiles[:1]][
      :autotune.NEXT_TILES]
  for prefetch in (2, 3):
    assert {'stream_loop': True, 'prefetch': prefetch} in many
  assert not any(c.get('stream_loop') == 'peel' for c in many)
  assert {'out_dma': True} in many
  assert not any('dma_split' in c for c in many)
  few = autotune.candidate_configs(stencil, (64, 256))
  assert not any('stream_loop' in c for c in few)


@pytest.mark.parametrize('shape', [(2048, 32, 128), (64, 512, 512)])
def test_candidates_3d(shape):
  """3-D grids add split fills; every candidate's plan fits shared
  memory, wide cross-sections included (the port tiles every axis)."""
  stencil = corpus.build('jacobi3d', tile_size=(512, 512, 0))
  cands = autotune.candidate_configs(stencil, shape)
  assert {'dma_split': 2} in cands
  assert any(c.get('stream_loop') is True for c in cands)
  for cfg in cands:
    plan = tile_plan.kernel_plan(stencil, shape, **cfg)
    assert plan.smem_bytes <= tile_plan.SMEM_LIMIT


def test_key_is_the_stencil_shape_and_card():
  blur = corpus.build('blur')
  key = autotune._key(blur, (64, 256), 'NVIDIA H100 80GB HBM3')
  assert key == autotune._key(corpus.build('blur'), (64, 256),
                              'NVIDIA H100 80GB HBM3')
  assert key != autotune._key(blur, (64, 512), 'NVIDIA H100 80GB HBM3')
  assert key != autotune._key(blur, (64, 256), 'another card')
  assert key != autotune._key(corpus.build('jacobi2d'), (64, 256),
                              'NVIDIA H100 80GB HBM3')


@pytest.mark.parametrize('name', ['blur', 'contrast'])
def test_first_candidate_is_the_default_kernel(name):
  """The first candidate builds the kernel that runs untuned: ``{}``,
  since blur's default kernel is the short form and contrast's the
  many-stage form, which an explicit tile turns off."""
  from soda_tpu_torch import testing
  from soda_tpu_torch.backend import cuda_source
  _, shape, overrides = next(c for c in testing.CELLS if c[0] == name)
  stencil = testing.build_cell(name, overrides)
  first = autotune.candidate_configs(stencil, shape)[0]
  assert first == {}
  text = cuda_source.generate(tile_plan.kernel_plan(stencil, shape, **first))
  default = cuda_source.generate(tile_plan.make_tile_plan(stencil, shape))
  assert text.text == default.text


@pytest.mark.parametrize('name', ['blur', 'jacobi3d', 'denoise3d',
                                  'contrast'])
def test_candidates_are_the_short_form(name):
  """Every candidate builds the short form (``{}`` contrast's many-stage
  form), the JAX tuner's layout ones with the layout element on it."""
  from soda_tpu_torch import testing
  _, shape, overrides = next(c for c in testing.CELLS if c[0] == name)
  stencil = testing.build_cell_stepped(name, overrides)
  for cfg in autotune.candidate_configs(stencil, shape):
    plan = tile_plan.kernel_plan(stencil, shape, **cfg)
    if any(k in cfg for k in ('stage_mode', 'lane_shift', 'compute_chunk')):
      assert plan.layout is not None and plan.short is not None, cfg
      assert plan.warp is None and plan.short.layout, cfg
    elif cfg or name != 'contrast':
      assert plan.short is not None, cfg
    else:
      assert plan.deep is not None


@pytest.mark.parametrize('ratio,keeps', [(0.98, True), (0.971, True),
                                         (0.969, False), (0.5, False)])
def test_tune_keeps_the_default_within_the_margin(tmp_path, monkeypatch,
                                                  card, ratio, keeps):
  """A candidate replaces ``{}`` only where it is faster by more than
  KEEP_MARGIN (3%); the probes are all recorded either way."""
  stencil = corpus.build('jacobi2d')
  shape = (256, 64)
  cands = autotune.candidate_configs(stencil, shape)
  times = {_label(c): 2e-3 for c in cands}
  times[_label({})] = 1e-3
  times[_label(cands[1])] = ratio * 1e-3
  monkeypatch.setattr(autotune, '_time_config', _fake_timer(times))
  cache = str(tmp_path / 'tune.json')
  cfg = autotune.tune(stencil, shape, cache_path=cache)
  assert cfg == ({} if keeps else cands[1])
  (entry,) = json.load(open(cache)).values()
  assert entry['ms'] == pytest.approx(1.0 if keeps else ratio)
  assert len(entry['probes']) == len(cands)


@pytest.mark.parametrize('second,keeps', [(1e-3, True), (0.5e-3, True),
                                          (2e-3, False)])
def test_tune_reads_a_win_twice(tmp_path, monkeypatch, card, second, keeps):
  """A win past the margin is read again with the default's, each
  kernel's faster reading counting: a first reading of ``{}`` slowed by
  a transient (1.6x, as one of PERF.md's replays) does not hand the
  cache to a candidate no faster on the second reading."""
  stencil = corpus.build('jacobi2d')
  shape = (256, 64)
  cands = autotune.candidate_configs(stencil, shape)
  first = {_label(c): 2e-3 for c in cands}
  first[_label({})] = 1.6e-3
  first[_label(cands[1])] = 1e-3
  seen = []

  def timer(stencil_, shape_, cfg, device='cuda', reps=autotune.REPS):
    seen.append(cfg)
    if len(seen) <= len(cands):
      return first[_label(cfg)]
    return second if cfg == {} else 1e-3

  monkeypatch.setattr(autotune, '_time_config', timer)
  cfg = autotune.tune(stencil, shape, cache_path=str(tmp_path / 't.json'))
  assert seen[len(cands):] == [{}, cands[1]]
  assert cfg == ({} if keeps else cands[1])
