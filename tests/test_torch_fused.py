"""The port's fused executor and tile plan against the JAX package.

On the CPU ``FusedExecutor`` runs the kernel's plain PyTorch version
over the kernel's own tiles; it must agree with the fused Pallas kernel
(interpret mode, as tests/test_pallas.py runs it) and with the NumPy
oracle on every corpus kernel. Each side builds its own stencil from
the same DSL text: the port's classes are its own. Forced tile plans
exercise the kernel's geometry: ragged last tiles, odd extents, one
tile, nonzero store offsets. The same cases run through the generated CUDA kernel itself in
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from soda_tpu import corpus as jax_corpus
from soda_tpu.backend import reference as jax_reference
from soda_tpu.backend.pallas_kernel import PallasExecutor
from soda_tpu_torch import corpus, utils
from soda_tpu_torch.api import build_stencil
from soda_tpu_torch.backend import reference
from soda_tpu_torch.backend.fused import FusedExecutor, fused_stencil_plain
from soda_tpu_torch.backend.tile_plan import (CTA_SMEM_RESERVED,
                                               MAX_TILE_CELLS, SM_SMEM,
                                               SMEM_LIMIT, candidate_tiles,
                                               make_tile_plan)
from soda_tpu_torch.testing import (CELLS, CONV_PARAM, GEOMETRY_CASES,
                                    MULTI_OUTPUT, build_cell, check_outputs)

torch.set_num_threads(1)


@pytest.mark.parametrize('name', sorted(corpus.CORPUS))
def test_corpus_matches_pallas_and_oracle(name):
  stencil = corpus.build(name)
  jax_stencil = jax_corpus.build(name)  # the same text, the JAX classes
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  want = jax_reference.run(jax_stencil, inputs, params)
  pallas = PallasExecutor(jax_stencil, shape, interpret=True)(inputs, params)
  got = FusedExecutor(stencil, shape, device='cpu')(inputs, params)
  got = {k: v.numpy() for k, v in got.items()}
  check_outputs(stencil, shape, got, want, name)
  check_outputs(stencil, shape, got, pallas, name + ' vs pallas')


@pytest.mark.parametrize('name,shape,tile', GEOMETRY_CASES)
def test_tile_geometry(name, shape, tile):
  stencil = corpus.build(name)
  inputs = reference.make_test_inputs(stencil, shape, seed=7)
  want = reference.run(stencil, inputs)
  plan = make_tile_plan(stencil, shape, tile)
  args = FusedExecutor(stencil, shape, device='cpu').prepare(inputs)
  tiled = fused_stencil_plain(stencil, args, tile=plan)
  whole = fused_stencil_plain(stencil, args)
  for k, out in enumerate(stencil.output_names):
    region = reference.output_valid_slices(stencil, shape, out)
    np.testing.assert_array_equal(tiled[k].numpy()[region],
                                  whole[k].numpy()[region])
  check_outputs(stencil, shape,
                 {o: t.numpy() for o, t in zip(stencil.output_names, tiled)},
                 want, '%s tile %s' % (name, tile))


def test_multi_output_reading_an_output():
  stencil = build_stencil(MULTI_OUTPUT)
  shape = (29, 35)
  inputs = reference.make_test_inputs(stencil, shape, seed=3)
  want = reference.run(stencil, inputs)
  for tile in (None, (4, 8), (29, 64)):
    got = FusedExecutor(stencil, shape, device='cpu', tile=tile)(inputs)
    check_outputs(stencil, shape, {k: v.numpy() for k, v in got.items()},
                   want, 'multi-output tile %s' % (tile,))


def test_params():
  stencil = build_stencil(CONV_PARAM)
  shape = (24, 64)
  inputs = reference.make_test_inputs(stencil, shape)
  params = reference.make_test_params(stencil)
  want = reference.run(stencil, inputs, params)
  got = FusedExecutor(stencil, shape, device='cpu', tile=(8, 16))(inputs,
                                                                   params)
  check_outputs(stencil, shape, {k: v.numpy() for k, v in got.items()},
                 want, 'param')


@pytest.mark.parametrize('name', ['blur', 'jacobi2d'])
def test_border_preserve(name):
  stencil = corpus.build(name, border='preserve')
  shape = corpus.TEST_DIMS[name]
  inputs = reference.make_test_inputs(stencil, shape)
  want = reference.run(stencil, inputs)
  got = FusedExecutor(stencil, shape, device='cpu')(inputs)
  check_outputs(stencil, shape, {k: v.numpy() for k, v in got.items()},
                 want, name + ':preserve', full=True)


@pytest.fixture(scope='module')
def bench_plans():
  plans = {}
  for name, shape, overrides in CELLS:
    plans[name] = make_tile_plan(build_cell(name, overrides), shape)
  return plans


@pytest.mark.parametrize('name', [c[0] for c in CELLS])
def test_bench_cells_fit_shared_memory(bench_plans, name):
  plan = bench_plans[name]
  assert 0 < plan.smem_bytes <= SMEM_LIMIT
  # the short form's tiles come from its swept candidates, up to 256 wide
  assert plan.tile[-1] <= (256 if plan.short is not None else 128)
  assert all(t & (t - 1) == 0 for t in plan.tile)  # powers of two
  # every buffer lies inside the block's shared memory
  for tensor, offset in plan.offsets.items():
    cells = int(np.prod(plan.extent(tensor)))
    size = cells * plan.dtype(tensor).np_dtype.itemsize
    assert offset % 16 == 0 and offset + size <= plan.smem_bytes


def test_liveness_reuses_buffers(bench_plans):
  """contrast's reuse chain: its 114 stage buffers would not fit side by
  side at the chosen tile; reused by liveness they do, in the default
  form (one stage a barrier) and in the many-stage form that is
  contrast's default kernel."""
  deep = bench_plans['contrast']
  name, shape, overrides = next(c for c in CELLS if c[0] == 'contrast')
  plan = make_tile_plan(build_cell(name, overrides), shape, _deep=())
  sizes = sum(int(np.prod(plan.extent(t))) * 4 for t in plan.offsets)
  assert len(plan.stages) > 100
  assert plan.smem_bytes <= SMEM_LIMIT < sizes
  sizes = sum(int(np.prod(deep.extent(t))) * 4 for t in deep.offsets)
  assert deep.deep is not None
  assert deep.smem_bytes + CTA_SMEM_RESERVED <= SM_SMEM
  assert deep.smem_bytes <= SMEM_LIMIT < sizes


@pytest.mark.parametrize('shape,max_cells', [((8192, 2048), MAX_TILE_CELLS),
                                             ((2048, 32, 128), MAX_TILE_CELLS),
                                             ((8192, 2048), 1 << 20),
                                             ((5, 300), MAX_TILE_CELLS)])
def test_candidate_tiles(shape, max_cells):
  """The minor axis doubles first up to 128; then the tile grows one
  doubling at a time within the grid's extents and the cell cap."""
  tiles = candidate_tiles(shape, max_cells)
  assert tiles[0] == (1,) * len(shape)
  caps = [min(128, 1 << (s - 1).bit_length())
          for s in shape[-1:]] + [1 << (s - 1).bit_length()
                                  for s in shape[:-1]]
  for prev, tile in zip(tiles, tiles[1:]):
    grown = [a for a in range(len(shape)) if tile[a] != prev[a]]
    assert len(grown) == 1 and tile[grown[0]] == 2 * prev[grown[0]]
    assert int(np.prod(tile)) <= max(max_cells, 128)
    if grown[0] != len(shape) - 1:
      assert prev[-1] == caps[0]  # the minor axis is full first
  assert tiles[-1][-1] == caps[0]
  assert all(t <= c for t, c in zip(tiles[-1][:-1], caps[1:]))


def test_too_wide_a_window_is_refused():
  stencil = build_stencil('''
kernel: wide
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 float: x(512, *)
output dram 1 float: y(0, 0) = x(0, 0) + x(300, 300)
''')
  with pytest.raises(utils.InputError, match='shared memory'):
    make_tile_plan(stencil, (400, 400))
