#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py

The main path: DSL text -> soda_tpu_torch.build_stencil (the port's own
front half: parser, passes, fusion plan) -> soda_tpu_torch.get_executor
-> one generated CUDA C++ kernel per stencil. Beside it, grouped
execution (``cluster: coarse``: one kernel per stage group), replicated
execution (R grids in one launch), the command line, the whole-grid
executor, sharded execution over a device mesh (the fused kernel per
halo-extended shard), the kernel's modes and layout forms and the
tools. Phases, each printing one line per step with its
seconds:

1. device: a CUDA device is required (no CPU fallback); prints the card,
   its power limit and the toolchain; neither jax nor the JAX package
   may be loaded (checked again at the end).
2. build: builds the 12 cells of the stencil benchmark (the 11 corpus
   kernels plus jacobi3d at 256^3, with the benchmark's shapes and
   stencil overrides), the grouped cells' per-group kernels, the small
   replicated grid's kernel and the sharded cells' kernels at their
   halo-extended shard shapes, the mode, tuner, layout and gate kernels,
   the five hand-written probe sources (``probes.SOURCES``) and the fused
   kernels phases 17 and 18 run: one nvcc per source, all at once. Each
   cell must dispatch to the fused kernel under 'auto'.
3. main path: every cell once through ``executor(inputs)``, with every
   launch counter reset just before and read just after.
4. kernel vs plain: each kernel against its plain PyTorch version
   (``fused_stencil_plain``, whole grid as one tile) on the same card,
   on every output's valid region: integers bit-exact, floats within the
   reference's squared-error threshold (1e-4; contrast 1e-3).
5. oracle: blur at (8192, 2048) bit-exact against the NumPy oracle.
6. times: CUDA-event times of kernel and plain version per cell, each
   call from a cold L2 cache (median, and the kernel's quartiles), the
   unique-traffic rate (inputs read once, outputs written once) and the
   bound (that traffic over the card's spec memory rate, or the
   operations over its float32 rate, whichever is larger).
7. host: per cell, the host's microseconds to enqueue one ``executor.fn``
   call against the device's microseconds per call, over 200
   back-to-back calls (warm L2): whether the host holds the card back.
8. grouped: blur, sobel2d, denoise2d and heat3d under ``cluster: coarse``
   at their benchmark shapes through ``get_executor``, counters reset
   just before: one launch per group; held against the ungrouped plain
   version and the grouped plain version on the original valid regions;
   blur bit-exact against the NumPy oracle; times.
9. replicated: blur, jacobi2d and heat3d with R = 4 at their benchmark
   shapes, each replica its own inputs, and blur at (1024, 2048) with
   R = 16: one launch per call, each replica against the plain version;
   times, and the R = 16 launch against 16 single launches.
   Then blur at (1024, 2048) with R = 16 on a (4,) mesh that repeats the
   card: one launch of 4 grids per mesh entry, every replica == plain.
10. CLI: ``python -m soda_tpu_torch FILE --run`` for blur (``--bench``),
   denoise2d (``--cluster coarse``), jacobi2d (``--backend replicated
   --replication-factor 4``, and ``--backend xla``) and blur
   (``--backend sharded`` on the default mesh: the visible cards, the
   fused kernel per shard) at (8192, 2048): each exits 0, prints
   ``INFO: PASS!`` and reports its kernel launches: none for
   ``--backend xla``, at least one for every other run.
11. whole-grid: the 12 cells through ``get_executor(..., 'xla')`` (the
   plain version over the whole grid, no kernel of ours): held against
   the cell's kernel output and its plain version; cold-L2 median
   beside the kernel's, the host's against the device's microseconds per call back
   to back, and the operations per call that make the host wait for the
   card (``profiling.sync_count``).
12. sharded: the ``testing.SHARDED`` cells at the benchmark shapes on
   meshes that repeat the card, through ``get_executor(..., 'sharded')``
   with each counter reset just before its run and read just after:
   launches == shards x groups (0 for the whole-grid inner); outputs
   finite and held against ``fused_stencil_plain`` on the unsharded
   grid; blur bit-exact against the NumPy oracle; overlap 'on' (the JAX
   package's mode, here the same exchange) equal to 'off' bit for bit;
   times beside the unsharded kernel's, and host
   against device microseconds per call back to back (whether the
   host's enqueueing of the per-shard operations holds the card back),
   and the synchronising operations per call.

13. kernel modes: the ``testing.MODE_CELLS`` at the benchmark shapes
   (the streaming loop plain and peeled, the deep cp.async ring, split
   fills, staged stores) through ``get_executor(..., **options)``, each
   counter reset just before its run and read just after: one launch per
   call; held against the mode's plain version (``streamed_stencil_plain``,
   the kernel's walk: runs of tiles, rolling windows) and against
   ``fused_stencil_plain`` over the whole grid; blur bit-exact against the
   NumPy oracle; the cold-L2 median beside the default kernel's, the bound
   and its share, back-to-back device microseconds, CTAs and steps per CTA.
14. tools: ``tune`` on blur and jacobi3d with a cache under
   ``build/chip_smoke/`` (the winner and its time against the default
   kernel's; a second call probes nothing); ``python -m
   soda_tpu_torch.tools.gpu_validate --variants`` (every row PASS, the
   contrast float64-truth check included); ``compiled_stats`` of the blur
   and contrast kernels (registers and CTAs per SM from the card); and the
   CLI with ``--kernel-opt stream_loop=peel --kernel-opt prefetch=3``
   (jacobi3d), ``--tune``, ``--compile-stats -`` and ``--backend sharded
   --kernel-opt stream_loop=peel`` (blur), each exiting 0 with ``INFO:
   PASS!`` and at least one kernel launch.
15. layout forms: the JAX package's 24 bench seed configurations
   (``testing.SEED_CONFIGS``; 17 carry a layout key: value stages in
   registers (L1), transposed lane regions (L2)), its gate's only
   ``narrow`` row (packed 16-bit stages, L3) and chunked stage loops
   (L4) at the benchmark shapes, through ``get_executor(..., **seed)``,
   each counter reset just before its run and read just after: one
   launch per call; bit for bit equal to the cell's default kernel and
   to the form's plain version (``layout_stencil_plain``) on the card
   (a seed without layout keys: within the threshold of its own
   whole-grid plain version), with the largest error measured; blur
   bit-exact against the NumPy oracle; the cold-L2 median beside
   the default kernel's, bound and share, the plain version's time,
   back-to-back device microseconds, and the registers, spills and CTAs
   per SM the card reports.
16. experiments: the H100 counterparts of the JAX package's experiment
   probes (exp27, exp30: the streaming probe; exp24, exp45: the chain
   probe; built in phase 2's nvcc batch). Their entry
   points (``soda_tpu_torch.experiments.<name>.run``) with every probe
   counter reset just before and read just after: each of the 13
   streaming cases at 256^3 float32 (held against x + 1; cold-L2 ms,
   share of the byte bound, microseconds per step per CTA and back to
   back) and each of the 37 chain bodies (kernel against its plain
   version at 1, 2, 5 and CHAIN_N_SMALL iterations, microseconds per
   iteration as the slope from CHAIN_N_SMALL to CHAIN_N_BIG, grid
   barriers, the operation bound; exp24's shift chains run in the narrow
   probe's strip kernel); each entry point is one run, so a case's
   launches are its own. Then each streaming case against
   ``stream_probe_plain`` (walking the card's schedule) bit for bit
   beside ``torch.add``'s time, and each chain body against
   ``chain_probe_plain`` at 1, 2, 5 and CHAIN_N_SMALL iterations (int32
   bit-exact, float32 within ``probes.CHAIN_RTOL`` relative; the largest
   error is the record's).
17. narrow: the 16-bit and op-rate probes (exp13, exp29, exp16, exp12,
   exp2, exp1: the narrow probe, ``csrc/probe_narrow.cu``). Each entry
   point's ``run`` with every probe counter reset just before and read
   just after: its 67 bodies on the scripts' inputs, each kernel against
   its plain version (a chain at 1, 2, 5 and the script's n_small
   iterations), a one-shot body's cold-L2 ms and host and device µs a
   call back to back, a chain's µs per iteration (the slope between the
   script's n_small and n_big; exp2's n_big raised), ps per element-op,
   the bound (the least operations each body's function needs, or the
   bytes its taps read) and share, which may not exceed
   ``narrow.MAX_SHARE``, the plain version's and the library call's
   time, the SASS (registers, spills, instructions, a register chain's
   main loop); exp16's packed
   kernels equal to its wide one; exp2's copy stencil and exp1's four
   cases in both stage modes through ``get_executor`` (value bit for
   bit against vmem on the valid regions), each launched. Every body
   launched, no kernel spills, every register chain's main loop holding
   the instructions of each of its iterations (none folded). Then each
   body's kernel against
   ``NarrowBody.plain`` again (integers bit for bit, float32 within
   ``probes.CHAIN_RTOL``; the record's error).
18. copyshift: exp32's copy-shift probe (``csrc/probe_copy.cu``: a
   shared-memory slab copied into another at an offset by
   ``cp.async.bulk`` with ``mbarrier`` completion, as a shift; its rotate
   controls in the narrow probe's strip kernel) and exp9's 2.5-D jacobi
   (``csrc/probe_25d.cu``). Each entry point's ``run`` (exp32's main and
   check cases, exp9) with every probe counter reset just before and read
   just after: the 11 main and 8 check cases of exp32 on the script's
   blocks, each kernel bit for bit against its stale-tail plain version
   at 1, 2, 5 and 64 iterations (the check cases at 3 too), µs per
   iteration (the slope 64 -> 2048), the bound (shared-memory bytes at
   128 B a clock an SM, or operations) and its share, which may not
   exceed ``narrow.MAX_SHARE``; exp9's correctness line at (64, 16, 128)
   (bit for bit, the oracle within 1e-4), its kernel at (8192, 16, 128)
   for blocks 256, 512 and 1024 bit for bit on rows [2, h-2), and the
   port's jacobi2d kernel at block_rows 256, 512 and its default, each
   with its cold-L2 ms, share of the byte bound, back-to-back µs and the
   plain version's time. Every case launched, no kernel spills, the
   overlap kernel's chain B between its copy's issue and its wait in the
   SASS, the store control's reloads not forwarded.

The last three lines are the card's name and power limit as nvidia-smi
prints them, a JSON object with each kernel's record (``{"kernels":
...}``: the fused kernel's per cell, mode and layout row, and each
probe case and body, ``probe_stream``, ``probe_chain``,
``probe_narrow``, ``probe_copy`` and ``probe_25d``), and ``{"ok": true,
"device": ...}``. Any failure raises and exits nonzero. Inputs are made from seeded numpy (make_test_inputs).
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

FLAGSHIP = 'blur'
KERNEL_REPS = 20
PLAIN_REPS = 5
HOST_CALLS = 200
WHOLE_GRID_CALLS = 50
GROUPED = ('blur', 'sobel2d', 'denoise2d', 'heat3d')
REPLICATED = ('blur', 'jacobi2d', 'heat3d')
REPLICAS = 4
SMALL_SHAPE, SMALL_REPLICAS = (1024, 2048), 16
CLI_SHAPE = '8192,2048'
MESH_REPLICAS = (4,)
CLI_RUNS = (
    ('blur', ['--bench']),
    ('denoise2d', ['--cluster', 'coarse']),
    ('jacobi2d', ['--backend', 'replicated', '--replication-factor',
                  str(REPLICAS)]),
    ('jacobi2d', ['--backend', 'xla']),
    ('blur', ['--backend', 'sharded']),
)
# (cell, flags): the tools' command lines, at the cell's shape
TOOL_CLI_RUNS = (
    ('jacobi3d', ['--kernel-opt', 'stream_loop=peel', '--kernel-opt',
                  'prefetch=3']),
    ('blur', ['--tune']),
    ('blur', ['--compile-stats', '-']),
    ('blur', ['--backend', 'sharded', '--kernel-opt', 'stream_loop=peel']),
)
TUNED = ('blur', 'jacobi3d')
COMPILED = ('blur', 'contrast')
# the chain probes' iterations: timed from N_SMALL (checked there too,
# and at probes.CHECK_ITERS), slope to N_BIG (the scripts' 16384 would
# take minutes here)
CHAIN_N_SMALL, CHAIN_N_BIG = 64, 2048


def say(*parts):
  print(*parts, flush=True)


def no_jax_loaded():
  for name in ('jax', 'soda_tpu'):
    if name in sys.modules:
      raise RuntimeError('the port loaded %s' % name)


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this check runs only on a GPU',
          file=sys.stderr)
    return 1
  here = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, here)
  import numpy as np

  import soda_tpu_torch
  from soda_tpu_torch import corpus, profiling, testing
  from soda_tpu_torch.backend import build, cuda_source, grouped
  from soda_tpu_torch.backend.fused import (FusedExecutor,
                                            fused_stencil_plain,
                                            layout_stencil_plain,
                                            replicated_stencil_plain,
                                            streamed_stencil_plain)
  from soda_tpu_torch.backend.tile_plan import kernel_plan, make_tile_plan
  from soda_tpu_torch.experiments import (exp1_value_mode, exp2_diag,
                                          exp12_mosaic_reprobe,
                                          exp13_narrow_i16,
                                          exp16_swar_erosion,
                                          exp24_stage_tax, exp27_gridloop,
                                          exp29_pack_i16,
                                          exp30_dma_granularity,
                                          exp32_dma_shift,
                                          exp45_transcendental_tax,
                                          exp9_layout25d, copyshift,
                                          layout25d, narrow)
  from soda_tpu_torch.experiments import probes as exp_probes
  from soda_tpu_torch.model.compiled import compiled_stats
  from soda_tpu_torch.parallel import replicate, spmd
  from soda_tpu_torch.tools import autotune, gpu_validate

  # 1. device
  t0 = t_start = time.time()
  report = profiling.device_report()
  no_jax_loaded()
  say('[device] %s | torch %s | cuda %s | %s (%.1fs)' % (
      report['device'], report['torch'], report['cuda'], report['nvcc'],
      time.time() - t0))
  smi = report['nvidia_smi']
  say(smi)

  def record(name, source, replaces, launches, err, ms, plain_ms, stencil,
             shape, grids=1):
    bound, bound_by = profiling.bound_ms(stencil, shape, grids)
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'library_ms': None}

  def times(fn, plain):
    k_ms = profiling.cuda_times_ms(fn, reps=KERNEL_REPS)
    p_ms = profiling.cuda_times_ms(plain, reps=PLAIN_REPS, warmup=1)
    return k_ms, statistics.median(k_ms), statistics.median(p_ms)

  # 2. build: every stencil first, then one nvcc per kernel source, all
  # started together, then the executors (which find their libraries)
  t_build = time.time()
  stencils, sources = {}, []
  for name, shape, overrides in testing.CELLS:
    t = time.time()
    stencils[name] = testing.build_cell(name, overrides)
    sources.append(cuda_source.generate(make_tile_plan(stencils[name],
                                                       shape)))
    say('[build] %-12s %-16s stencil %.1fs' % (name, shape, time.time() - t))
  overrides_of = {name: ov for name, _, ov in testing.CELLS}
  shape_of = {name: shape for name, shape, _ in testing.CELLS}
  coarse = {}
  for name in GROUPED:
    coarse[name] = testing.build_cell(name, dict(overrides_of[name],
                                                 cluster='coarse'))
    _, subs = grouped.group_stencils(coarse[name])
    sources += [cuda_source.generate(make_tile_plan(sub, shape_of[name]))
                for sub in subs]
  small = testing.build_cell(FLAGSHIP, overrides_of[FLAGSHIP])
  sources.append(cuda_source.generate(make_tile_plan(small, SMALL_SHAPE)))
  card = torch.device('cuda', 0)

  def sharded_stencil(name, inner):
    return coarse[name] if inner == 'grouped' else stencils[name]

  for name, mesh_shape, inner, _ in testing.SHARDED:
    if inner == 'xla':
      continue
    stencil = sharded_stencil(name, inner)
    ext = spmd.geometry(stencil, shape_of[name],
                        testing.repeated_mesh(card, mesh_shape))[-1]
    subs = (grouped.group_stencils(stencil)[1] if inner == 'grouped'
            else [stencil])
    sources += [cuda_source.generate(make_tile_plan(sub, ext))
                for sub in subs]
  # the kernel modes, and every configuration the tuner probes
  sources += [cuda_source.generate(kernel_plan(stencils[name], shape_of[name],
                                               **opts))
              for name, opts in testing.MODE_CELLS]
  for name in TUNED:
    sources += [cuda_source.generate(kernel_plan(stencils[name],
                                                 shape_of[name], **cfg))
                for cfg in autotune.candidate_configs(stencils[name],
                                                      shape_of[name])]
  # the layout forms: the JAX package's seeds and the narrow row (their
  # stencils are the cells' but for the extra rows' overrides), and the
  # default kernels of the extra rows' stencils
  layout_rows = []
  for name, shape, overrides, opts in (testing.SEED_CONFIGS +
                                       testing.LAYOUT_EXTRA):
    stencil = (stencils[name] if overrides == overrides_of[name] else
               testing.build_cell(name, overrides))
    if stencil is not stencils[name]:
      sources.append(cuda_source.generate(make_tile_plan(stencil, shape)))
    layout_rows.append((name, shape, stencil, opts))
    sources.append(cuda_source.generate(kernel_plan(stencil, shape, **opts)))
  # the validation gate's kernels (phase 14 runs it; it finds them built)
  gate_stencils = {}
  for _, name, variants, opts in gpu_validate.cases(True):
    sources += gpu_validate.sources(name, variants, opts, gate_stencils)
  sources += gpu_validate.sources('contrast', gpu_validate.F64_VARIANTS,
                                  cache=gate_stencils)
  # the experiment probes' hand-written sources (phases 16-18), and the
  # fused kernels exp1 and exp2 run (phase 17): the four CASES in value
  # mode (their vmem mode is the cells' default kernel), the copy stencil
  sources += [build.csrc_source(name) for name in exp_probes.SOURCES]
  for name, shape, overrides in exp1_value_mode.CASES:
    sources.append(cuda_source.generate(kernel_plan(
        testing.build_cell(name, overrides), shape, stage_mode='value')))
  for dtype in exp2_diag.COPY_TYPES:
    sources.append(cuda_source.generate(kernel_plan(
        exp2_diag.copy_stencil(dtype, exp2_diag.COPY_SHAPE),
        exp2_diag.COPY_SHAPE, block_rows=exp2_diag.BLOCK_ROWS)))
  # exp9's comparison rows (phase 18): the jacobi2d kernel at its block_rows
  exp9_stencil = corpus.build('jacobi2d', tile_size=exp9_layout25d.JACOBI_TILE)
  for block_rows in exp9_layout25d.JACOBI_BLOCK_ROWS:
    sources.append(cuda_source.generate(
        kernel_plan(exp9_stencil, exp9_layout25d.JACOBI_SHAPE,
                    block_rows=block_rows) if block_rows else
        make_tile_plan(exp9_stencil, exp9_layout25d.JACOBI_SHAPE)))
  sources = list({src.digest: src for src in sources}.values())
  t = time.time()
  build.build_all(sources)
  say('[build] nvcc: %d kernels at once (%.1fs)' % (len(sources),
                                                    time.time() - t))
  cells = []
  for name, shape, overrides in testing.CELLS:
    stencil = stencils[name]
    ex = soda_tpu_torch.get_executor(stencil, shape)
    if not isinstance(ex, FusedExecutor):
      raise RuntimeError('%s: auto did not dispatch to the fused kernel' %
                         name)
    say('[build] %-12s %-16s tile %-14s smem %6d B  %5d CTAs' % (
        name, shape, ex.plan.tile, ex.plan.smem_bytes, ex.plan.n_tiles))
    inputs = testing.make_test_inputs(stencil, shape)
    params = testing.make_test_params(stencil)
    cells.append((name, shape, stencil, ex, inputs, params))
  by_name = {c[0]: c for c in cells}
  say('[build] all %d cells (%.1fs)' % (len(cells), time.time() - t_build))

  # 3. main path: one run per cell through the user's entry point
  for cell in cells:
    cell[3].launches = 0
  results = {}
  t = time.time()
  for name, shape, stencil, ex, inputs, params in cells:
    results[name] = ex(inputs, params)
    torch.cuda.synchronize()
  launches = {cell[0]: cell[3].launches for cell in cells}
  say('[main] %s (%.1fs)' % (launches, time.time() - t))
  for name, count in launches.items():
    if count < 1:
      raise RuntimeError('%s: the main path launched no kernel' % name)

  def check_finite(stencil, shape, got, context):
    for out in stencil.output_names:
      region = testing.output_valid_slices(stencil, shape, out)
      if (stencil.symbol_table[out].is_float and
          not bool(torch.isfinite(got[out][region]).all())):
        raise RuntimeError('%s:%s: non-finite kernel output' % (context, out))

  # 4. kernel vs plain version on the card
  errors, plains = {}, {}
  for name, shape, stencil, ex, inputs, params in cells:
    t = time.time()
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    plain = fused_stencil_plain(stencil, args[:n_in], args[n_in:], tile=None)
    torch.cuda.synchronize()
    got = results[name]
    check_finite(stencil, shape, got, name)
    plains[name] = dict(zip(stencil.output_names, plain))
    worst = testing.check_outputs(stencil, shape, got, plains[name], name)
    errors[name] = worst
    say('[check] %-12s kernel == plain (max |err| %.3g) (%.1fs)' % (
        name, worst, time.time() - t))

  # 5. the flagship against the NumPy oracle
  t = time.time()
  name, shape, stencil, _, inputs, _ = by_name[FLAGSHIP]
  oracle = testing.oracle_run(stencil, inputs)

  def check_oracle(got, context):
    for out in stencil.output_names:
      region = testing.output_valid_slices(stencil, shape, out)
      if not np.array_equal(got[out].cpu().numpy()[region],
                            oracle[out][region]):
        raise RuntimeError('%s:%s differs from the NumPy oracle' % (
            context, out))

  check_oracle(results[name], name)
  say('[oracle] %s %s bit-exact vs the NumPy oracle (%.1fs)' % (
      name, shape, time.time() - t))

  # 6. times
  kernels, kernel_ms, plain_ms_of = [], {}, {}
  for name, shape, stencil, ex, inputs, params in cells:
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    k_ms, ms, plain_ms = times(
        lambda: ex.fn(*args),
        lambda: fused_stencil_plain(stencil, args[:n_in], args[n_in:]))
    q1, _, q3 = statistics.quantiles(k_ms, n=4)
    kernel_ms[name], plain_ms_of[name] = ms, plain_ms
    in_b, out_b = profiling.stream_bytes(stencil, shape)
    kernels.append(record('fused_stencil[%s]' % name,
                          'soda_tpu_torch/backend/cuda_source.py',
                          cuda_source.REPLACES, launches[name], errors[name],
                          ms, plain_ms, stencil, shape))
    say('[time] %-12s kernel %.4f ms (quartiles %.4f-%.4f, n=%d)  plain '
        '%.3f ms (n=%d)  %.1f GB/s unique traffic  bound %.4f ms (%s) | %s'
        % (name, ms, q1, q3, len(k_ms), plain_ms, PLAIN_REPS,
           (in_b + out_b) / ms / 1e6, kernels[-1]['bound_ms'],
           kernels[-1]['bound_by'], smi))
    torch.cuda.synchronize()

  # 7. host against device, back to back
  for name, shape, stencil, ex, inputs, params in cells:
    args = ex.prepare(inputs, params)
    host_us, device_us = profiling.back_to_back_us(lambda: ex.fn(*args),
                                                   calls=HOST_CALLS)
    say('[host] %-12s host %.1f us/call  device %.1f us/call  (%s, n=%d) '
        '| %s' % (name, host_us, device_us,
                  'host-bound' if host_us >= device_us else 'device-bound',
                  HOST_CALLS, smi))

  # 8. grouped: one kernel per stage group, handing off through memory
  groups, grouped_ms = {}, {}
  for name in GROUPED:
    groups[name] = soda_tpu_torch.get_executor(coarse[name], shape_of[name])
    if not isinstance(groups[name], grouped.GroupedExecutor):
      raise RuntimeError('%s: cluster: coarse did not dispatch to the '
                         'grouped executor' % name)
  for ex in groups.values():
    ex.launches = 0
  t = time.time()
  got_groups = {}
  for name, ex in groups.items():
    _, shape, _, _, inputs, params = by_name[name]
    got_groups[name] = ex(inputs, params)
    torch.cuda.synchronize()
  launches_g = {name: ex.launches for name, ex in groups.items()}
  say('[grouped] launches %s (%.1fs)' % (launches_g, time.time() - t))
  for name, ex in groups.items():
    _, shape, _, _, inputs, params = by_name[name]
    stencil = coarse[name]
    if launches_g[name] != len(ex.plan.groups):
      raise RuntimeError('%s: %d launches for %d groups' % (
          name, launches_g[name], len(ex.plan.groups)))
    got = got_groups[name]
    check_finite(stencil, shape, got, name + ' grouped')
    testing.check_outputs(stencil, shape, got, plains[name],
                          name + ' grouped vs ungrouped plain')
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    plain = grouped.grouped_stencil_plain(stencil, args[:n_in], args[n_in:])
    err = testing.check_outputs(stencil, shape, got,
                                dict(zip(stencil.output_names, plain)),
                                name + ' grouped')
    if name == FLAGSHIP:
      check_oracle(got, name + ' grouped')
    _, ms, plain_ms = times(
        lambda: ex.fn(*args),
        lambda: grouped.grouped_stencil_plain(stencil, args[:n_in],
                                              args[n_in:]))
    grouped_ms[name] = ms
    kernels.append(record('fused_stencil_grouped[%s]' % name,
                          'soda_tpu_torch/backend/grouped.py',
                          grouped.REPLACES, launches_g[name], err, ms,
                          plain_ms, stencil, shape))
    say('[grouped] %-10s %d groups, %d launches: == ungrouped plain and '
        '== grouped plain (max |err| %.3g)%s  kernels %.4f ms  plain %.3f '
        'ms  bound %.4f ms | %s' % (
            name, len(ex.plan.groups), launches_g[name], err,
            ', bit-exact vs the NumPy oracle' if name == FLAGSHIP else '',
            ms, plain_ms, kernels[-1]['bound_ms'], smi))

  # 9. replicated: R grids as the kernel's second grid axis
  reps = {}
  for name in REPLICATED:
    _, shape, stencil, _, _, params = by_name[name]
    grids = testing.replica_inputs(stencil, shape, REPLICAS)
    batch = {n: np.stack([g[n] for g in grids]) for n in stencil.input_names}
    ex = soda_tpu_torch.get_executor(stencil, shape, 'replicated',
                                     replication_factor=REPLICAS)
    reps[name] = (stencil, shape, ex, batch, params, REPLICAS)
  small_grids = testing.replica_inputs(small, SMALL_SHAPE, SMALL_REPLICAS)
  small_batch = {n: np.stack([g[n] for g in small_grids])
                 for n in small.input_names}
  small_name = '%s_%dx%d_r%d' % ((FLAGSHIP,) + SMALL_SHAPE +
                                 (SMALL_REPLICAS,))
  reps[small_name] = (small, SMALL_SHAPE, soda_tpu_torch.get_executor(
      small, SMALL_SHAPE, 'replicated', replication_factor=SMALL_REPLICAS),
                      small_batch, {}, SMALL_REPLICAS)
  for rep in reps.values():
    rep[2].launches = 0
  t = time.time()
  got_reps = {}
  for name, (_, _, ex, batch, params, _) in reps.items():
    got_reps[name] = ex(batch, params)
    torch.cuda.synchronize()
  launches_r = {name: rep[2].launches for name, rep in reps.items()}
  say('[replicated] launches %s (%.1fs)' % (launches_r, time.time() - t))
  for name, (stencil, shape, ex, batch, params, r) in reps.items():
    if launches_r[name] != 1:
      raise RuntimeError('%s: %d launches for one replicated call' % (
          name, launches_r[name]))
    args = ex.prepare(batch, params)
    n_in = len(stencil.input_names)
    plain = dict(zip(stencil.output_names,
                     replicated_stencil_plain(stencil, args[:n_in],
                                              args[n_in:])))
    got = got_reps[name]
    err = 0.0
    for k in range(r):
      got_k = {o: v[k] for o, v in got.items()}
      check_finite(stencil, shape, got_k, '%s replica %d' % (name, k))
      err = max(err, testing.check_outputs(
          stencil, shape, got_k, {o: v[k] for o, v in plain.items()},
          '%s replica %d' % (name, k)))
    _, ms, plain_ms = times(
        lambda: ex.fn(*args),
        lambda: replicated_stencil_plain(stencil, args[:n_in], args[n_in:]))
    kernels.append(record('fused_stencil_replicated[%s]' % name,
                          'soda_tpu_torch/parallel/replicate.py',
                          replicate.REPLACES, launches_r[name], err, ms,
                          plain_ms, stencil, shape, grids=r))
    say('[replicated] %-22s R=%d %s: 1 launch, every replica == plain (max '
        '|err| %.3g)  kernel %.4f ms  plain %.3f ms  bound %.4f ms | %s' % (
            name, r, shape, err, ms, plain_ms, kernels[-1]['bound_ms'], smi))
  # the small-grid regime replication exists for: one launch for 16
  # grids against 16 launches of the one-grid kernel, back to back
  _, _, ex_r, batch, _, _ = reps[small_name]
  args_r = ex_r.prepare(batch)
  ex_1 = soda_tpu_torch.get_executor(small, SMALL_SHAPE)
  singles = [ex_1.prepare(g) for g in small_grids]

  def sixteen():
    for a in singles:
      ex_1.fn(*a)

  one_ms = statistics.median(profiling.cuda_times_ms(lambda: ex_r.fn(*args_r),
                                                     reps=KERNEL_REPS))
  many_ms = statistics.median(profiling.cuda_times_ms(sixteen,
                                                      reps=KERNEL_REPS))
  _, one_us = profiling.back_to_back_us(lambda: ex_r.fn(*args_r), calls=50)
  _, many_us = profiling.back_to_back_us(sixteen, calls=50)
  say('[replicated] %s %s x %d: one launch %.4f ms vs %d launches %.4f ms '
      '(cold L2); back to back %.1f vs %.1f us per %d grids | %s' % (
          FLAGSHIP, SMALL_SHAPE, SMALL_REPLICAS, one_ms, SMALL_REPLICAS,
          many_ms, one_us, many_us, SMALL_REPLICAS, smi))
  # the same batch split over a mesh that repeats the card: one
  # replicated launch per entry of the mesh's first axis
  small_plain = replicated_stencil_plain(small, args_r)
  ex_m = soda_tpu_torch.get_executor(
      small, SMALL_SHAPE, 'replicated', replication_factor=SMALL_REPLICAS,
      mesh=testing.repeated_mesh(card, MESH_REPLICAS))
  ex_m.launches = 0
  t = time.time()
  got_m = ex_m(small_batch)
  torch.cuda.synchronize()
  launches_m = ex_m.launches
  if launches_m != MESH_REPLICAS[0]:
    raise RuntimeError('meshed replicated: %d launches on a %s mesh' % (
        launches_m, MESH_REPLICAS))
  err = 0.0
  for k in range(SMALL_REPLICAS):
    got_k = {o: v[k] for o, v in got_m.items()}
    check_finite(small, SMALL_SHAPE, got_k, 'mesh replica %d' % k)
    err = max(err, testing.check_outputs(
        small, SMALL_SHAPE, got_k,
        {o: v[k] for o, v in zip(small.output_names, small_plain)},
        '%s mesh replica %d' % (small_name, k)))
  args_m = ex_m.prepare(small_batch)
  _, ms, plain_ms = times(lambda: ex_m.fn(*args_m),
                          lambda: replicated_stencil_plain(small, args_r))
  kernels.append(record('fused_stencil_replicated[%s mesh %s]' % (
      small_name, MESH_REPLICAS), 'soda_tpu_torch/parallel/replicate.py',
                        replicate.REPLACES, launches_m, err, ms, plain_ms,
                        small, SMALL_SHAPE, grids=SMALL_REPLICAS))
  say('[replicated] %s on a %s mesh of %s: %d launches of %d grids, every '
      'replica == plain (max |err| %.3g)  kernels %.4f ms (one launch: %.4f '
      'ms)  plain %.3f ms  bound %.4f ms (%.1fs) | %s' % (
          small_name, MESH_REPLICAS, card, launches_m, ex_m.per_device, err,
          ms, one_ms, plain_ms, kernels[-1]['bound_ms'], time.time() - t,
          smi))

  # 10. the command line, as a user runs it
  cli_dir = os.path.join(here, 'build', 'chip_smoke')
  os.makedirs(cli_dir, exist_ok=True)
  # the tuner's default cache lies under HOME: keep it in the checkout
  env = dict(os.environ, PYTHONPATH=here, HOME=os.path.join(cli_dir, 'home'))

  def cli(runs, tag='cli'):
    """Run the command lines ``runs`` ((name, flags, shape, tile size))
    side by side, then check each: exit 0, INFO: PASS! and its kernel
    launches. A run that times the card (--bench, --tune) is given
    alone."""
    procs = []
    t = time.time()
    for i, (name, flags, shape, tile_size) in enumerate(runs):
      path = os.path.join(cli_dir, name + '.soda')
      with open(path, 'w') as f:
        f.write(corpus.CORPUS[name])
      cmd = [sys.executable, '-m', 'soda_tpu_torch', path, '--run',
             '--shape', shape, '--tile-size', tile_size] + flags
      log = open(os.path.join(cli_dir, '%s-%d.log' % (tag, i)), 'w+')
      procs.append((name, flags, cmd, log, subprocess.Popen(
          cmd, cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT,
          text=True)))
    for name, flags, cmd, log, proc in procs:
      code = proc.wait(timeout=600)
      log.seek(0)
      out = log.read()
      log.close()
      for line in out.strip().splitlines():
        say('[%s] %s: %s' % (tag, name, line))
      if code != 0 or 'INFO: PASS!' not in out:
        raise RuntimeError('%s: %s exited %d without INFO: PASS!' % (
            name, ' '.join(cmd[1:]), code))
      found = re.search(r', (\d+) kernel launches$', out, re.M)
      count = int(found.group(1)) if found else -1
      if count < 0 or (count == 0) != ('xla' in flags):
        raise RuntimeError('%s %s: %d kernel launches' % (
            name, ' '.join(flags), count))
      say('[%s] %s %s: exit 0, INFO: PASS!, %d kernel launches (%.1fs for '
          'the %d run(s) side by side) | %s' % (
              tag, name, ' '.join(flags), count, time.time() - t, len(runs),
              smi))

  def timing(flags):
    return '--bench' in flags or '--tune' in flags

  cli_tile = CLI_SHAPE.split(',')[1]
  cli([(name, flags, CLI_SHAPE, cli_tile) for name, flags in CLI_RUNS
       if not timing(flags)])
  for name, flags in CLI_RUNS:
    if timing(flags):
      cli([(name, flags, CLI_SHAPE, cli_tile)])

  # 11. the whole-grid executor: plain PyTorch on the card
  for name, shape, stencil, ex, inputs, params in cells:
    t = time.time()
    wex = soda_tpu_torch.get_executor(stencil, shape, 'xla')
    got = wex(inputs, params)
    torch.cuda.synchronize()
    check_finite(stencil, shape, got, name + ' whole-grid')
    testing.check_outputs(stencil, shape, got, results[name],
                          name + ' whole-grid vs kernel')
    err = testing.check_outputs(stencil, shape, got, plains[name],
                                name + ' whole-grid vs plain')
    args = wex.prepare(inputs, params)
    w_ms = statistics.median(profiling.cuda_times_ms(lambda: wex.fn(*args),
                                                     reps=KERNEL_REPS))
    host_us, device_us = profiling.back_to_back_us(lambda: wex.fn(*args),
                                                   calls=WHOLE_GRID_CALLS)
    syncs = profiling.sync_count(lambda: wex.fn(*args))
    del got, args
    say('[whole-grid] %-12s == kernel and == plain (max |err| %.3g)  %.4f ms '
        'against the kernel\'s %.4f ms (%.1fx); back to back host %.1f us, '
        'device %.1f us per call (n=%d); %d synchronising operations per '
        'call (%.1fs) | %s' % (
            name, err, w_ms, kernel_ms[name], w_ms / kernel_ms[name], host_us,
            device_us, WHOLE_GRID_CALLS, syncs, time.time() - t, smi))
  torch.cuda.empty_cache()

  # 12. sharded: the grid split over meshes that repeat the card
  offs = {}
  for name, mesh_shape, inner, overlap in testing.SHARDED:
    _, shape, _, _, inputs, params = by_name[name]
    stencil = sharded_stencil(name, inner)
    t = time.time()
    ex = soda_tpu_torch.get_executor(
        stencil, shape, 'sharded', inner=inner, overlap=overlap,
        mesh=testing.repeated_mesh(card, mesh_shape))
    label = '%s %s %s%s' % (name, mesh_shape, inner,
                            ' overlap' if overlap == 'on' else '')
    ex.launches = 0
    got = ex(inputs, params)
    torch.cuda.synchronize()
    count = ex.launches
    per_shard = {'fused': 1, 'xla': 0,
                 'grouped': len(grouped.group_stencils(stencil)[1])}[inner]
    if count != ex.n_shards * per_shard:
      raise RuntimeError('%s: %d launches for %d shards x %d kernels' % (
          label, count, ex.n_shards, per_shard))
    check_finite(stencil, shape, got, label)
    err = testing.check_outputs(stencil, shape, got, plains[name],
                                label + ' vs unsharded plain')
    exact = ''
    if name == FLAGSHIP:
      testing.check_outputs(stencil, shape, got, oracle, label + ' vs oracle')
      exact = ', bit-exact vs the NumPy oracle'
    if inner == 'xla' and overlap == 'off':
      offs[name] = got
    elif inner == 'xla':
      for out in stencil.output_names:
        if not torch.equal(got[out], offs[name][out]):
          raise RuntimeError('%s:%s differs from overlap off' % (label, out))
      exact = ', == overlap off bit for bit'
    args = ex.prepare(inputs, params)
    ms = statistics.median(profiling.cuda_times_ms(lambda: ex.fn(*args),
                                                   reps=KERNEL_REPS))
    host_us, device_us = profiling.back_to_back_us(lambda: ex.fn(*args),
                                                   calls=HOST_CALLS)
    syncs = profiling.sync_count(lambda: ex.fn(*args))
    unsharded = grouped_ms[name] if inner == 'grouped' else kernel_ms[name]
    bound, _ = profiling.bound_ms(stencil, shape)
    if inner != 'xla':
      kernels.append(record(
          'fused_stencil_sharded[%s %s]' % (name, mesh_shape),
          'soda_tpu_torch/parallel/spmd.py', spmd.REPLACES, count, err, ms,
          plain_ms_of[name], stencil, shape))
    del got, args
    say('[sharded] %-34s %d shards, ext %s, %d launches: == unsharded plain '
        '(max |err| %.3g)%s  %.4f ms  unsharded %.4f ms (%.2fx)  bound %.4f '
        'ms; back to back host %.1f us, device %.1f us per call (n=%d); %d '
        'synchronising operations per call (%.1fs) | %s' % (
            label, ex.n_shards, ex.ext_shape, count, err, exact, ms,
            unsharded, ms / unsharded, bound, host_us, device_us, HOST_CALLS,
            syncs, time.time() - t, smi))

  # 13. kernel modes: the streaming loop, the cp.async ring, split
  # fills and staged stores, each through the user's entry point
  modes = []
  for name, opts in testing.MODE_CELLS:
    ex = soda_tpu_torch.get_executor(stencils[name], shape_of[name], **opts)
    if not isinstance(ex, FusedExecutor) or ex.config.is_default:
      raise RuntimeError('%s %s: not a mode kernel' % (name, opts))
    plan = ex.plan
    say('[build] %-12s %-22s tile %-14s smem %6d B  %4d CTAs x %d steps, %d '
        'slot(s)%s' % (name, cuda_source.mode_name(ex.config), plan.tile,
                       plan.smem_bytes, plan.n_ctas, plan.steps, plan.slots,
                       ', rolling' if plan.rolling else ''))
    modes.append((name, opts, ex))
  for name, opts, ex in modes:
    _, shape, stencil, _, inputs, params = by_name[name]
    ex.launches = 0
    t = time.time()
    got = ex(inputs, params)
    torch.cuda.synchronize()
    count = ex.launches
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    if count != 1:
      raise RuntimeError('%s %s: %d launches for one call' % (name, opts,
                                                              count))
    label = '%s %s' % (name, cuda_source.mode_name(ex.config))
    check_finite(stencil, shape, got, label)
    testing.check_outputs(stencil, shape, got, plains[name],
                          label + ' vs whole-grid plain')
    streamed = []
    p_ms = profiling.cuda_times_ms(
        lambda: streamed.append(streamed_stencil_plain(
            stencil, args[:n_in], args[n_in:], tile=ex.plan)),
        reps=1, warmup=0)[0]
    err = testing.check_outputs(stencil, shape, got,
                                dict(zip(stencil.output_names, streamed[0])),
                                label + ' vs streamed plain')
    exact = ''
    if name == FLAGSHIP:
      check_oracle(got, label)
      exact = ', bit-exact vs the NumPy oracle'
    del streamed
    k_ms = profiling.cuda_times_ms(lambda: ex.fn(*args), reps=KERNEL_REPS)
    ms = statistics.median(k_ms)
    _, device_us = profiling.back_to_back_us(lambda: ex.fn(*args),
                                             calls=HOST_CALLS)
    # the TPU code of the mode that sets this kernel apart
    lead = next(key for key in ('prefetch', 'dma_split', 'out_dma',
                                'stream_loop') if key in opts)
    kernels.append(record('fused_stencil_mode[%s]' % label,
                          'soda_tpu_torch/backend/cuda_source.py',
                          cuda_source.MODE_REPLACES[lead], count, err, ms,
                          p_ms, stencil, shape))
    bound = kernels[-1]['bound_ms']
    plan = ex.plan
    say('[modes] %-30s tile %s, %d CTAs x %d steps, %d slot(s)%s, smem %d B: '
        '1 launch, == whole-grid plain and == streamed plain (max |err| '
        '%.3g)%s  kernel %.4f ms (default kernel %.4f ms, %.2fx)  bound '
        '%.4f ms (%.0f%%)  streamed plain %.1f ms  back to back %.1f us/call '
        '(%.1fs) | %s' % (
            label, plan.tile, plan.n_ctas, plan.steps, plan.slots,
            ', rolling' if plan.rolling else '', plan.smem_bytes, err, exact,
            ms, kernel_ms[name], ms / kernel_ms[name], bound,
            100 * bound / ms, p_ms, device_us, time.time() - t, smi))
    del got, args
  torch.cuda.empty_cache()

  # 14. tools: the tuner, the validation gate, compiled statistics, and
  # the command line's tuning flags
  tune_cache = os.path.join(cli_dir, 'tune.json')
  if os.path.exists(tune_cache):
    os.remove(tune_cache)
  timed = autotune._time_config
  probes = []

  def counted(*a, **k):
    probes.append(a[2])
    return timed(*a, **k)

  autotune._time_config = counted
  try:
    for name in TUNED:
      stencil, shape = stencils[name], shape_of[name]
      t = time.time()
      del probes[:]
      cfg = autotune.tune(stencil, shape, cache_path=tune_cache)
      first = len(probes)
      entry = next(e for e in autotune._load(tune_cache).values()
                   if e['stencil'] == stencil.app_name)
      default = entry['probes'][json.dumps(
          {'tile': list(make_tile_plan(stencil, shape).tile)}, sort_keys=True)]
      del probes[:]
      again = autotune.tune(stencil, shape, cache_path=tune_cache)
      if probes or again != cfg or not first:
        raise RuntimeError('%s: tune probed %d, then %d (%s, then %s)' % (
            name, first, len(probes), cfg, again))
      say('[tune] %-10s %d candidates probed: winner %s %.4f ms against the '
          'default kernel\'s %.4f ms (%.2fx); a second call probed 0 '
          '(%.1fs) | %s' % (name, first, cfg, entry['ms'], default,
                            default / entry['ms'], time.time() - t, smi))
      for probe, probe_ms in sorted(entry['probes'].items(),
                                    key=lambda kv: kv[1]):
        say('[tune] %-10s   %-50s %.4f ms' % (name, probe, probe_ms))
  finally:
    autotune._time_config = timed

  for name in COMPILED:
    stats = compiled_stats(by_name[name][3])
    for kernel in stats['kernels']:
      if kernel['registers'] is None or not kernel['ctas_per_sm']:
        raise RuntimeError('%s: compiled_stats gave %s' % (name, kernel))
      say('[compiled] %-10s %d registers/thread (ptxas %d), smem %d B static '
          '+ %d B dynamic, %d B local, spills %d/%d B, %d CTA(s)/SM; tile %s, '
          '%d CTAs, %d B in, %d B out | %s' % (
              name, kernel['registers'], kernel['registers_ptxas'],
              kernel['smem_static'], kernel['smem_dynamic'],
              kernel['local_bytes'], kernel['spill_stores'],
              kernel['spill_loads'], kernel['ctas_per_sm'],
              tuple(kernel['tile']), kernel['ctas'], kernel['bytes_in'],
              kernel['bytes_out'], smi))

  # the gate (its kernels were built in phase 2) beside the command
  # lines that time nothing
  t = time.time()
  gate_log = open(os.path.join(cli_dir, 'gpu_validate.log'), 'w+')
  gate = subprocess.Popen(
      [sys.executable, '-m', 'soda_tpu_torch.tools.gpu_validate',
       '--variants'], cwd=here, env=env, stdout=gate_log,
      stderr=subprocess.STDOUT, text=True)
  tool_runs = [(name, flags, ','.join(map(str, shape_of[name])),
                ','.join(map(str, overrides_of[name]['tile_size'][:-1])))
               for name, flags in TOOL_CLI_RUNS]
  cli([run for run in tool_runs if not timing(run[1])], tag='tools-cli')
  code = gate.wait(timeout=900)
  gate_log.seek(0)
  out = gate_log.read()
  gate_log.close()
  for line in out.strip().splitlines():
    say('[validate] %s' % line)
  rows = [line for line in out.splitlines()
          if re.match(r'\S+ +(PASS|FAIL|ERROR)', line)]
  if (code != 0 or any(' PASS' not in row for row in rows) or
      not any(row.startswith('contrast+f64truth ') for row in rows)):
    raise RuntimeError('gpu_validate --variants exited %d' % code)
  say('[validate] %d rows, every one PASS (%.1fs) | %s' % (
      len(rows), time.time() - t, smi))
  for run in tool_runs:
    if timing(run[1]):
      cli([run], tag='tools-cli')

  # 15. layout forms: the JAX package's 24 seed configurations (17 carry
  # a layout key) and its gate's narrow row, and chunked stage loops, at
  # the benchmark shapes, each through the user's entry point
  t15 = time.time()
  for index, (name, shape, stencil, opts) in enumerate(layout_rows):
    t = time.time()
    ex = soda_tpu_torch.get_executor(stencil, shape, **opts)
    if not isinstance(ex, FusedExecutor):
      raise RuntimeError('%s %s: not the fused kernel' % (name, opts))
    plan = ex.plan
    layout = plan.layout
    form = (layout.name if layout is not None else
            cuda_source.mode_name(ex.config))
    inputs = testing.make_test_inputs(stencil, shape)
    params = testing.make_test_params(stencil)
    ex.launches = 0
    got = ex(inputs, params)
    torch.cuda.synchronize()
    count = ex.launches
    if count != 1:
      raise RuntimeError('%s %s: %d launches for one call' % (name, opts,
                                                              count))
    label = '%s %s' % (name, form)
    check_finite(stencil, shape, got, label)
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    if stencil is stencils[name]:
      default_out, default_ms = results[name], kernel_ms[name]
    else:
      default_ex = FusedExecutor(stencil, shape)
      default_out = default_ex(inputs, params)
      default_ms = statistics.median(profiling.cuda_times_ms(
          lambda: default_ex.fn(*args), reps=KERNEL_REPS))
    testing.check_exact(stencil, shape, got, default_out,
                        label + ' vs the default kernel')
    if layout is not None:
      plain_out = []
      p_ms = profiling.cuda_times_ms(
          lambda: plain_out.append(layout_stencil_plain(
              stencil, args[:n_in], args[n_in:], tile=plan)),
          reps=1, warmup=0)[0]
      want = dict(zip(stencil.output_names, plain_out[0]))
      testing.check_exact(stencil, shape, got, want,
                          label + ' vs layout_stencil_plain')
      err = testing.check_outputs(stencil, shape, got, want, label)
      del plain_out, want
    else:  # a seed without layout keys: the kernel at another tile or in
      # a mode, held against the seed's own whole-grid plain version
      # (walking its tiles takes minutes in contrast)
      if stencil is stencils[name]:
        want, p_ms = plains[name], plain_ms_of[name]
      else:
        want = dict(zip(stencil.output_names, fused_stencil_plain(
            stencil, args[:n_in], args[n_in:])))
        p_ms = statistics.median(profiling.cuda_times_ms(
            lambda: fused_stencil_plain(stencil, args[:n_in], args[n_in:]),
            reps=PLAIN_REPS, warmup=1))
      err = testing.check_outputs(stencil, shape, got, want,
                                  label + ' vs whole-grid plain')
      del want
    exact = ''
    if name == FLAGSHIP:
      check_oracle(got, label)
      exact = ', bit-exact vs the NumPy oracle'
    del got
    ms = statistics.median(profiling.cuda_times_ms(lambda: ex.fn(*args),
                                                   reps=KERNEL_REPS))
    _, device_us = profiling.back_to_back_us(lambda: ex.fn(*args),
                                             calls=HOST_CALLS)
    stats = compiled_stats(ex)['kernels'][0]
    cfg = ex.config
    lead = [k for k, on in (('prefetch', cfg.prefetch > 2),
                            ('dma_split', cfg.dma_split > 1),
                            ('out_dma', cfg.out_dma),
                            ('stream_loop', bool(cfg.stream_loop))) if on]
    replaces = (cuda_source.LAYOUT_REPLACES[layout.form] if layout else
                cuda_source.MODE_REPLACES[lead[0]] if lead else
                cuda_source.REPLACES)
    seed = ('seed %d' % (index % 2) if index < len(testing.SEED_CONFIGS)
            else 'extra')
    kernels.append(record('fused_stencil_layout[%s %s: %s]' % (
        name, seed, form), 'soda_tpu_torch/backend/cuda_source.py',
                          replaces, count, err, ms, p_ms, stencil, shape))
    bound = kernels[-1]['bound_ms']
    warp = plan.warp
    say('[layout] %-12s %-7s %-40s %s tile %s, %d CTAs%s: 1 launch, '
        '== default kernel bit for bit, == %s%s  kernel %.4f ms (default '
        'kernel %.4f ms, %.2fx), max |err| %.3g  bound %.4f ms (%.1f%%)  '
        'plain %.1f ms  '
        'back to back %.1f us/call  %d registers, spills %d/%d B, %d B '
        'local, %d CTA(s)/SM (%.1fs) | %s' % (
            name, seed, form, json.dumps(opts, sort_keys=True), plan.tile,
            plan.n_ctas, (', warp blocks %s, frame %s, %d cell(s) a lane, '
                          '~%d live values' % (warp.block, warp.window,
                                               warp.cells, warp.regs)
                          if warp else ''),
            'layout_stencil_plain bit for bit' if layout else
            'whole-grid plain', exact, ms, default_ms,
            ms / default_ms, err, bound, 100 * bound / ms, p_ms, device_us,
            stats['registers'], stats['spill_stores'], stats['spill_loads'],
            stats['local_bytes'], stats['ctas_per_sm'], time.time() - t,
            smi))
    del args
    torch.cuda.empty_cache()
  say('[layout] %d rows (%.1fs)' % (len(layout_rows), time.time() - t15))

  # 16. experiments: the streaming and chain probes through the
  # experiment entry points, every probe counter reset just before
  t16 = time.time()

  def log16(line):
    say('[experiments] ' + line)

  for name in exp_probes.SOURCES:
    report = build.ptxas_report(build.csrc_source(name))
    spills = sorted(entry for entry, r in report.items()
                    if r['spill_stores'] or r['spill_loads'])
    log16('%s: %d entries, registers %d-%d, spills in %s' % (
        name, len(report), min(r['registers'] for r in report.values()),
        max(r['registers'] for r in report.values()), spills or 'none'))

  def drive(run, *args):
    """One entry point's run, every probe counter reset just before and
    read just after: its rows and the launches of each configuration."""
    exp_probes.LAUNCHES.clear()
    rows = run('cuda', *args, log=log16)
    torch.cuda.synchronize()
    return rows, dict(exp_probes.LAUNCHES)

  stream_rows = {}
  for module, cases, line in ((exp27_gridloop, exp_probes.EXP27_CASES, 122),
                              (exp30_dma_granularity, exp_probes.EXP30_CASES,
                               110)):
    script = module.__name__.split('.')[-1]
    rows, launched = drive(module.run)
    for case, row in zip(cases, rows):
      stream_rows[case] = (row, launched.get(case.key, 0), script,
                           'experiments/%s.py:%d' % (script, line))
  chain_rows = {}
  for module, flag in ((exp24_stage_tax, False), (exp24_stage_tax, True),
                       (exp45_transcendental_tax, False),
                       (exp45_transcendental_tax, True)):
    rows, launched = drive(module.run, flag, CHAIN_N_SMALL, CHAIN_N_BIG)
    for row in rows:
      chain_rows.setdefault(row['body'], (
          row, launched.get(('probe_chain', row['body']), 0)))
  log16('main path: %d launches (%.1fs)' % (
      sum(n for _, n, _, _ in stream_rows.values()) +
      sum(n for _, n in chain_rows.values()), time.time() - t16))
  for name, n in ([(case.name, n) for case, (_, n, _, _) in
                   stream_rows.items()] +
                  [(name, n) for name, (_, n) in chain_rows.items()]):
    if n < 1:
      raise RuntimeError('%s: the experiments launched no kernel' % name)
  bad = [row['case'] for row, _, _, _ in stream_rows.values()
         if not row['ok']] + [b for b, (row, _) in chain_rows.items()
                              if not row['ok']]
  if bad or len(chain_rows) != len(exp_probes.CHAIN_BODIES):
    raise RuntimeError('experiments: wrong results in %s' % bad)

  x = exp_probes.stream_input(256, 'cuda')
  lib_out = torch.empty_like(x)
  lib_ms = statistics.median(profiling.cuda_times_ms(
      lambda: torch.add(x, 1.0, out=lib_out), reps=KERNEL_REPS))
  for case, (row, launches, script, replaces) in stream_rows.items():
    t = time.time()
    args = (case.kind, case.blk, case.split, case.depth)
    got = exp_probes.stream_probe(x, *args)
    plain = lambda: exp_probes.stream_probe_plain(x, *args, ctas=row['ctas'])
    want = plain()
    err, _ = exp_probes.max_error(got, want)
    if err != 0 or not torch.equal(got, want):
      raise RuntimeError('%s: stream probe differs from its plain version'
                         % case.name)
    p_ms = profiling.cuda_times_ms(plain, reps=1, warmup=0)[0]
    kernels.append({
        'name': 'probe_stream[%s %s]' % (script.split('_')[0], case.name),
        'route': 'cuda', 'source': 'soda_tpu_torch/csrc/probe_stream.cu',
        'replaces': replaces, 'launches': launches,
        'max_abs_err': err, 'ms': row['ms'], 'plain_ms': p_ms,
        'bound_ms': row['bound_ms'], 'bound_by': 'bytes',
        'library_ms': lib_ms})
    log16('%-18s == stream_probe_plain bit for bit; %.4f ms, bound %.4f ms '
          '(share %.3f), %.3f us/step (%d CTAs x %d), back to back %.2f us, '
          'plain %.1f ms, torch.add %.4f ms (%.1fs) | %s' % (
              case.name, row['ms'], row['bound_ms'],
              row['bound_ms'] / row['ms'], row['step_us'], row['ctas'],
              row['steps'], row['b2b_us'], p_ms, lib_ms, time.time() - t,
              smi))
  del x, lib_out, got, want
  torch.cuda.empty_cache()
  for name, body in exp_probes.CHAIN_BODIES.items():
    row, launches = chain_rows[name]
    x = exp_probes.chain_input(body.dtype, 'cuda')
    abs_err, rel_err = exp_probes.chain_check(
        x, body, exp_probes.CHECK_ITERS + (CHAIN_N_SMALL,))
    plain = lambda: exp_probes.chain_probe_plain(x, body, CHAIN_N_SMALL)
    if not exp_probes.chain_ok(body, abs_err, rel_err):
      raise RuntimeError('%s: chain probe differs from its plain version '
                         '(%g, relative %g)' % (name, abs_err, rel_err))
    p_ms = profiling.cuda_times_ms(plain, reps=1, warmup=0)[0]
    line = 75 if body.experiment == 'exp24' else 71
    script = ('exp24_stage_tax' if body.experiment == 'exp24' else
              'exp45_transcendental_tax')
    kernels.append({
        'name': 'probe_chain[%s %s]' % (body.experiment, name),
        'route': 'cuda', 'source': 'soda_tpu_torch/csrc/%s' % (
            narrow.SOURCE if body.form == 'shift' else 'probe_chain.cu'),
        'replaces': 'experiments/%s.py:%d' % (script, line),
        'launches': launches, 'max_abs_err': abs_err,
        'ms': row['us'] / 1e3, 'plain_ms': p_ms / CHAIN_N_SMALL,
        'bound_ms': row['bound_ms'], 'bound_by': 'operations',
        'library_ms': None})
    log16('%-14s == chain_probe_plain (n=%s, max |err| %.3g, relative %.3g);'
          ' per iteration %.3f us, bound %.3f us (%s), plain %.1f us, %d '
          'barriers, %d CTAs | %s' % (
              name, ','.join(map(str, exp_probes.CHECK_ITERS +
                                 (CHAIN_N_SMALL,))), abs_err, rel_err,
              row['us'], row['bound_ms'] * 1e3, row['bound_by'],
              p_ms * 1e3 / CHAIN_N_SMALL, body.barriers, row['ctas'], smi))
  log16('%d streaming cases, %d chain bodies (%.1fs)' % (
      len(stream_rows), len(exp_probes.CHAIN_BODIES), time.time() - t16))

  # 17. narrow: the 16-bit and op-rate probes through the six entry
  # points, every probe counter reset just before each and read just after
  t17 = time.time()

  def log17(line):
    say('[narrow] ' + line)

  narrow_rows, fused_rows = {}, []
  for module in (exp13_narrow_i16, exp29_pack_i16, exp16_swar_erosion,
                 exp12_mosaic_reprobe, exp2_diag, exp1_value_mode):
    exp_probes.LAUNCHES.clear()
    rows = module.run('cuda', log=log17)
    torch.cuda.synchronize()
    launched = dict(exp_probes.LAUNCHES)
    for row in rows:
      if row['body'] in narrow.BODIES:
        narrow_rows[row['body']] = (row, launched.get(
            (narrow.KERNEL, row['body']), 0))
      else:  # exp16's swar == wide, exp2's copies, exp1's stage modes
        fused_rows.append(row)
  log17('main path: %d launches (%.1fs)' % (
      sum(n for _, n in narrow_rows.values()), time.time() - t17))
  missing = sorted(set(narrow.BODIES) - set(narrow_rows))
  # (a body's row is not ok where it differs from its plain version or
  # its share of the bound exceeds narrow.MAX_SHARE)
  bad = [name for name, (row, n) in narrow_rows.items()
         if n < 1 or not row['ok']] + [row['body'] for row in fused_rows
                                       if not row['ok']]
  unlaunched = [row['body'] for row in fused_rows
                if 'launches' in row and row['launches'] < 1]
  if missing or bad or unlaunched:
    raise RuntimeError('narrow: bodies not run %s, wrong or not launched %s,'
                       ' fused kernels not launched %s' % (missing, bad,
                                                           unlaunched))
  spilled = {key: rep['spills'] for key, rep in narrow.sass_report().items()
             if rep['spills']}
  folded = sorted({body.op for body in narrow.BODIES.values()
                   if body.form == 'ew' and
                   not narrow.ew_loop_holds_every_iteration(body)})
  if spilled or folded:
    raise RuntimeError('narrow: kernels spill %s; register chains whose '
                       'iterations fold %s' % (spilled, folded))
  for name, body in narrow.BODIES.items():
    row, launches = narrow_rows[name]
    xs = narrow.body_inputs(body, 'cuda')
    iters = narrow.check_iters(body, narrow.SLOPE.get(body.script, (1,))[0])
    abs_err, rel_err = narrow.narrow_check(body, xs, iters)
    if not narrow.narrow_ok(body, abs_err, rel_err):
      raise RuntimeError('%s: narrow probe differs from its plain version '
                         '(%g, relative %g)' % (name, abs_err, rel_err))
    kernels.append({
        'name': 'probe_narrow[%s]' % name, 'route': 'cuda',
        'source': 'soda_tpu_torch/csrc/probe_narrow.cu',
        'replaces': 'experiments/%s.py:%d' % (narrow.SCRIPTS[body.script],
                                              body.line),
        'launches': launches, 'max_abs_err': abs_err, 'ms': row['ms'],
        'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
        'bound_by': row['bound_by'], 'library_ms': row['library_ms']})
    log17('%-56s == plain (n=%s, max |err| %.3g, relative %.3g); %s %.6g '
          'ms%s, bound %.6g ms (%s), plain %.6g ms, library %s, %d launches '
          '| %s' % (name, ','.join(map(str, iters)), abs_err, rel_err,
                    'per iteration' if body.chain else 'cold', row['ms'],
                    '' if body.chain else ' (back to back: host %.1f, '
                    'device %.1f us a call)' % (row['host_us'],
                                                row['b2b_us']),
                    row['bound_ms'], row['bound_by'],
                    row['plain_ms'], '%.6g ms' % row['library_ms']
                    if row['library_ms'] is not None else 'none', launches,
                    smi))
  log17('%d bodies, %d other rows (%.1fs)' % (
      len(narrow_rows), len(fused_rows), time.time() - t17))

  # 18. copyshift: exp32's copy-shift probe and exp9's 2.5-D jacobi
  # through their entry points, every probe counter reset just before each
  # and read just after
  t18 = time.time()

  def log18(line):
    say('[copyshift] ' + line)

  for name in (copyshift.SOURCE, layout25d.SOURCE):
    report = build.ptxas_report(build.csrc_source(name))
    spills = sorted(entry for entry, r in report.items()
                    if r['spill_stores'] or r['spill_loads'])
    log18('%s: %d entries, registers %s, spills in %s' % (
        name, len(report), sorted(r['registers'] for r in report.values()),
        spills or 'none'))
    if spills:
      raise RuntimeError('copyshift: %s spills in %s' % (name, spills))
  runs = []
  for run, args in ((exp32_dma_shift.run, (False,)),
                    (exp32_dma_shift.run, (True,)), (exp9_layout25d.run, ())):
    exp_probes.LAUNCHES.clear()
    rows = run('cuda', *args, log=log18)
    torch.cuda.synchronize()
    runs.append((rows, dict(exp_probes.LAUNCHES)))
  copy_rows = [(row, launched) for rows, launched in runs[:2] for row in rows]
  rows9, launched9 = runs[2]

  def copy_key(case):
    return ((narrow.KERNEL, copyshift.ROTATE[case.name].name)
            if case.kind == 'rotate' else (copyshift.KERNEL, case.name))

  log18('main path: %d launches (%.1fs)' % (
      sum(sum(launched.values()) for _, launched in runs), time.time() - t18))
  bad = [row['case'] for row, launched in copy_rows
         if not row['ok'] or launched.get(
             copy_key(copyshift.CASES[row['case']]), 0) < 1]
  bad += [row['case'] for row in rows9 if not row['ok'] or (
      'block' in row and launched9.get((layout25d.KERNEL, 'block %d' %
                                        row['block']), 0) < 1)]
  if bad or len(copy_rows) != len(copyshift.CASES):
    raise RuntimeError('copyshift: wrong, over their bound or not launched: '
                       '%s' % bad)
  sass = copyshift.sass_report()
  order = copyshift.overlap_order(sass['overlap']['loop'])
  stores = copyshift.store_loop_counts(sass['store']['loop'])
  per = copyshift.CELL_SLOTS
  if order['between'] < 3 * per or min(stores.values()) < per:
    raise RuntimeError('copyshift: overlap order %s (chain B: 3 instructions '
                       'a cell slot between issue and wait), store loop %s' %
                       (order, stores))
  log18('SASS: the overlap\'s chain B has %d instructions between its copy\'s '
        'issue and the wait (%d after it, chain A\'s mins among them); the '
        'store control\'s main loop %d STS, %d LDS, %d mins, none forwarded' %
        (order['between'], order['after'], stores['STS'], stores['LDS'],
         stores['min']))
  for row, launched in copy_rows:
    case = copyshift.CASES[row['case']]
    kernels.append({
        'name': '%s[exp32 %s]' % (copy_key(case)[0], case.name),
        'route': 'cuda', 'source': 'soda_tpu_torch/csrc/%s' % (
            narrow.SOURCE if case.kind == 'rotate' else copyshift.SOURCE),
        'replaces': 'experiments/%s.py:%d' % (copyshift.SCRIPT, case.line),
        'launches': launched[copy_key(case)], 'max_abs_err': row['abs_err'],
        'ms': row['ms'], 'plain_ms': row['plain_ms'],
        'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
        'library_ms': None})
  for row in rows9[1:]:
    if 'block' in row:
      kernels.append({
          'name': '%s[exp9 block %d]' % (layout25d.KERNEL, row['block']),
          'route': 'cuda', 'source': 'soda_tpu_torch/csrc/%s' %
          layout25d.SOURCE, 'replaces': 'experiments/%s.py:%d' % (
              layout25d.SCRIPT, layout25d.LINE),
          'launches': launched9[(layout25d.KERNEL, 'block %d' %
                                 row['block'])],
          'max_abs_err': row['abs_err'], 'ms': row['ms'],
          'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
          'bound_by': 'bytes', 'library_ms': None})
    else:
      kernels.append(record(
          'fused_stencil[exp9 jacobi2d %s]' % row['case'].split()[-1],
          'soda_tpu_torch/backend/cuda_source.py',
          'soda_tpu/backend/pallas_kernel.py:1543', row['launches'],
          row['abs_err'], row['ms'], row['plain_ms'], exp9_stencil,
          exp9_layout25d.JACOBI_SHAPE))
  log18('%d exp32 cases, %d exp9 rows, each launched, bit for bit against '
        'its plain version and within %.2f of its bound (%.1fs) | %s' % (
            len(copy_rows), len(rows9), narrow.MAX_SHARE, time.time() - t18,
            smi))

  no_jax_loaded()
  say('[done] every phase passed (%.1fs)' % (time.time() - t_start))
  say(smi)
  say(json.dumps({'kernels': kernels}))
  say(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': 1}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
