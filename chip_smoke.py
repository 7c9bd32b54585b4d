#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py

The main path: DSL text -> soda_tpu_torch.build_stencil (the port's own
front half: parser, passes, fusion plan) -> soda_tpu_torch.get_executor
-> one generated CUDA C++ kernel per stencil. Beside it, grouped
execution (``cluster: coarse``: one kernel per stage group), replicated
execution (R grids in one launch), the command line, the whole-grid
executor and sharded execution over a device mesh (the fused kernel per
halo-extended shard). Phases, each printing one line per step with its
seconds:

1. device: a CUDA device is required (no CPU fallback); prints the card,
   its power limit and the toolchain; neither jax nor the JAX package
   may be loaded (checked again at the end).
2. build: builds the 12 cells of the stencil benchmark (the 11 corpus
   kernels plus jacobi3d at 256^3, with the benchmark's shapes and
   stencil overrides), the grouped cells' per-group kernels, the small
   replicated grid's kernel and the sharded cells' kernels at their
   halo-extended shard shapes: one nvcc per source, all at once. Each
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

The last three lines are the card's name and power limit as nvidia-smi
prints them, a JSON object with each kernel's record (``{"kernels":
...}``), and ``{"ok": true, "device": ...}``. Any failure raises and
exits nonzero. Inputs are made from seeded numpy (make_test_inputs).
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
                                            replicated_stencil_plain)
  from soda_tpu_torch.backend.tile_plan import make_tile_plan
  from soda_tpu_torch.parallel import replicate, spmd

  # 1. device
  t0 = time.time()
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
  env = dict(os.environ, PYTHONPATH=here)
  for name, flags in CLI_RUNS:
    path = os.path.join(cli_dir, name + '.soda')
    with open(path, 'w') as f:
      f.write(corpus.CORPUS[name])
    cmd = [sys.executable, '-m', 'soda_tpu_torch', path, '--run', '--shape',
           CLI_SHAPE, '--tile-size', CLI_SHAPE.split(',')[1]] + flags
    t = time.time()
    proc = subprocess.run(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=600)
    for line in proc.stdout.strip().splitlines():
      say('[cli] %s: %s' % (name, line))
    if proc.returncode != 0 or 'INFO: PASS!' not in proc.stdout:
      raise RuntimeError('%s: %s exited %d without INFO: PASS!' % (
          name, ' '.join(cmd[1:]), proc.returncode))
    found = re.search(r', (\d+) kernel launches$', proc.stdout, re.M)
    count = int(found.group(1)) if found else -1
    if count < 0 or (count == 0) != ('xla' in flags):
      raise RuntimeError('%s %s: %d kernel launches' % (
          name, ' '.join(flags), count))
    say('[cli] %s %s: exit 0, INFO: PASS!, %d kernel launches (%.1fs) | %s'
        % (name, ' '.join(flags), count, time.time() - t, smi))

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

  no_jax_loaded()
  say(smi)
  say(json.dumps({'kernels': kernels}))
  say(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': 1}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
