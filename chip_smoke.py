#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

The main path: DSL text -> soda_tpu_torch.build_stencil (the shared
front half: parser, passes, fusion plan) -> soda_tpu_torch.get_executor
-> one generated CUDA C++ kernel per stencil. Phases, each printing one
line per step with its seconds:

1. device: a CUDA device is required (no CPU fallback); prints the card,
   its power limit and the toolchain; JAX must not be loaded.
2. build: builds the 12 cells of the stencil benchmark (the 11 corpus
   kernels plus jacobi3d at 256^3, with the benchmark's shapes and
   stencil overrides) and compiles each one's kernel with nvcc.
3. main path: every cell once through ``executor(inputs)``, with every
   launch counter reset just before and read just after.
4. kernel vs plain: each kernel against its plain PyTorch version
   (``fused_stencil_plain``, whole grid as one tile) on the same card,
   on every output's valid region: integers bit-exact, floats within the
   reference's squared-error threshold (1e-4; contrast 1e-3).
5. oracle: blur at (8192, 2048) bit-exact against the NumPy oracle.
6. times: CUDA-event times of kernel and plain version per cell, each
   call from a cold L2 cache (median, and the kernel's quartiles), and
   the unique-traffic rate (inputs read once, outputs written once).
7. host: per cell, the host's microseconds to enqueue one ``executor.fn``
   call against the device's microseconds per call, over 200
   back-to-back calls (warm L2): whether the host holds the card back.

The last two lines are one JSON object with each kernel's record and
``{"ok": true, "device": ...}``. Any failure raises and exits nonzero.
Inputs are made from seeded numpy (testing.make_test_inputs).
"""

import json
import os
import statistics
import sys
import time

FLAGSHIP = 'blur'
KERNEL_REPS = 20
PLAIN_REPS = 5
HOST_CALLS = 200


def say(*parts):
  print(*parts, flush=True)


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
  from soda_tpu_torch import profiling, testing
  from soda_tpu_torch.backend import cuda_source
  from soda_tpu_torch.backend.fused import fused_stencil_plain

  # 1. device
  t0 = time.time()
  report = profiling.device_report()
  if 'jax' in sys.modules:
    raise RuntimeError('the port loaded jax')
  say('[device] %s | torch %s | cuda %s | %s (%.1fs)' % (
      report['device'], report['torch'], report['cuda'], report['nvcc'],
      time.time() - t0))
  smi = report['nvidia_smi']
  say(smi)

  # 2. build
  cells = []
  t_build = time.time()
  for name, shape, overrides in testing.CELLS:
    t = time.time()
    stencil = testing.build_cell(name, overrides)
    t_st = time.time() - t
    t = time.time()
    ex = soda_tpu_torch.get_executor(stencil, shape)
    say('[build] %-12s %-16s tile %-14s smem %6d B  %5d CTAs  stencil '
        '%.1fs  kernel %.1fs' % (name, shape, ex.plan.tile,
                                 ex.plan.smem_bytes, ex.plan.n_tiles, t_st,
                                 time.time() - t))
    inputs = testing.make_test_inputs(stencil, shape)
    params = testing.make_test_params(stencil)
    cells.append((name, shape, stencil, ex, inputs, params))
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

  # 4. kernel vs plain version on the card
  errors = {}
  for name, shape, stencil, ex, inputs, params in cells:
    t = time.time()
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    plain = fused_stencil_plain(stencil, args[:n_in], args[n_in:], tile=None)
    torch.cuda.synchronize()
    got = results[name]
    for out in stencil.output_names:
      region = testing.output_valid_slices(stencil, shape, out)
      if (stencil.symbol_table[out].is_float and
          not bool(torch.isfinite(got[out][region]).all())):
        raise RuntimeError('%s:%s: non-finite kernel output' % (name, out))
    worst = testing.check_outputs(
        stencil, shape, got, dict(zip(stencil.output_names, plain)), name)
    errors[name] = worst
    say('[check] %-12s kernel == plain (max |err| %.3g) (%.1fs)' % (
        name, worst, time.time() - t))

  # 5. the flagship against the NumPy oracle
  t = time.time()
  name, shape, stencil = next(c[:3] for c in cells if c[0] == FLAGSHIP)
  inputs = next(c[4] for c in cells if c[0] == FLAGSHIP)
  want = testing.oracle_run(stencil, inputs)
  for out in stencil.output_names:
    region = testing.output_valid_slices(stencil, shape, out)
    got = results[name][out].cpu().numpy()[region]
    if not np.array_equal(got, want[out][region]):
      raise RuntimeError('%s:%s differs from the NumPy oracle' % (name, out))
  say('[oracle] %s %s bit-exact vs the NumPy oracle (%.1fs)' % (
      name, shape, time.time() - t))

  # 6. times
  kernels = []
  for name, shape, stencil, ex, inputs, params in cells:
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    k_ms = profiling.cuda_times_ms(lambda: ex.fn(*args), reps=KERNEL_REPS)
    p_ms = profiling.cuda_times_ms(
        lambda: fused_stencil_plain(stencil, args[:n_in], args[n_in:]),
        reps=PLAIN_REPS, warmup=1)
    ms, plain_ms = statistics.median(k_ms), statistics.median(p_ms)
    q1, _, q3 = statistics.quantiles(k_ms, n=4)
    in_b, out_b = profiling.stream_bytes(stencil, shape)
    say('[time] %-12s kernel %.4f ms (quartiles %.4f-%.4f, n=%d)  plain '
        '%.3f ms (n=%d)  %.1f GB/s unique traffic | %s' % (
            name, ms, q1, q3, len(k_ms), plain_ms, len(p_ms),
            (in_b + out_b) / ms / 1e6, smi))
    kernels.append({
        'name': 'fused_stencil[%s]' % name,
        'route': 'cuda',
        'source': 'soda_tpu_torch/backend/cuda_source.py',
        'replaces': cuda_source.REPLACES,
        'launches': launches[name],
        'max_abs_err': errors[name],
        'ms': ms,
        'plain_ms': plain_ms,
    })
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

  say(json.dumps({'kernels': kernels}))
  say(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
