"""The command line of the PyTorch/CUDA port.

    python -m soda_tpu_torch FILE|- [--run [--bench]] [options]

The counterpart of soda_tpu/sodac.py: parse a .soda program (file or
stdin), apply directive overrides and optimizations, construct the
Stencil, and act on it:

  --emit-torch FILE a standalone PyTorch program (- for stdout)
  --emit-numpy FILE a standalone NumPy program, the printed oracle
  --emit-dot FILE   graphviz of the fusion plan
  --run             execute on seeded inputs and self-test against the
                    NumPy oracle (the reference's SODA_TEST_MAIN)
  --bench           with --run: CUDA-event kernel time, unique-traffic
                    bandwidth and pixel/ns on the card
  --backend         auto|fused (one kernel, or one per group under
                    cluster: coarse/fine), xla (whole grid), replicated,
                    sharded [--mesh 4 | --mesh 2,2]
  --kernel-opt K=V  the fused kernel's config (repeatable): tile,
                    block_rows, mid_tile, stream_loop, prefetch,
                    dma_split, out_dma; with --backend sharded the
                    per-shard kernel's, with replicated the replicas'
  --tune            with --run: probe the kernel's configs on the card
                    and cache the winner (tools/autotune.py)
  --compile-stats   FILE or -: each kernel's registers, shared memory,
                    spills and CTAs per SM, and its plan (JSON)
  --estimate        FILE or -: the analytic H100 cost model's estimate of
                    the fused kernel (JSON; model/estimate.py), pinned by
                    --kernel-opt; --model-file JSON overrides its device
                    rates and prices

``--device`` is explicit (default ``cuda``): without a usable GPU the
run fails; ``--device cpu`` runs the kernels' plain PyTorch versions.
Flags of the JAX CLI that the port does not have yet exit nonzero
naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional

from soda_tpu_torch import utils

PROG = 'python -m soda_tpu_torch'

# flags of the JAX CLI the port does not have -> why, naming a ROADMAP item
_NOT_PORTED_FLAGS = (
    ('emit_jax', '--emit-jax', 'the port prints no JAX program; its '
     'counterpart is --emit-torch, a standalone PyTorch program (ROADMAP '
     'A10)'),
)
_NOT_PORTED_BACKENDS = {
    'pallas': 'ROADMAP A4 (the TPU kernel; its port is --backend fused)',
}


class NotPorted(Exception):
  """A flag or backend of the JAX CLI that the port does not have yet."""


def _build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(
      prog=PROG,
      description='SODA stencil compiler, PyTorch/CUDA port (H100)')
  parser.add_argument('--verbose', '-v', action='count', default=0,
                      help='increase verbosity')
  parser.add_argument('--quiet', '-q', action='count', default=0,
                      help='decrease verbosity')
  parser.add_argument('--recursion-limit', type=int, default=3000,
                      help='Python recursion limit')
  parser.add_argument('soda_src', metavar='FILE',
                      help='SODA program, or - for stdin')

  override = parser.add_argument_group('directive overrides',
                                       'override in-file DSL directives '
                                       '(reference sodac.py:45-93)')
  override.add_argument('--burst-width', type=int)
  override.add_argument('--unroll-factor', type=int)
  override.add_argument('--replication-factor', type=int)
  override.add_argument('--tile-size', type=str,
                        help='comma-separated, e.g. 2048 or 128,128')
  override.add_argument('--dram-in', type=str)
  override.add_argument('--dram-out', type=str)
  override.add_argument('--iterate', type=int)
  override.add_argument('--border', choices=('ignore', 'preserve'))
  override.add_argument('--cluster',
                        choices=('none', 'fine', 'coarse', 'full'))

  opt = parser.add_argument_group('optimizations')
  opt.add_argument('--computation-reuse',
                   choices=('no', 'yes', 'greedy', 'optimal', 'beam',
                            'glore', 'external', 'built-in',
                            'built-in:greedy', 'built-in:optimal'),
                   default='no')
  opt.add_argument('--cr-cost', choices=('ops', 'tpu'), default=None,
                   help='computation-reuse schedule objective: ops = '
                        'the reference (num_ops, reuse distance) tuple '
                        '(default); tpu = the JAX package\'s measured '
                        'TPU shift prices')
  opt.add_argument('--inline', action='store_true')
  opt.add_argument('--distribute', action='store_true',
                   help='factor shared coefficients: a*c + b*c -> (a+b)*c')
  opt.add_argument('--no-separable', action='store_true',
                   help='disable rank-1 separable factorization of '
                        'linear stages (on by default)')

  backend = parser.add_argument_group('backends')
  backend.add_argument('--emit-dot', metavar='FILE',
                       help='dump the fusion-plan DAG as graphviz')
  backend.add_argument('--emit-torch', metavar='FILE',
                       help='write a standalone PyTorch program (- for '
                            'stdout); its main() runs on --device cuda '
                            'or cpu')
  backend.add_argument('--emit-numpy', metavar='FILE',
                       help='write a standalone NumPy program, the printed '
                            'oracle (- for stdout)')
  backend.add_argument('--run', action='store_true',
                       help='execute and self-test against the oracle')
  backend.add_argument('--bench', action='store_true',
                       help='with --run: time the kernel on the card')
  backend.add_argument('--backend',
                       choices=('auto', 'fused', 'replicated', 'xla',
                                'pallas', 'sharded'),
                       default='auto')
  backend.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                       help='cuda (default; fails without a GPU) or cpu '
                            '(the kernels\' plain PyTorch versions)')
  backend.add_argument('--shape', type=str,
                       help='grid shape, comma-separated, streaming axis '
                            'first (default: derived from tile size)')
  backend.add_argument('--seed', type=int, default=0)
  backend.add_argument('--mesh', type=str,
                       help='with --backend sharded: the mesh shape, e.g. '
                            '4 or 2,2, over that many distinct visible '
                            'devices of --device (default: every visible '
                            'device on one axis)')
  backend.add_argument('--tune', action='store_true',
                       help='with --run: probe the fused kernel\'s configs '
                            'on the card and cache the winner '
                            '(~/.cache/soda_tpu_torch_tune.json); needs '
                            '--device cuda')
  backend.add_argument('--kernel-opt', action='append', default=[],
                       metavar='KEY=VALUE',
                       help='fused-kernel config (repeatable): tile=64,128 '
                            'block_rows=64 mid_tile=8 stream_loop=peel '
                            'prefetch=3 dma_split=2 out_dma=true, and the '
                            'layout keys stage_mode=value shift_mode=roll '
                            'transpose_lanes=on lane_shift=rotate '
                            'narrow=on compute_chunk=8; applies '
                            'to the auto/fused/replicated backends and, '
                            'with --backend sharded, to the per-shard '
                            'kernel; mutually exclusive with --tune')
  backend.add_argument('--estimate', metavar='FILE',
                       help='write the analytic H100 estimate of the fused '
                            'kernel as JSON (- for stdout); analytic, so '
                            'it runs with --device cpu too')
  backend.add_argument('--model-file', metavar='FILE',
                       help='JSON overriding the model for --estimate: '
                            'hbm_gbps, gops, name and any price constant '
                            'of model/estimate.py by its name (the analog '
                            'of the reference --model-file, '
                            'model/xilinx.py)')
  backend.add_argument('--compile-stats', metavar='FILE',
                       help='write each kernel\'s registers, shared memory, '
                            'spills and CTAs per SM, and its plan, as JSON '
                            '(- for stdout)')

  unported = parser.add_argument_group(
      'not in the port', 'flags of the JAX CLI; each exits nonzero naming '
      'its ROADMAP item')
  for _, flag, _ in _NOT_PORTED_FLAGS:
    unported.add_argument(flag, metavar='ARG')
  return parser


def _parse_kernel_opts(pairs):
  """KEY=VALUE list -> FusedExecutor keyword arguments, validated once,
  up front, against its config keys (tile_plan.CONFIG_KEYS): true/false
  and integers convert, ``tile`` takes comma-separated integers, other
  values (``peel``, ``roll``, ``on``) pass as text; unknown keys
  (``interpret`` among them: ``--device cpu`` is its counterpart) list
  the valid ones."""
  from soda_tpu_torch.backend import tile_plan
  opts = {}
  for pair in pairs:
    key, sep, value = pair.partition('=')
    if not sep or not key:
      raise utils.InputError('--kernel-opt expects KEY=VALUE, got %r' % pair)
    key = key.replace('-', '_')
    if key not in tile_plan.CONFIG_KEYS:
      raise utils.InputError('unknown --kernel-opt key %r (valid: %s)' %
                             (key, ', '.join(tile_plan.CONFIG_KEYS)))
    low = value.lower()
    if key == 'tile':
      opts[key] = _parse_ints(value)
    elif low in ('true', 'yes'):
      opts[key] = True
    elif low in ('false', 'no'):
      opts[key] = False
    else:
      try:
        opts[key] = int(value)
      except ValueError:
        opts[key] = value
  return opts


def _parse_ints(text: str):
  try:
    return tuple(int(x) for x in text.split(','))
  except ValueError:
    raise utils.InputError(
        'expected comma-separated integers (e.g. 1000,1000), got %r'
        % text) from None


def _default_shape(stencil):
  rest = tuple(reversed(stencil.tile_size[:-1]))
  return (256,) + rest


def main(argv: Optional[list] = None) -> int:
  """CLI entry; user-input errors (an invalid program among them) exit 1
  with a one-line message (reference sodac exits 1 on SemanticError,
  soda/sodac.py:146-152); what the port has not yet exits 2 naming its
  ROADMAP item."""
  try:
    return _main(argv)
  except utils.InputError as e:
    print('%s: error: %s' % (PROG, e), file=sys.stderr)
    return 1
  except NotPorted as e:
    print('%s: error: %s' % (PROG, e), file=sys.stderr)
    return 2


def _main(argv: Optional[list] = None) -> int:
  parser = _build_parser()
  args = parser.parse_args(argv)
  kernel_opts = _parse_kernel_opts(args.kernel_opt)
  if kernel_opts and args.tune:
    raise utils.InputError('--kernel-opt and --tune are mutually exclusive')
  if kernel_opts and args.backend == 'xla':
    raise utils.InputError('--kernel-opt configures the fused kernel; the '
                           'xla backend has no such knobs')
  if args.mesh and args.backend != 'sharded':
    raise utils.InputError('--mesh applies to --backend sharded')
  if args.model_file and not args.estimate:
    raise utils.InputError('--model-file applies to --estimate')
  for key, flag, item in _NOT_PORTED_FLAGS:
    if getattr(args, key):
      raise NotPorted('%s: %s' % (flag, item))
  if args.backend in _NOT_PORTED_BACKENDS:
    raise NotPorted('--backend %s is not ported yet: %s' %
                    (args.backend, _NOT_PORTED_BACKENDS[args.backend]))
  for flag, on in (('--bench', args.bench), ('--tune', args.tune)):
    if on and args.device != 'cuda':
      raise utils.InputError('%s times the kernel on the card; it needs '
                             '--device cuda' % flag)
  if args.tune and not args.run:
    raise utils.InputError('--tune applies to --run')
  if args.tune and args.backend not in ('auto', 'fused'):
    raise utils.InputError('--tune picks the fused kernel\'s config; it '
                           'applies to --backend auto or fused')
  sys.setrecursionlimit(args.recursion_limit)
  level = logging.WARNING - 10 * args.verbose + 10 * args.quiet
  logging.basicConfig(
      level=max(logging.DEBUG, min(logging.CRITICAL, level)),
      format='%(levelname)s:%(name)s:%(lineno)d: %(message)s')

  if args.soda_src == '-':
    source = sys.stdin.read()
  else:
    with open(args.soda_src) as f:
      source = f.read()

  overrides = {}
  for key in ('burst_width', 'unroll_factor', 'replication_factor',
              'iterate', 'border', 'cluster', 'dram_in', 'dram_out'):
    value = getattr(args, key)
    if value is not None:
      overrides[key] = value
  if args.tile_size:
    overrides['tile_size'] = _parse_ints(args.tile_size) + (0,)
  optimizations = {}
  if args.computation_reuse != 'no':
    optimizations['computation-reuse'] = args.computation_reuse
  if args.cr_cost is not None:
    optimizations['cr-cost'] = args.cr_cost
  if args.inline:
    optimizations['inline'] = True
  if args.distribute:
    optimizations['distribute'] = True
  if args.no_separable:
    optimizations['separable'] = 'no'
  if optimizations:
    overrides['optimizations'] = optimizations

  from soda_tpu_torch import api
  try:
    stencil = api.build_stencil(source, **overrides)
  except utils.SemanticError as e:
    raise utils.InputError('invalid SODA program: %s' % e) from None

  did_something = False
  for emit_arg, target in ((args.emit_torch, 'torch'),
                           (args.emit_numpy, 'numpy')):
    if not emit_arg:
      continue
    from soda_tpu_torch.codegen import torch_source
    shape = _parse_ints(args.shape) if args.shape else None
    if emit_arg == '-':
      torch_source.print_code(stencil, sys.stdout, shape, target)
    else:
      with open(emit_arg, 'w') as f:
        torch_source.print_code(stencil, f, shape, target)
    did_something = True

  if args.emit_dot:
    from soda_tpu_torch.backend.plan import make_plan
    text = make_plan(stencil).dot()
    if args.emit_dot == '-':
      sys.stdout.write(text + '\n')
    else:
      with open(args.emit_dot, 'w') as f:
        f.write(text + '\n')
    did_something = True

  if args.estimate:
    _estimate(stencil, args, kernel_opts)
    did_something = True

  if args.compile_stats:
    import json

    from soda_tpu_torch.model.compiled import compiled_stats
    shape = _parse_ints(args.shape) if args.shape else _default_shape(stencil)
    stats = compiled_stats(_executor(stencil, shape, args, kernel_opts))
    text = json.dumps(stats, indent=2) + '\n'
    if args.compile_stats == '-':
      sys.stdout.write(text)
    else:
      with open(args.compile_stats, 'w') as f:
        f.write(text)
    did_something = True

  if args.run:
    did_something = True
    code = _run(stencil, args, kernel_opts)
    if code:
      return code

  if not did_something:
    parser.error('no action requested (--emit-torch/--emit-numpy/--emit-dot/'
                 '--estimate/--compile-stats/--run)')
  return 0


def _estimate(stencil, args, kernel_opts) -> None:
  """--estimate: the cost model's JSON for the kernel at --shape (or the
  default shape) on --device's card (the table's H100 row, said to be
  assumed, on the CPU or where no card is found)."""
  import json

  from soda_tpu_torch.model import estimate as model
  shape = _parse_ints(args.shape) if args.shape else _default_shape(stencil)
  model_params = None
  if args.model_file:
    try:
      with open(args.model_file) as f:
        model_params = json.load(f)
    except (OSError, ValueError) as e:
      raise utils.InputError('--model-file %s: %s' % (args.model_file, e)
                             ) from None
    if not isinstance(model_params, dict):
      raise utils.InputError('--model-file %s: expected a JSON object' %
                             args.model_file)
  if args.estimate == '-':
    model.print_estimation(stencil, shape, sys.stdout, args.device,
                           model_params, kernel_opts)
  else:
    with open(args.estimate, 'w') as f:
      model.print_estimation(stencil, shape, f, args.device, model_params,
                             kernel_opts)


def _executor(stencil, shape, args, kernel_opts):
  """The executor ``--backend`` names, on ``--device``, with the kernel
  options (the per-shard kernel's under sharded) or the tuner's pick.
  A bad option value is an input error."""
  from soda_tpu_torch.backend import get_executor
  try:
    if args.tune:
      from soda_tpu_torch.tools.autotune import tuned_executor
      return tuned_executor(stencil, shape, device=args.device)
    if args.backend == 'replicated':
      return get_executor(stencil, shape, 'replicated', device=args.device,
                          **kernel_opts)
    if args.backend == 'sharded':
      # the port's default inner is the fused kernel per shard (the JAX
      # CLI's is 'xla', compiled there; sodac.py:408)
      return get_executor(stencil, shape, 'sharded', device=args.device,
                          mesh=_mesh(args), inner_opts=kernel_opts)
    return get_executor(stencil, shape, args.backend, device=args.device,
                        **kernel_opts)
  except ValueError as e:
    raise utils.InputError(str(e)) from None


def _mesh(args):
  """The ``--mesh`` over the first distinct visible devices of
  ``--device``, or None for the executor's default mesh."""
  if not args.mesh:
    return None
  import numpy as np

  from soda_tpu_torch.parallel.mesh import Mesh, visible_devices
  dims = _parse_ints(args.mesh)
  if not 1 <= len(dims) <= 2 or min(dims) < 1:
    raise utils.InputError('--mesh takes one or two positive sizes, got %r'
                           % args.mesh)
  n = int(np.prod(dims))
  devices = visible_devices(args.device)
  if len(devices) < n:
    raise utils.InputError(
        '--mesh %s needs %d distinct %s devices, but %d %s visible' % (
            args.mesh, n, args.device, len(devices),
            'is' if len(devices) == 1 else 'are'))
  return Mesh(np.array(devices[:n], dtype=object).reshape(dims),
              'xy'[:len(dims)])


def _describe(executor, kernel_opts) -> str:
  """The kernel's modes and tile (a fused executor's), else the options
  given."""
  config = getattr(executor, 'config', None)
  if config is None:
    return str(kernel_opts)
  from soda_tpu_torch.backend.cuda_source import mode_name
  return '%s, tile %s' % (mode_name(config), executor.plan.tile)


def _run(stencil, args, kernel_opts) -> int:
  """Execute on seeded inputs and verify against the NumPy oracle: the
  analog of running the generated host with SODA_TEST_MAIN."""
  import numpy as np

  from soda_tpu_torch import profiling
  from soda_tpu_torch.backend import reference

  shape = _parse_ints(args.shape) if args.shape else _default_shape(stencil)
  inputs = reference.make_test_inputs(stencil, shape, seed=args.seed)
  params = reference.make_test_params(stencil)
  want = reference.run(stencil, inputs, params)

  t0 = time.perf_counter()
  executor = _executor(stencil, shape, args, kernel_opts)
  if args.backend == 'replicated':
    # R independent grids in one launch; the self-test runs the SAME
    # grid in every batch slot and checks slot 0 against the oracle
    # (reference replication semantics: identical pipelines over
    # independent tiles, core.py:565-614)
    r = executor.replication_factor
    inputs = {k: np.stack([v] * r) for k, v in inputs.items()}
    outs = {k: v[0].cpu().numpy()
            for k, v in executor(inputs, params).items()}
  else:
    outs = {k: v.cpu().numpy() for k, v in executor(inputs, params).items()}
  compile_and_run_s = time.perf_counter() - t0

  # THRESHOLD env override, same knob as the generated hosts
  # (reference frt/host.py:633-641, xilinx/host.py:1201-1204), in the
  # squared-form criterion of frt/host.py:633-657 (tests/checks.py)
  default = utils.threshold_for(stencil.app_name)
  threshold = float(os.environ.get('THRESHOLD', repr(default))) ** 2
  errors = 0
  for name in stencil.output_names:
    if stencil.preserve_border:
      # preserve mode defines the WHOLE grid (boundary carries the
      # paired input) — compare it all, like the hardware gate
      got = outs[name]
      expect = want[name]
    else:
      region = reference.output_valid_slices(stencil, shape, name)
      got = outs[name][region]
      expect = want[name][region]
    if stencil.symbol_table[name].is_float:
      d2 = (got.astype(np.float64) - expect.astype(np.float64)) ** 2
      w2 = expect.astype(np.float64) ** 2
      bad = (d2 > threshold) & (d2 > threshold * w2)
    else:
      bad = got != expect
    errors += int(bad.sum())
  cells = int(np.prod(shape))
  print('INFO: %s!' % ('FAIL' if errors else 'PASS'))
  print('Grid: %s (%d cells), backend=%s, device=%s, compile+run %.3f s, '
        '%d kernel launches' % ('x'.join(map(str, shape)), cells,
                                args.backend, executor.device,
                                compile_and_run_s, executor.launches))
  if args.tune or kernel_opts:
    print('Kernel config: %s' % _describe(executor, kernel_opts))

  if args.bench:
    # CUDA events, each call from a cold L2 (median); the TPU CLI's
    # chained slope timing is for remote-attached TPUs only
    profiling.measure(executor, inputs, params).report()
    print('Device: %s' % profiling.nvidia_smi_line())
  return 1 if errors else 0


if __name__ == '__main__':
  sys.exit(main())
