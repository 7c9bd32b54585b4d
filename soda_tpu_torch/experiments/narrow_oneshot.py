"""The narrow probe's one-shot bodies timed on the device alone.

The 37 one-shot bodies of ``narrow.BODIES`` (forms ``binary`` and
``fold``: exp13's legal probes, exp12's native, SWAR, chain, roll and
widen cases, exp1's and exp2's int16 ops and rolls) each launch a kernel
of a few microseconds, shorter than the host takes to enqueue one
(``narrow.launch``: its checks, a tensor, a ctypes call). Between CUDA
events around one call, or back to back from Python, such a body reads
the host. So each is timed here with no host between its calls:
``profiling.settle``, then ``profiling.replay_us`` (200 calls recorded
in one CUDA graph, replayed twice back to back) in turns, ``ORDER``:
the old form (``narrow.launch(..., _old=True)``), the default kernel,
the default, the old, then its library call (one PyTorch call that
computes the same function) replayed the same way; beside its bound
(``narrow.bound_ms``: the bytes it must move at 3.35 TB/s). Once at the
scripts' shapes, on the scripts' inputs, and once at erosion's bench
shape (8192, 2048) (``BIG``), each body in its own type, a fold's input
with its margin, on seeded random blocks made on the card: at the
scripts' 16-256 KB every call is launch-bound, at 32 MiB a kernel's
design shows against its byte bound. Before its times each body's
default kernel (and old form, where the order has it) is held bit for
bit to its plain version. These launches and the timed ones are not
counted in ``probes.LAUNCHES``.

    python -m soda_tpu_torch.experiments.narrow_oneshot
        [--order old,new,new,old,library] [--shapes script,big] [BODY ...]

On the card only: it exits 1 without one, or when a kernel differs from
its plain version or its old form. One line per body and shape.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from soda_tpu_torch import profiling, utils
from soda_tpu_torch.experiments import narrow, probes

BIG = (8192, 2048)  # erosion's bench shape (testing.CELLS)
ORDER = ('old', 'new', 'new', 'old', 'library')
KINDS = ('old', 'new', 'library')
SHAPES = ('script', 'big')
CALLS = 200  # calls a replayed graph holds
REPLAYS = 2  # replays of the graph a time spans
SETTLE_S = 0.1  # seconds of a body's own work before its first time

ONE_SHOT = tuple(b for b in narrow.BODIES.values() if not b.chain)


def at_shape(body: narrow.NarrowBody, shape: Tuple[int, int]
             ) -> narrow.NarrowBody:
  """``body`` with an output of ``shape``: a fold's input keeps its
  margin past the output, its taps stay as they are."""
  shape = tuple(shape)
  if shape == body.shape:
    return body
  in_shape = None
  if body.in_shape is not None:
    in_shape = tuple(s + i - o for s, i, o in zip(shape, body.in_shape,
                                                  body.shape))
  return dataclasses.replace(
      body, name='%s at %s' % (body.name, 'x'.join(map(str, shape))),
      shape=shape, kshape=None, in_shape=in_shape)


def random_inputs(body: narrow.NarrowBody, device, seed: int = 0
                  ) -> Tuple[torch.Tensor, ...]:
  """Seeded random blocks of ``body``'s input shape and type, made on
  ``device``: integers over their type's whole range, floats in [-1,
  1)."""
  gen = torch.Generator(device=device).manual_seed(seed)
  out = []
  for _ in range(body.n_inputs):
    if body.dtype.is_floating_point:
      x = torch.rand(body.input_shape, generator=gen, device=device,
                     dtype=body.dtype) * 2 - 1
    else:
      info = torch.iinfo(body.dtype)
      x = torch.randint(info.min, info.max + 1, body.input_shape,
                        generator=gen, device=device,
                        dtype=torch.int64).to(body.dtype)
    out.append(x)
  return tuple(out)


def inputs(body: narrow.NarrowBody, device) -> Tuple[torch.Tensor, ...]:
  """A script body's own inputs; a body at another shape, random ones."""
  if narrow.BODIES.get(body.name) is body:
    return narrow.body_inputs(body, device)
  return random_inputs(body, device)


def call(body: narrow.NarrowBody, xs: Sequence[torch.Tensor],
         kind: str) -> Callable[[], torch.Tensor]:
  """One uncounted call of ``kind``: 'new' the default kernel, 'old' the
  old form, 'library' the body's library call."""
  if kind == 'library':
    return lambda: body.library(*xs)
  old = kind == 'old'
  if kind not in ('old', 'new'):
    raise utils.InputError('unknown kind %r (of %s)' % (kind,
                                                         ', '.join(KINDS)))
  return lambda: narrow.launch(body, xs, 1, _old=old)


def times_us(body: narrow.NarrowBody, xs: Sequence[torch.Tensor],
             order: Sequence[str] = ORDER, calls: int = CALLS
             ) -> Dict[str, List[float]]:
  """Device µs a call of each kind in ``order``, replayed back to back,
  after ``SETTLE_S`` seconds of the first kind's calls; a body without a
  library call skips that kind."""
  kinds = [k for k in order if k != 'library' or body.library is not None]
  out: Dict[str, List[float]] = collections.defaultdict(list)
  if kinds:
    profiling.settle(call(body, xs, kinds[0]), SETTLE_S)
  for kind in kinds:
    out[kind].append(profiling.replay_us(call(body, xs, kind), calls=calls,
                                         replays=REPLAYS))
  return dict(out)


def check(body: narrow.NarrowBody, xs: Sequence[torch.Tensor],
          kinds: Sequence[str]) -> Dict[str, bool]:
  """Whether each kernel kind's output equals the plain version's bit
  for bit (a float roll is a copy)."""
  want = body.plain(*xs)
  out = {}
  for kind in kinds:
    got = call(body, xs, kind)()
    out[kind] = (got.dtype == want.dtype and got.shape == want.shape and
                 torch.equal(got, want))
  return out


def run(bodies: Sequence[narrow.NarrowBody] = ONE_SHOT,
        shapes: Sequence[str] = SHAPES, order: Sequence[str] = ORDER,
        log: Callable[[str], None] = print) -> List[Dict[str, object]]:
  """Each body at each of ``shapes`` ('script', 'big'): its kernels held
  to the plain version, then timed (``times_us``) beside its bound. One
  line per body and shape; returns a row per body and shape."""
  device = probes._device('cuda')
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  clock_hz = profiling.max_sm_clock_hz()
  smi = profiling.nvidia_smi_line()
  rows = []
  for shape in shapes:
    if shape not in SHAPES:
      raise utils.InputError('unknown shape %r (of %s)' % (
          shape, ', '.join(SHAPES)))
    for base in bodies:
      body = base if shape == 'script' else at_shape(base, BIG)
      xs = inputs(body, device)
      equal = check(body, xs, sorted({k for k in order if k != 'library'}))
      us = times_us(body, xs, order)
      bound, bound_by = narrow.bound_ms(body, sms, clock_hz)
      best = {k: min(v) for k, v in us.items()}
      row = {'body': base.name, 'shape': shape, 'cells': body.cells,
             'dtype': str(body.dtype).replace('torch.', ''), 'us': us,
             'bound_us': bound * 1e3, 'bound_by': bound_by,
             'equal': equal, 'ok': all(equal.values()), 'card': smi}
      row['share'] = {k: bound * 1e3 / v for k, v in best.items()}
      if 'library' in best:
        row['over_library'] = {k: v / best['library']
                               for k, v in best.items() if k != 'library'}
      rows.append(row)
      log('%-58s %-6s %s  bound %.4g us (%s)  %s | %s' % (
          base.name, shape, '  '.join(
              '%s %s' % (k, '/'.join('%.3f' % t for t in us[k]))
              for k in KINDS if k in us),
          bound * 1e3, bound_by, '  '.join(
              '%s/library %.3f' % (k, r)
              for k, r in sorted(row.get('over_library', {}).items())),
          'bit for bit' if row['ok'] else 'DIFFERS %s' % equal))
  return rows


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--order', default=','.join(ORDER),
                      help='kinds in turn, of %s (default %s)' % (
                          ', '.join(KINDS), ','.join(ORDER)))
  parser.add_argument('--shapes', default=','.join(SHAPES),
                      help='script, big or both (default)')
  parser.add_argument('bodies', nargs='*',
                      help='one-shot body names (default: all 37)')
  args = parser.parse_args(argv)
  try:
    bodies = (tuple(narrow._get(n) for n in args.bodies) if args.bodies
              else ONE_SHOT)
    if any(b.chain for b in bodies):
      raise utils.InputError('chains are timed by their entry points')
    rows = run(bodies, args.shapes.split(','), args.order.split(','))
  except utils.InputError as err:
    print('error: %s' % err, file=sys.stderr)
    return 1
  return 0 if all(row['ok'] for row in rows) else 1


if __name__ == '__main__':
  sys.exit(main())
