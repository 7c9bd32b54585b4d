"""Device time per call of the benchmark cells, back to back.

    python -m soda_tpu_torch.back_to_back [--label L] [CELL ...]

For each named cell of ``testing.CELLS`` (default: all 12), builds the
executor through ``get_executor`` and prints the device's and the
host's microseconds per ``executor.fn`` call over 200 back-to-back
calls (``profiling.back_to_back_us``, warm L2), with the card's
nvidia-smi line. It uses only entry points that every version of the
port has had, so a copy of this file placed in an older checkout's
``soda_tpu_torch/`` times that checkout: to compare two versions, run
old, new, new, old one after another on one card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import torch

import soda_tpu_torch
from soda_tpu_torch import profiling, testing

CALLS = 200


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--label', default='', help='tag for each line')
  parser.add_argument('cells', nargs='*',
                      default=[name for name, _, _ in testing.CELLS])
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('back_to_back: no CUDA device', file=sys.stderr)
    return 1
  smi = profiling.nvidia_smi_line()
  for name, shape, overrides in testing.CELLS:
    if name not in args.cells:
      continue
    stencil = testing.build_cell(name, overrides)
    ex = soda_tpu_torch.get_executor(stencil, shape)
    fn_args = ex.prepare(testing.make_test_inputs(stencil, shape),
                         testing.make_test_params(stencil))
    host_us, device_us = profiling.back_to_back_us(lambda: ex.fn(*fn_args),
                                                   calls=CALLS)
    print('[b2b] %s %-12s device %.2f us/call  host %.2f us/call  (n=%d) | %s'
          % (args.label, name, device_us, host_us, CALLS, smi), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
