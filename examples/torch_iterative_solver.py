"""Example: run a Jacobi relaxation to convergence on the PyTorch/CUDA
port.

The counterpart of examples/iterative_solver.py. One fused kernel runs 4
sweeps per launch (one pass over memory for all four). The JAX version
drives it from one device-side ``while_loop`` that checks the residual
after every launch. Here ``soda_tpu_torch.chained`` runs a batch of
launches as one replay of a CUDA graph, and the host checks the
residual of each batch's last launch: that check costs one
synchronisation per batch. Where a batch ends below the tolerance, its
launches are run again one at a time from the batch's start to find the
first launch below it, where the JAX loop stops (the residual of
Jacobi's sweeps does not grow, so no earlier batch held one), so both
stop after the same sweep.

Run: python examples/torch_iterative_solver.py [H] [W] [--device cuda|cpu]
     [--batch LAUNCHES]
"""

import argparse
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from soda_tpu_torch import build_stencil, chained, get_executor

SHAPE = (512, 512)
SWEEPS_PER_LAUNCH = 4
TOLERANCE = 1e-5
MAX_SWEEPS = 512
BATCH = 16  # launches between residual checks

JACOBI = '''
kernel: jacobi
burst width: 64
unroll factor: 1
iterate: %d
border: preserve
cluster: none
input dram 0 float: u(512, *)
output dram 1 float: un(0, 0) =
  (u(0, 1) + u(1, 0) + u(0, -1) + u(-1, 0)) * 0.25f
''' % SWEEPS_PER_LAUNCH


def solve(ex, u, batch):
  """Launch until the residual (the largest change a launch made) drops
  to TOLERANCE or MAX_SWEEPS are done: (u, residual, sweeps)."""
  runs = {}  # launches -> its chained run
  residual, sweeps = 1.0, 0
  while residual > TOLERANCE and sweeps < MAX_SWEEPS:
    n = min(batch, (MAX_SWEEPS - sweeps) // SWEEPS_PER_LAUNCH)
    start = u
    prev = u
    if n > 1:
      run = runs.setdefault(n - 1, chained(ex, n - 1))
      (prev,) = run(u)
    (u,) = ex.fn(prev)
    residual = float(torch.max(torch.abs(u - prev)))  # the batch's sync
    sweeps += n * SWEEPS_PER_LAUNCH
    if residual <= TOLERANCE and n > 1:
      u, sweeps, residual = start, sweeps - n * SWEEPS_PER_LAUNCH, 1.0
      while residual > TOLERANCE:
        (nxt,) = ex.fn(u)
        residual = float(torch.max(torch.abs(nxt - u)))
        u, sweeps = nxt, sweeps + SWEEPS_PER_LAUNCH
  return u, residual, sweeps


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('h', nargs='?', type=int, default=SHAPE[0])
  parser.add_argument('w', nargs='?', type=int, default=SHAPE[1])
  parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
  parser.add_argument('--batch', type=int, default=BATCH,
                      help='launches between residual checks')
  args = parser.parse_args(argv)
  h, w = args.h, args.w

  stencil = build_stencil(JACOBI, tile_size=(w, 0))
  ex = get_executor(stencil, (h, w), device=args.device)
  print('executor: %s (block_rows=%s)' %
        (type(ex).__name__, getattr(ex, 'block_rows', 'n/a')))

  # boundary conditions: hot left edge, cold elsewhere; border:
  # preserve keeps them fixed across sweeps
  u0 = torch.zeros((h, w), dtype=torch.float32, device=ex.device)
  u0[:, 0] = 1.0
  u, residual, sweeps = solve(ex, u0, args.batch)
  print('converged to residual %.2e after %d sweeps' % (residual, sweeps))
  mean = float(torch.mean(u[1:-1, 1:-1]))
  print('interior mean %.4f (expect > 0: heat diffused from the edge)' %
        mean)
  assert mean > 0
  return u, residual, sweeps


if __name__ == '__main__':
  main()
