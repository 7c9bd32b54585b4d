"""Example: sharded Jacobi relaxation, one dispatch for the whole run,
on the PyTorch/CUDA port.

The counterpart of examples/multichip_relaxation.py. The grid is split
over a mesh of shards (here a (4,) mesh that repeats one device, as the
port's tests and smoke run hold a mesh on one card): every sweep batch
extends each shard with its neighbours' halo rows and runs the fused
kernel on it. ``soda_tpu_torch.chained`` drives the batches: on the
card its first call records all of them (exchanges, launches, crops and
the preserved border) in one CUDA graph, and a later call is one replay
of it; the arrays stay resident and sharded throughout.

Run: python examples/torch_multichip_relaxation.py [H] [W] [BATCHES]
     [--device cuda|cpu] [--mesh 4]
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import soda_tpu_torch
from soda_tpu_torch.parallel.spmd import ShardedExecutor
from soda_tpu_torch.testing import repeated_mesh

SHAPE, BATCHES, MESH = (1024, 512), 25, 4

JACOBI4 = '''
kernel: jacobi
burst width: 64
unroll factor: 1
iterate: 4
border: preserve
cluster: none
input dram 0 float: u(512, *)
output dram 1 float: un(0, 0) =
  (u(0, 1) + u(1, 0) + u(0, -1) + u(-1, 0)) * 0.25f
'''


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('h', nargs='?', type=int, default=SHAPE[0])
  parser.add_argument('w', nargs='?', type=int, default=SHAPE[1])
  parser.add_argument('batches', nargs='?', type=int, default=BATCHES)
  parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
  parser.add_argument('--mesh', type=int, default=MESH,
                      help='shards along the streaming axis')
  args = parser.parse_args(argv)
  h, w, batches = args.h, args.w, args.batches

  stencil = soda_tpu_torch.build_stencil(JACOBI4, tile_size=(w, 0))
  ex = ShardedExecutor(stencil, (h, w),
                       mesh=repeated_mesh(args.device, (args.mesh,)))
  print('devices: %d, %d sweeps per batch, %d batches -> %d sweeps' %
        (ex.n_shards, stencil.iterate, batches, stencil.iterate * batches))

  # border: preserve freezes the whole invalid ring (width = the
  # 4-sweep halo), exactly like the reference's untiling, so the
  # Dirichlet condition is the 4-column hot band on the left
  u0 = np.zeros((h, w), np.float32)
  u0[:, :4] = 1.0
  run = soda_tpu_torch.chained(ex, batches)
  (u_final,) = run(*ex.prepare({'u': u0}))
  u_final = u_final.gather().cpu().numpy()[:h]
  print('mean temperature: %.6f' % u_final.mean())
  print('interior sample [h/2, :8]:', np.round(u_final[h // 2, :8], 4))
  return u_final


if __name__ == '__main__':
  main()
