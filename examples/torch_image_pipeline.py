"""Example: a two-kernel image pipeline (smooth, then edge-detect), on
the PyTorch/CUDA port.

The counterpart of examples/image_pipeline.py, which composes two fused
Pallas kernels under one jit. Here each stencil is one fused CUDA kernel
(``soda_tpu_torch``'s fused executor) and ``pipeline`` enqueues the two
launches on the card's stream back to back: the edge kernel reads the
smoothed image where the first kernel left it, with no host round trip
in between. Only the printed statistics bring data back to the host.

Run: python examples/torch_image_pipeline.py [--device cuda|cpu]
     [--shape 768,1024]
(``--device cpu`` runs each kernel's plain PyTorch version.)
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from soda_tpu_torch import build_stencil, get_executor

SHAPE = (768, 1024)

SMOOTH = '''
kernel: smooth
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 int16: img(1024, *)
local int16: sx(0, 0) = (img(-1, 0) + img(0, 0) * 2 + img(1, 0)) / 4
output dram 1 int16: s(0, 0) = (sx(0, -1) + sx(0, 0) * 2 + sx(0, 1)) / 4
'''

EDGES = '''
kernel: edges
burst width: 64
unroll factor: 1
iterate: 1
border: ignore
cluster: none
input dram 0 int16: s(1024, *)
local int16: gx(0, 0) = (s(1, -1) - s(-1, -1)) + (s(1, 0) - s(-1, 0)) * 2 +
    (s(1, 1) - s(-1, 1))
local int16: gy(0, 0) = (s(-1, 1) - s(-1, -1)) + (s(0, 1) - s(0, -1)) * 2 +
    (s(1, 1) - s(1, -1))
output dram 1 uint16: mag(0, 0) =
  uint16(min(abs(int32(gx(0, 0))) + abs(int32(gy(0, 0))), 65535))
'''


def make_image(shape):
  """The input image: seeded noise on a checkerboard of 64-pixel cells."""
  rng = np.random.default_rng(0)
  return (rng.integers(0, 256, shape) +
          (np.indices(shape).sum(0) // 64 % 2) * 512).astype(np.int16)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
  parser.add_argument('--shape', default='%d,%d' % SHAPE,
                      help='image height,width')
  args = parser.parse_args(argv)
  shape = tuple(int(x) for x in args.shape.split(','))
  # the DSL's tile width is the image's
  smooth = get_executor(build_stencil(SMOOTH, tile_size=(shape[1], 0)),
                        shape, device=args.device)
  edges = get_executor(build_stencil(EDGES, tile_size=(shape[1], 0)),
                       shape, device=args.device)

  def pipeline(img):
    (s,) = smooth.fn(img)
    (mag,) = edges.fn(s)
    return mag

  (img,) = smooth.prepare({"img": make_image(shape)})
  mag = pipeline(img).cpu().numpy()  # the one wait for the card
  print('pipeline output:', mag.shape, mag.dtype)
  interior = mag[4:-4, 4:-4]
  print('edge response mean %.1f max %d' %
        (interior.mean(), interior.max()))
  assert interior.max() > 0
  return mag


if __name__ == '__main__':
  main()
