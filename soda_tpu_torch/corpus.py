"""The 11-kernel stencil corpus used for correctness tests and benchmarks.

These are the same stencil *workloads* the reference exercises in
reference tests/src/*.soda (blur, contrast, denoise2d/3d, erosion,
heat3d, jacobi2d/3d, seidel2d, sobel2d, xcorr — covering 2D/3D,
multi-stage, multi-input, iterate>1, min-reductions, int and float
element types). Kernel math is restated here as DSL text; the large
radially-symmetric `contrast` coefficient table is generated from its
half-row specification.
"""

from __future__ import annotations

from typing import Dict, Tuple

BLUR = """
kernel: blur
burst width: 256
unroll factor: 16
iterate: 1
border: ignore
cluster: none
input dram 0 uint16: input(2000, *)
local uint16: blur_x(0, 0) = (input(0, 0) + input(0, 1) + input(0, 2)) / 3
output dram 1 uint16: blur_y(0, 0) = (blur_x(0, 0) + blur_x(1, 0) + blur_x(2, 0)) / 3
"""

JACOBI2D = """
kernel: jacobi2d
burst width: 64
unroll factor: 2
iterate: 2
border: ignore
cluster: none
input dram 0 float: t1(32, *)
output dram 1 float: t0(0, 0) =
  (t1(0, 1) + t1(1, 0) + t1(0, 0) + t1(0, -1) + t1(-1, 0)) * 0.2f
"""

JACOBI3D = """
kernel: jacobi3d
burst width: 64
unroll factor: 2
iterate: 2
border: ignore
cluster: none
input dram 0 float: t1(32, 32, *)
output dram 1 float: t0(0, 0, 0) =
  (t1(0, 0, 0) + t1(1, 0, 0) + t1(-1, 0, 0) + t1(0, 1, 0) +
   t1(0, -1, 0) + t1(0, 0, 1) + t1(0, 0, -1)) * 0.142857142f
"""

HEAT3D = """
kernel: heat3d
burst width: 64
unroll factor: 2
iterate: 2
border: ignore
cluster: none
input dram 0 float: in(32, 32, *)
output dram 1 float: out(0, 0, 0) =
  .125f * in(1, 0, 0) + .125f * in(-1, 0, 0) +
  .125f * in(0, 1, 0) + .125f * in(0, -1, 0) +
  .125f * in(0, 0, 1) + .125f * in(0, 0, -1) + .25f * in(0, 0, 0)
"""

SEIDEL2D = """
kernel: seidel2d
burst width: 64
unroll factor: 2
iterate: 2
border: ignore
cluster: none
input dram 0 float: input(32, *)
output dram 1 float: output(0, 0) = (
  input(-1, -1) + input(-1, 0) + input(-1, 1) +
  input(0, -1) + input(0, 0) + input(0, 1) +
  input(1, -1) + input(1, 0) + input(1, 1)) * .1111111f
"""

SOBEL2D = """
kernel: sobel2d
burst width: 64
unroll factor: 4
iterate: 1
border: ignore
cluster: none
input dram 0 int16: img(32, *)
local int16: mag_x(0, 0) =
  (img(1, -1) - img(-1, -1)) + (img(1, 0) - img(-1, 0)) * 3 +
  (img(1, 1) - img(-1, 1))
local uint16: mag_y(0, 0) =
  (img(-1, 1) - img(-1, -1)) + (img(0, 1) - img(0, -1)) * 3 +
  (img(1, 1) - img(1, -1))
output dram 1 uint16: mag(0, 0) =
  65535 - (mag_x(0, 0) * mag_x(0, 0) + mag_y(0, 0) * mag_y(0, 0))
"""

DENOISE2D = """
kernel: denoise2d
burst width: 128
unroll factor: 4
iterate: 1
border: ignore
cluster: none
input dram 0 float: f
input dram 1 float: u(32, *)
local float: diff_u(0, 0) = u(0, 0) - u(0, -1)
local float: diff_d(0, 0) = u(0, 0) - u(0, 1)
local float: diff_l(0, 0) = u(0, 0) - u(-1, 0)
local float: diff_r(0, 0) = u(0, 0) - u(1, 0)
local float: g(0, 0) = 1.0f / sqrt(1.0f +
  diff_u(0, 0) * diff_u(0, 0) + diff_d(0, 0) * diff_d(0, 0) +
  diff_l(0, 0) * diff_l(0, 0) + diff_r(0, 0) * diff_r(0, 0))
local float: r0(0, 0) = u(0, 0) * f(0, 0) * 4.9f
local float: r1(0, 0) =
  (r0(0, 0) * (2.5f + r0(0, 0) * (10.2f + r0(0, 0)))) *
  (4.3f + r0(0, 0) * (5.4f + r0(0, 0) * (6.3f + r0(0, 0))))
output dram 2 float: output(0, 0) =
  (u(0, 0) + 7.7f * (u(0, 1) * g(0, 1) + u(0, -1) * g(0, -1) +
   u(-1, 0) * g(-1, 0) + u(1, 0) * g(1, 0) +
   5.7f * f(0, 0) * r1(0, 0))) *
  (11.1f + 7.7f * (g(0, 1) + g(0, -1) + g(-1, 0) + g(1, 0) + 5.7f))
"""

DENOISE3D = """
kernel: denoise3d
burst width: 64
unroll factor: 2
iterate: 1
border: ignore
cluster: none
input dram 0 float: f
input dram 1 float: u(32, 32, *)
local float: diff_u(0, 0, 0) = u(0, 0, 0) - u(0, -1, 0)
local float: diff_d(0, 0, 0) = u(0, 0, 0) - u(0, 1, 0)
local float: diff_l(0, 0, 0) = u(0, 0, 0) - u(-1, 0, 0)
local float: diff_r(0, 0, 0) = u(0, 0, 0) - u(1, 0, 0)
local float: diff_i(0, 0, 0) = u(0, 0, 0) - u(0, 0, -1)
local float: diff_o(0, 0, 0) = u(0, 0, 0) - u(0, 0, 1)
local float: g(0, 0, 0) = 1.0f / sqrt(0.00005f +
  diff_u(0, 0, 0) * diff_u(0, 0, 0) + diff_d(0, 0, 0) * diff_d(0, 0, 0) +
  diff_l(0, 0, 0) * diff_l(0, 0, 0) + diff_r(0, 0, 0) * diff_r(0, 0, 0) +
  diff_i(0, 0, 0) * diff_i(0, 0, 0) + diff_o(0, 0, 0) * diff_o(0, 0, 0))
local float: r0(0, 0, 0) = u(0, 0, 0) * f(0, 0, 0) * (1.0f / 0.03f)
local float: r1(0, 0, 0) =
  (r0(0, 0, 0) * (2.38944f + r0(0, 0, 0) * (0.950037f + r0(0, 0, 0)))) /
  (4.65314f + r0(0, 0, 0) * (2.57541f + r0(0, 0, 0) *
   (1.48937f + r0(0, 0, 0))))
output dram 2 float: output(0, 0, 0) =
  (u(0, 0, 0) + 5.0f * (u(1, 0, 0) * g(1, 0, 0) +
   u(-1, 0, 0) * g(-1, 0, 0) + u(0, 1, 0) * g(0, 1, 0) +
   u(0, -1, 0) * g(0, -1, 0) + u(0, 0, 1) * g(0, 0, 1) +
   u(0, 0, -1) * g(0, 0, -1) +
   (1.0f / 0.03f) * f(0, 0, 0) * r1(0, 0, 0))) /
  (1.0f + 5.0f * (g(1, 0, 0) + g(-1, 0, 0) + g(0, 1, 0) + g(0, -1, 0) +
   g(0, 0, 1) + g(0, 0, -1) + (1.0f / 0.03f)))
"""


def _taps(name: str, count: int, fmt) -> str:
  return ' + '.join(fmt(i) for i in range(count))


EROSION = """
kernel: erosion
burst width: 64
unroll factor: 4
iterate: 1
border: ignore
cluster: none
input dram 0 int16: input(480, *)
local int16: tmp(0, 9) = min({row})
output dram 1 int16: output(9, 0) = min({col})
""".format(
    row=', '.join('input(0, %d)' % i for i in range(19)),
    col=', '.join('tmp(%d, 0)' % i for i in range(19)),
)

XCORR = """
kernel: xcorr
burst width: 64
unroll factor: 4
iterate: 1
border: ignore
cluster: none
input dram 0 int16: input(480, *)
local int16: tmp1(0, 9) = {row}
local int16: tmp2(9, 0) = {col}
output dram 1 int16: tmp3(0, 0) =
  (int32(tmp2(0, 0)) - input(0, 0)) * input(0, 0) / 256
""".format(
    row=_taps('input', 19, lambda i: 'input(0, %d)' % i),
    col=_taps('tmp1', 19, lambda i: 'tmp1(%d, 0)' % i),
)

# contrast: 17x17 radially-symmetric integer-coefficient filter over a
# float grid. Half-rows (x = 8 outward) for y = 0..8; the table mirrors
# in both x (about 8) and y (about 8).
_CONTRAST_HALF_ROWS = (
    (-106,),
    (-64, -67, -76, -90),
    (-22, -26, -36, -52, -73, -98),
    (18, 14, 3, -15, -39, -67, -98),
    (54, 50, 37, 18, -8, -39, -73),
    (84, 80, 67, 46, 18, -15, -52, -90),
    (108, 103, 89, 67, 37, 3, -36, -76),
    (122, 117, 103, 80, 50, 14, -26, -67),
    (127, 122, 108, 84, 54, 18, -22, -64, -106),
)


def _contrast_terms():
  coeffs: Dict[Tuple[int, int], int] = {}
  for y, half in enumerate(_CONTRAST_HALF_ROWS):
    for dx, c in enumerate(half):
      for xx in {8 + dx, 8 - dx}:
        for yy in {y, 16 - y}:
          coeffs[(xx, yy)] = c
  # the reference table is NOT perfectly symmetric: it omits the
  # (14, 6) reflection (tests/src/contrast.soda has 196 terms, with
  # (2, 6)/(2, 10)/(14, 10) present but (14, 6) absent) — match it
  # term for term
  coeffs.pop((14, 6), None)
  return ' + '.join('input(%d, %d) * %d' % (x, y, c)
                    for (x, y), c in sorted(coeffs.items(),
                                            key=lambda kv: (kv[0][1],
                                                            kv[0][0])))


CONTRAST = """
kernel: contrast
burst width: 64
unroll factor: 2
iterate: 1
border: ignore
cluster: none
input dram 0 float: input(480, *)
output dram 1 float: output(0, 0) = {terms}
""".format(terms=_contrast_terms())

CORPUS: Dict[str, str] = {
    'blur': BLUR,
    'contrast': CONTRAST,
    'denoise2d': DENOISE2D,
    'denoise3d': DENOISE3D,
    'erosion': EROSION,
    'heat3d': HEAT3D,
    'jacobi2d': JACOBI2D,
    'jacobi3d': JACOBI3D,
    'seidel2d': SEIDEL2D,
    'sobel2d': SOBEL2D,
    'xcorr': XCORR,
}

# Small array shapes for functional tests, in array-axis order
# (reversed DSL dims: streaming dimension first, DSL dim 0 last/minor).
# Big benchmark shapes live in bench.py.
TEST_DIMS: Dict[str, Tuple[int, ...]] = {
    'blur': (40, 64),
    'contrast': (40, 64),
    'denoise2d': (24, 32),
    'denoise3d': (12, 32, 32),
    'erosion': (40, 64),
    'heat3d': (12, 32, 32),
    'jacobi2d': (24, 32),
    'jacobi3d': (12, 32, 32),
    'seidel2d': (24, 32),
    'sobel2d': (24, 32),
    'xcorr': (40, 64),
}

# tile-size overrides so functional tests can run small grids for the
# kernels whose DSL declares large tiles (the analog of sodac's
# --tile-size flag, reference sodac.py:67-75).
TEST_TILE_SIZES: Dict[str, Tuple[int, ...]] = {
    'blur': (64, 0),
    'contrast': (64, 0),
    'erosion': (64, 0),
    'xcorr': (64, 0),
}


def build(name: str, **overrides):
  """Build a corpus Stencil (optionally overriding directives)."""
  from soda_tpu_torch import api
  if name in TEST_TILE_SIZES and 'tile_size' not in overrides:
    overrides['tile_size'] = TEST_TILE_SIZES[name]
  return api.build_stencil(CORPUS[name], **overrides)
