// The chain probe: one launch applies a body n times to a (256, 1024)
// block, int32 or float32.
//
// Replaces the Pallas probes experiments/exp24_stage_tax.py:75 and
// experiments/exp45_transcendental_tax.py:71 (`pallas_loop`: a
// fori_loop applying `body` to a VMEM-resident block). A body is a chain
// of elementwise steps and wrap-around shifts, v[(i + d) % S] along an
// axis (the JAX scripts' concatenate and pltpu.roll forms are the same
// function and run the same code here). exp24's chains of shifted mins
// alone (roll10, indep10, the --dists bodies) run in the narrow probe's
// strip kernel (probe_narrow.cu), one grid barrier a phase.
//
// Bound: operations. The block (1 MiB) stays in registers, shared
// memory or the 50 MB L2 for the whole chain, so the least time is the
// body's operations over the issue rate of the units that do them. It
// does not fit one SM's 227 KB, so a shift needs other CTAs' cells. The
// design, in three forms:
//
//   0 elementwise: every cell in a register for all n iterations; no
//     barrier (ordinary launch).
//   1 chunk: exp24's make_body_chunk. A CTA loads its K rows plus the 18
//     rows of margin (wrapping) of a W-lane tile into shared memory,
//     runs the five row steps in place (a thread owns a column) and the
//     five lane steps through registers with a block barrier each, and
//     writes K rows: one grid barrier per iteration.
//   2 stencil: exp45's compound bodies, one or two phases per iteration
//     (the g-stage into a third buffer, then the update), one grid
//     barrier each.
//
// Every write of the chain's value goes to y or tmp, arranged so that
// the last lands in y; the first phase reads x. int32 arithmetic wraps
// through uint32 (signed overflow is undefined in C++); >> stays
// arithmetic on the signed value. Built with --fmad=false: every float
// operation rounds on its own, as torch's do; rsqrtf is the approximate
// MUFU path (lax.rsqrt), 1.0f / sqrtf(x) and division are IEEE.
// Host interface: plain C, bound with ctypes; returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 256;
constexpr int kCols = 1024;
constexpr int kCells = kRows * kCols;
constexpr int kThreads = 256;
constexpr int kMargin = 1 + 2 + 4 + 8 + 3;  // exp24's MARGIN0

#define F(x) static_cast<float>(x)

__device__ __forceinline__ int cell(int i, int j) {
  return ((i & (kRows - 1)) * kCols) + (j & (kCols - 1));
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// -- form 0: elementwise bodies ----------------------------------------------

struct Ew10 {  // exp24 body_ew10_real
  using T = int;
  __device__ static int step(int v) {
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      v = min(v, v ^ (0x5A5A + k));
      v = wrap_add(v, v >> 3);
    }
    return v;
  }
};

struct Fma10 {
  using T = float;
  __device__ static float step(float v) {
#pragma unroll
    for (int k = 0; k < 10; ++k) v = v * 0.875f + 0.25f;
    return v;
  }
};

struct MulAdd10 {
  using T = float;
  __device__ static float step(float v) {
#pragma unroll
    for (int k = 0; k < 10; ++k) v = (v + 0.25f) * 0.875f;
    return v;
  }
};

struct Div10 {
  using T = float;
  __device__ static float step(float v) {
#pragma unroll
    for (int k = 0; k < 10; ++k) v = 1.75f / (v + 1.5f);
    return v;
  }
};

struct Recip10 {
  using T = float;
  __device__ static float step(float v) {
#pragma unroll
    for (int k = 0; k < 10; ++k) v = 1.0f / (v + 1.5f);
    return v;
  }
};

struct Sqrt10 {
  using T = float;
  __device__ static float step(float v) {
#pragma unroll
    for (int k = 0; k < 10; ++k) v = sqrtf(v + 0.5f);
    return v;
  }
};

struct Rsqrt10 {
  using T = float;
  __device__ static float step(float v) {
#pragma unroll
    for (int k = 0; k < 10; ++k) v = rsqrtf(v + 0.5f);
    return v;
  }
};

struct RecipSqrt10 {
  using T = float;
  __device__ static float step(float v) {
#pragma unroll
    for (int k = 0; k < 10; ++k) v = 1.0f / sqrtf(v + 0.5f);
    return v;
  }
};

struct GNoroll {
  using T = float;
  __device__ static float step(float v) {
    const float du = v - v * 0.5f, dd = v - v * 0.25f, dl = v - v * 0.75f,
                dr = v - v * 0.125f;
    return rsqrtf(1.0f + du * du + dd * dd + dl * dl + dr * dr);
  }
};

// the denoise2d update after the g-stage, from a cell's own value, its
// four neighbours and their g values
__device__ __forceinline__ float update2d(float c, float up, float dn,
                                          float lf, float rt, float gu,
                                          float gd, float gl, float gr) {
  const float r0 = c * c * F(4.9);
  const float r1 = (r0 * (F(2.5) + r0 * (F(10.2) + r0))) *
                   (F(4.3) + r0 * (F(5.4) + r0 * (F(6.3) + r0)));
  const float num =
      c + F(7.7) * (dn * gd + up * gu + rt * gr + lf * gl + F(5.7) * c * r1);
  const float den = F(11.1) + F(7.7) * (gd + gu + gl + gr + F(5.7));
  return (num * den) * F(1e-6) + 0.5f;
}

struct Full2dNoroll {
  using T = float;
  __device__ static float step(float v) {
    const float up = v * 0.5f, dn = v * 0.25f, lf = v * 0.75f,
                rt = v * 0.125f;
    const float du = v - up, dd = v - dn, dl = v - lf, dr = v - rt;
    const float g = rsqrtf(1.0f + du * du + dd * dd + dl * dl + dr * dr);
    return update2d(v, up, dn, lf, rt, g * 0.5f, g * 0.25f, g * 0.75f,
                    g * 0.125f);
  }
};

template <class Op>
__global__ void __launch_bounds__(kThreads)
    chain_ew(const typename Op::T* __restrict__ x,
             typename Op::T* __restrict__ y, long long n) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < kCells;
       c += gridDim.x * blockDim.x) {
    typename Op::T v = x[c];
    for (long long it = 0; it < n; ++it) v = Op::step(v);
    y[c] = v;
  }
}

// -- form 1: chunked chains in shared memory ---------------------------------

template <int K, int W>
__global__ void __launch_bounds__(W)
    chain_chunk(const int* __restrict__ x, int* y, int* tmp, long long n) {
  extern __shared__ int w[];  // (K + kMargin) rows of W lanes
  cg::grid_group grid = cg::this_grid();
  constexpr int kTiles = kCols / W;
  const int r0 = (blockIdx.x / kTiles) * K;
  const int c0 = (blockIdx.x % kTiles) * W;
  const int j = threadIdx.x;
  const int* src = x;
  for (long long it = 0; it < n; ++it) {
    int* dst = ((n - 1 - it) & 1) ? tmp : y;
    for (int r = 0; r < K + kMargin; ++r)
      w[r * W + j] = src[cell(r0 + r, c0 + j)];
    // row steps, min(w[:-d], w[d:]): in place, ascending, column-local
    const int dists[5] = {1, 2, 4, 8, 3};  // exp24's DISTS0 and DISTS1
    int rows = K + kMargin;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      rows -= dists[s];
      for (int r = 0; r < rows; ++r)
        w[r * W + j] = min(w[r * W + j], w[(r + dists[s]) * W + j]);
    }
    __syncthreads();
    // lane steps, wrapping inside the W-lane tile
    int reg[K];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int jd = (j + dists[s]) & (W - 1);
#pragma unroll
      for (int r = 0; r < K; ++r) reg[r] = min(w[r * W + j], w[r * W + jd]);
      if (s == 4) break;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < K; ++r) w[r * W + j] = reg[r];
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < K; ++r) dst[(r0 + r) * kCols + c0 + j] = reg[r];
    src = dst;
    if (it + 1 < n) {
      grid.sync();  // also orders this CTA's reads of w before the reload
    }
  }
}

// -- form 2: exp45's compound bodies -----------------------------------------

__device__ __forceinline__ float at(const float* v, int i, int j) {
  return v[cell(i, j)];
}

template <bool kRsqrt>
struct GStage {  // gstage, and g_norsqrt with an FMA for the rsqrt
  static constexpr int kPhases = 1;
  __device__ static float g(const float*, int, int) { return 0.0f; }
  __device__ static float out(const float* v, const float*, int i, int j) {
    const float c = at(v, i, j);
    const float du = c - at(v, i + 1, j), dd = c - at(v, i - 1, j),
                dl = c - at(v, i, j + 1), dr = c - at(v, i, j - 1);
    const float s = 1.0f + du * du + dd * dd + dl * dl + dr * dr;
    return kRsqrt ? rsqrtf(s) : s * 0.0625f + 0.125f;
  }
};

template <bool kRsqrt>
struct Full2d {  // full2d, and full2d_norsqrt
  static constexpr int kPhases = 2;
  __device__ static float g(const float* v, int i, int j) {
    return GStage<kRsqrt>::out(v, nullptr, i, j);
  }
  __device__ static float out(const float* v, const float* g, int i, int j) {
    return update2d(at(v, i, j), at(v, i + 1, j), at(v, i - 1, j),
                    at(v, i, j + 1), at(v, i, j - 1), at(g, i + 1, j),
                    at(g, i - 1, j), at(g, i, j + 1), at(g, i, j - 1));
  }
};

struct Full3d {
  static constexpr int kPhases = 2;
  __device__ static float g(const float* v, int i, int j) {
    const float c = at(v, i, j);
    const float du = c - at(v, i + 1, j), dd = c - at(v, i - 1, j),
                dl = c - at(v, i, j + 1), dr = c - at(v, i, j - 1),
                di = c - at(v, i + 2, j), dO = c - at(v, i - 2, j);
    return rsqrtf(F(0.00005) + du * du + dd * dd + dl * dl + dr * dr +
                  di * di + dO * dO);
  }
  __device__ static float out(const float* v, const float* g, int i, int j) {
    const float c = at(v, i, j);
    const float up = at(v, i + 1, j), dn = at(v, i - 1, j),
                lf = at(v, i, j + 1), rt = at(v, i, j - 1),
                io = at(v, i + 2, j), oi = at(v, i - 2, j);
    const float gu = at(g, i + 1, j), gd = at(g, i - 1, j),
                gl = at(g, i, j + 1), gr = at(g, i, j - 1),
                gi = at(g, i + 2, j), go = at(g, i - 2, j);
    const float r0 = c * c * F(1.0 / 0.03);
    const float r1 = (r0 * (F(2.38944) + r0 * (F(0.950037) + r0))) /
                     (F(4.65314) + r0 * (F(2.57541) + r0 * (F(1.48937) + r0)));
    const float num = c + F(5.0) * (dn * gd + up * gu + rt * gr + lf * gl +
                                    io * gi + oi * go + F(1.0 / 0.03) * c * r1);
    const float den =
        F(1.0) + F(5.0) * (gd + gu + gl + gr + gi + go + F(1.0 / 0.03));
    return (num / den) * F(1e-6) + 0.5f;
  }
};

template <class Op>
__global__ void __launch_bounds__(kThreads)
    chain_stencil(const float* __restrict__ x, float* y, float* tmp,
                  float* gbuf, long long n) {
  cg::grid_group grid = cg::this_grid();
  const float* src = x;
  const int stride = gridDim.x * blockDim.x;
  for (long long it = 0; it < n; ++it) {
    if (Op::kPhases == 2) {
      for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < kCells;
           c += stride)
        gbuf[c] = Op::g(src, c / kCols, c % kCols);
      grid.sync();
    }
    float* dst = ((n - 1 - it) & 1) ? tmp : y;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < kCells;
         c += stride)
      dst[c] = Op::out(src, gbuf, c / kCols, c % kCols);
    src = dst;
    if (it + 1 < n) grid.sync();
  }
}

// -- launching ---------------------------------------------------------------

cudaError_t co_resident(const void* kernel, int threads, int smem,
                        int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  *blocks = sms * per_sm;
  return cudaSuccess;
}

// a cooperative launch of `blocks` CTAs, or of every co-resident CTA
// (at most one thread a cell) when blocks is 0
cudaError_t cooperative(const void* kernel, int blocks, int threads,
                        int smem, void** args, cudaStream_t stream,
                        int* ctas) {
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return err;
  int most = 0;
  if ((err = co_resident(kernel, threads, smem, &most)) != cudaSuccess)
    return err;
  if (blocks == 0) blocks = most < kCells / threads ? most : kCells / threads;
  if (blocks < 1 || blocks > most) return cudaErrorCooperativeLaunchTooLarge;
  if (ctas != nullptr) *ctas = blocks;
  return cudaLaunchCooperativeKernel(kernel, blocks, threads, args, smem,
                                     stream);
}

template <class Op>
cudaError_t launch_ew(const void* x, void* y, long long n,
                      cudaStream_t stream, int* ctas) {
  using T = typename Op::T;
  const int blocks = kCells / kThreads;
  if (ctas != nullptr) *ctas = blocks;
  chain_ew<Op><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                 static_cast<T*>(y), n);
  return cudaGetLastError();
}

template <class Op>
cudaError_t launch_stencil(const void* x, void* y, void* tmp, void* g,
                           long long n, cudaStream_t stream, int* ctas) {
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  float* tf = static_cast<float*>(tmp);
  float* gf = static_cast<float*>(g);
  void* args[] = {&xf, &yf, &tf, &gf, &n};
  return cooperative(reinterpret_cast<const void*>(chain_stencil<Op>), 0,
                     kThreads, 0, args, stream, ctas);
}

template <int K, int W>
cudaError_t launch_chunk(const void* x, void* y, void* tmp, long long n,
                         cudaStream_t stream, int* ctas) {
  const int* xi = static_cast<const int*>(x);
  int* yi = static_cast<int*>(y);
  int* ti = static_cast<int*>(tmp);
  void* args[] = {&xi, &yi, &ti, &n};
  return cooperative(reinterpret_cast<const void*>(chain_chunk<K, W>),
                     (kRows / K) * (kCols / W), W,
                     (K + kMargin) * W * static_cast<int>(sizeof(int)), args,
                     stream, ctas);
}

}  // namespace

extern "C" {

// the op names of forms 0 and 2, in `op` order: "form0names;form2names"
const char* probe_chain_ops() {
  return "ew10,fma10,muladd10,div10,recip10,sqrt10,rsqrt10,recipsqrt10,"
         "g_noroll,full2d_noroll;gstage,g_norsqrt,full2d,full2d_norsqrt,"
         "full3d";
}

// y = body^n(x) over a (256, 1024) block. form 0: elementwise op `op`;
// 1: chunks of k_rows rows x lane_tile lanes (k_rows 32 x 1024 or 64 x
// 512); 2: compound op `op`. tmp: a second buffer of the block (forms 1,
// 2), g: a third (form 2). ctas (may be null) receives the grid size.
int probe_chain_launch(int form, int op, int k_rows, int lane_tile,
                       const void* x, void* y, void* tmp, void* g,
                       long long n, void* stream, int* ctas) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 0) {
    switch (op) {
      case 0: return launch_ew<Ew10>(x, y, n, s, ctas);
      case 1: return launch_ew<Fma10>(x, y, n, s, ctas);
      case 2: return launch_ew<MulAdd10>(x, y, n, s, ctas);
      case 3: return launch_ew<Div10>(x, y, n, s, ctas);
      case 4: return launch_ew<Recip10>(x, y, n, s, ctas);
      case 5: return launch_ew<Sqrt10>(x, y, n, s, ctas);
      case 6: return launch_ew<Rsqrt10>(x, y, n, s, ctas);
      case 7: return launch_ew<RecipSqrt10>(x, y, n, s, ctas);
      case 8: return launch_ew<GNoroll>(x, y, n, s, ctas);
      case 9: return launch_ew<Full2dNoroll>(x, y, n, s, ctas);
    }
  } else if (form == 1) {
    if (k_rows == 32 && lane_tile == 1024)
      return static_cast<int>(launch_chunk<32, 1024>(x, y, tmp, n, s, ctas));
    if (k_rows == 64 && lane_tile == 512)
      return static_cast<int>(launch_chunk<64, 512>(x, y, tmp, n, s, ctas));
  } else if (form == 2) {
    switch (op) {
      case 0: return launch_stencil<GStage<true>>(x, y, tmp, g, n, s, ctas);
      case 1: return launch_stencil<GStage<false>>(x, y, tmp, g, n, s, ctas);
      case 2: return launch_stencil<Full2d<true>>(x, y, tmp, g, n, s, ctas);
      case 3: return launch_stencil<Full2d<false>>(x, y, tmp, g, n, s, ctas);
      case 4: return launch_stencil<Full3d>(x, y, tmp, g, n, s, ctas);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* probe_chain_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
