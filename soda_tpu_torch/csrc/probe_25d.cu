// The 2.5-D jacobi probe: two fused jacobi2d sweeps over a double-buffered
// walk of row tiles.
//
// Replaces the Pallas probe experiments/exp9_layout25d.py:108 (build_25d).
// On the TPU it asked whether seeing the (h, W) grid as (h, W/128, 128)
// makes the sweeps' north and south shifts free (a plane stride, not the
// sublane axis), at the cost of a chunk-boundary fix-up for the lane
// shifts. A GPU has no sublane axis, so the reshape itself is free here;
// what carries over is the kernel's shape: a double-buffered walk of row
// slabs, two fused sweeps on each, against the generated 2-D kernel
// (the same comparison the script makes with PallasExecutor).
//
// The function: y = S(S(x)) on rows [2, h-2), all columns, where S(v) at
// (r, c) is (v[r,c] + v[r-1,c] + v[r+1,c] + v[r,c+1] + v[r,c-1]) * 0.2f
// in that order, east and west wrapping at the row's ends (the script's
// roll and chunk fix-up). Rows 0, 1, h-2 and h-1 are not written, as on
// the TPU. Built with --fmad=false, so each add and the multiply round
// on their own, as in the plain version.
//
// Bound: bytes (x read once, y written once: 128 MiB at (8192, 2048),
// 0.0401 ms at 3.35 TB/s); 9 flops a cell are far below it. The design:
// CTA (bx, by) owns the band of kBand columns bx and the run of `block`
// rows by (the script's block), and walks the run kTile rows at a time.
// A tile's slab is kTile + 4 rows (a 2-row halo each way for the two
// sweeps, its start clipped to [0, h - kTile - 4] as the script clips
// its) by kBand + 4 columns (the halo columns wrap at the row's ends),
// brought into shared memory with cp.async: the band in 16-byte copies,
// the halo columns in 4-byte ones. Two slab buffers: the next tile's
// copies are issued before this tile is computed (the script's
// copy(i + 1).start() before its wait). Sweep 1 writes a shared-memory
// buffer; sweep 2 reads it into registers and stores the tile's rows of
// [2, h-2) with coalesced stores. Shared memory: two slabs and sweep 1's
// buffer, 57,120 bytes.
//
// Host interface: plain C, bound with ctypes; returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 128;  // columns a CTA owns: one 128-lane chunk
constexpr int kTile = 32;  // output rows a tile
constexpr int kHalo = 2;  // two sweeps, one row or column each
constexpr int kSlabRows = kTile + 2 * kHalo;
// a slab row: 2 spare, the 2 west halo columns, the band (16-byte
// aligned at kBandAt), the 2 east halo columns, 2 spare
constexpr int kBandAt = 4;
constexpr int kSlabStride = kBand + 8;
constexpr int kSlabFloats = kSlabRows * kSlabStride;
// sweep 1's values: slab rows 1 .. kSlabRows - 2, slab columns 1 .. kBand + 2
constexpr int kS1Rows = kSlabRows - 2;
constexpr int kS1Cols = kBand + 2;
constexpr int kS1Stride = kBand + 4;
constexpr int kSmemBytes =
    (2 * kSlabFloats + kS1Rows * kS1Stride) * static_cast<int>(sizeof(float));

}  // namespace

// -- the PTX the kernel uses, in small helpers ---------------------------------
// (tests/test_torch_copy_emulation.py defines SODA_EMULATE and gives its
// own: copies that land at issue or when a wait retires their group)
#ifndef SODA_EMULATE
namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
#endif  // SODA_EMULATE

namespace {

// the first row of tile row t0's slab: two rows before it, clipped
__device__ __forceinline__ int slab_start(int t0, int h) {
  return min(max(t0 - kHalo, 0), h - kSlabRows);
}

// the slab of rows [start, start + kSlabRows) of the band at c0 into
// `slab`: the band's 16-byte chunks, then the halo columns, wrapping at
// the row's ends
__device__ __forceinline__ void fill(const float* __restrict__ x,
                                     float* slab, int start, int c0, int w) {
  constexpr int kChunks = kBand / 4;
  for (int q = threadIdx.x; q < kSlabRows * kChunks; q += kThreads) {
    const int r = q / kChunks, ch = q - r * kChunks;
    cp_async16(slab + r * kSlabStride + kBandAt + 4 * ch,
               x + static_cast<long long>(start + r) * w + c0 + 4 * ch);
  }
  for (int q = threadIdx.x; q < kSlabRows * 2 * kHalo; q += kThreads) {
    const int r = q / (2 * kHalo), j = q - r * (2 * kHalo);
    // j 0, 1: columns c0 - 2, c0 - 1; j 2, 3: c0 + kBand, c0 + kBand + 1
    const int at = j < kHalo ? kBandAt - kHalo + j : kBandAt + kBand + j - kHalo;
    int col = j < kHalo ? c0 - kHalo + j : c0 + kBand + j - kHalo;
    col = col < 0 ? col + w : col >= w ? col - w : col;
    cp_async4(slab + r * kSlabStride + at,
              x + static_cast<long long>(start + r) * w + col);
  }
}

// one jacobi point: (c + n + s + e + w) * 0.2f, in that order
__device__ __forceinline__ float point(const float* p, int stride) {
  return ((((p[0] + p[-stride]) + p[stride]) + p[1]) + p[-1]) * 0.2f;
}

__global__ void __launch_bounds__(kThreads)
    jacobi25d(const float* __restrict__ x, float* __restrict__ y, int h,
              int w, int block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const slabs = reinterpret_cast<float*>(smem_raw);
  float* const s1 = slabs + 2 * kSlabFloats;
  const int c0 = blockIdx.x * kBand;
  const int run0 = blockIdx.y * block;
  const int tiles = block / kTile;
  fill(x, slabs, slab_start(run0, h), c0, w);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int t0 = run0 + t * kTile;
    // the next tile's copies, into the other buffer (sweep 1 of the tile
    // before read it, and a barrier followed), then this tile's wait
    if (t + 1 < tiles)
      fill(x, slabs + ((t + 1) & 1) * kSlabFloats,
           slab_start(t0 + kTile, h), c0, w);
    cp_async_commit();  // (empty past the run's last tile)
    cp_async_wait<1>();
    __syncthreads();
    // sweep 1, slab -> s1: s1 (i, j) is slab row i + 1, slab column j + 1
    const float* slab = slabs + (t & 1) * kSlabFloats + (kBandAt - kHalo);
    for (int q = threadIdx.x; q < kS1Rows * kS1Cols; q += kThreads) {
      const int i = q / kS1Cols, j = q - i * kS1Cols;
      s1[i * kS1Stride + j] = point(slab + (i + 1) * kSlabStride + j + 1,
                                    kSlabStride);
    }
    __syncthreads();
    // sweep 2, s1 -> y: grid row g is slab row g - start, s1 row
    // g - start - 1; rows outside [2, h - 2) are not stored
    const int base = t0 - slab_start(t0, h) - 1;
    const int j = threadIdx.x % kBand;
    for (int i = threadIdx.x / kBand; i < kTile; i += kThreads / kBand) {
      const int g = t0 + i;
      if (g < kHalo || g >= h - kHalo) continue;
      y[static_cast<long long>(g) * w + c0 + j] =
          point(s1 + (base + i) * kS1Stride + j + 1, kS1Stride);
    }
  }
}

}  // namespace

extern "C" {

// y (h x w float32) = two jacobi sweeps of x on rows [2, h - 2), CTAs of
// kBand columns by `block` rows. ctas receives the grid size.
int probe_25d_launch(const void* x, void* y, int h, int w, int block,
                     void* stream, int* ctas) {
  if (h < kSlabRows || w < kBand || w % kBand || block < kTile ||
      block % kTile || h % block || ctas == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(jacobi25d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(w / kBand, h / block);
  *ctas = static_cast<int>(grid.x * grid.y);
  jacobi25d<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), h, w, block);
  return static_cast<int>(cudaGetLastError());
}

// the geometry the kernel was built with: its band's columns and its
// tile's rows
int probe_25d_geometry(int* band, int* tile) {
  *band = kBand;
  *tile = kTile;
  return 0;
}

const char* probe_25d_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
