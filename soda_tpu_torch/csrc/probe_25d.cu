// The 2.5-D jacobi probe: two fused jacobi2d sweeps over a walk of row
// tiles.
//
// Replaces the Pallas probe experiments/exp9_layout25d.py:108 (build_25d).
// On the TPU it asked whether seeing the (h, W) grid as (h, W/128, 128)
// makes the sweeps' north and south shifts free (a plane stride, not the
// sublane axis), at the cost of a chunk-boundary fix-up for the lane
// shifts. A GPU has no sublane axis, so the reshape itself is free here;
// what carries over is the kernel's shape: a walk of row slabs, two
// fused sweeps on each, against the generated 2-D kernel (the same
// comparison the script makes with PallasExecutor).
//
// The function: y = S(S(x)) on rows [2, h-2), all columns, where S(v) at
// (r, c) is (v[r,c] + v[r-1,c] + v[r+1,c] + v[r,c+1] + v[r,c-1]) * 0.2f
// in that order, east and west wrapping at the row's ends (the script's
// roll and chunk fix-up). Rows 0, 1, h-2 and h-1 are not written, as on
// the TPU. Built with --fmad=false, so each add and the multiply round
// on their own, as in the plain version.
//
// Bound: bytes (x read once, y written once: 128 MiB at (8192, 2048),
// 0.0401 ms at 3.35 TB/s); 9 flops a cell are far below it. CTA (bx, by)
// owns the band of kBand columns bx and the run of `block` rows by (the
// script's block), and walks the run a tile of rows at a time. A tile's
// slab is its rows and a 2-row halo each way for the two sweeps, its
// start clipped to the grid as the script clips its, by the band and its
// halo columns, which wrap at the row's ends. Two kernels:
//
// jacobi25d_tmap, the bulk kernel and the default. The last warp's
// first lane fills a ring of `depth` slots, each a slab of kBulkTile + 4
// rows by columns [c0 - 4, c0 + kBand + 4) (544 bytes a row), on the
// slot's "full" mbarrier: one 2-D cp.async.bulk.tensor copy of the slab
// through a tensor map of x, and one of each wrap area, where the first
// and last bands' wrapped 4 columns go (a cp.async.bulk copy a row, 20
// requests a tile from the one thread, took up to 1.5x as long where one
// CTA is resident on an SM: PERF.md). Before it refills a slot the lane
// waits on the slot's "empty" mbarrier. The other `warps` warps share
// out the run's tiles in turn, each slot one warp's; a lane owns 4
// adjacent columns and walks the slab's rows downward holding
// three input rows and three sweep-1 rows in registers, so neither sweep
// goes through shared memory and no barrier separates them. A row is one
// 16-byte shared load of the lane's columns and two 8-byte ones of the
// two columns on each side, from which the lane computes sweep 1 at its
// columns and the one on each side, and sweep 2 at its columns: no lane
// waits on another (shuffles, measured first, put a convergence check
// and a branch before each and kept the compiler from overlapping rows).
// Each output row goes out as a 16-byte store a lane; then the warp
// signals the slot empty. The host picks warps and depth so that the
// grid's CTAs are resident in one wave with rows in flight on every SM
// (layout25d.ring). Per output: 18 x 6 / (16 x 4) sweep-1 values, 0.94
// shared loads, no shared stores.
//
// jacobi25d, the old kernel, kept for comparisons: 256 threads, slabs of
// kTile + 4 rows double-buffered by cp.async (the band in 16-byte copies,
// the halo columns in 4-byte ones; the next tile's copies issued before
// this tile is computed, the script's copy(i + 1).start() before its
// wait); sweep 1 writes a shared-memory buffer, sweep 2 reads it, a CTA
// barrier between them. Shared memory: two slabs and sweep 1's buffer,
// 57,120 bytes.
//
// Host interface: plain C, bound with ctypes; returns a cudaError_t.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// the bulk kernel: a slot is a slab of kBulkRows rows of kSlabStride
// floats (the band at kBandAt as in the old kernel's slab rows), then the
// west and the east wrap areas, 4 floats a row each (the first and the
// last band's wrapped columns), each 128-byte aligned for the tensor copy
constexpr int kBulkTile = 16;  // output rows a tile
constexpr int kBulkRows = kBulkTile + 2 * kHalo;
constexpr int kRowBytes = kSlabStride * static_cast<int>(sizeof(float));
constexpr int kWrapW = kBulkRows * kSlabStride;  // floats into the slot
constexpr int kWrapE = kWrapW + 96;
constexpr int kWrapFloats = kBulkRows * 4;
constexpr int kSlotFloats = kWrapE + kWrapFloats + 16;
constexpr int kSlotBytes = kSlotFloats * static_cast<int>(sizeof(float));
constexpr int kMaxWarps = 8;  // sweeping warps; one more fills
constexpr int kMaxDepth = 24;  // ring slots
constexpr int kBulkBarBytes = 2 * kMaxDepth * 8;  // full, then empty barriers
static_assert(kBulkBarBytes % 128 == 0 && kSlotBytes % 128 == 0 &&
                  (kWrapW * 4) % 128 == 0 && (kWrapE * 4) % 128 == 0 &&
                  kRowBytes % 16 == 0,
              "the ring's copies land 128-byte aligned, its rows 16");

}  // namespace

// -- the PTX the kernels use, in small helpers --------------------------------
// (tests/test_torch_25d_emulation.py defines SODA_EMULATE and gives its
// own: copies that land at issue or when a wait retires them or finds
// their barrier's phase complete)
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the barriers' initialisation, ordered before their use by the copy
// engine and the other threads
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival, and `bytes` more to land before the phase completes
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival (release: this thread's reads of the slot come before it)
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// whether the phase of parity `parity` has completed
__device__ __forceinline__ bool bar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// a box of `map` (box columns by box rows from column c, row r; columns
// outside the tensor read as zeros) into this CTA's shared memory at
// `dst`, 128-byte aligned, dense, completing its bytes on bar
__device__ __forceinline__ void tensor_load(void* dst, const CUtensorMap* map,
                                            int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void trap() { __trap(); }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the 2-D tensor map of x (h rows of w floats, 16-byte aligned) with a box
// of box_cols by box_rows, columns outside read as zeros, L2 fetches of
// 128 bytes (2-3% faster than none at every block; 256 bytes no faster:
// PERF.md); cuTensorMapEncodeTiled looked up through the runtime, so the
// library links no libcuda
int make_map(CUtensorMap* map, const void* x, int h, int w, int box_cols,
             int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(w) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
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

// -- the bulk kernel ----------------------------------------------------------

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  while (!bar_try_wait(bar, parity)) {
  }
}

// the first row of the slab of the bulk tile at row t0, clipped
__device__ __forceinline__ int bulk_slab_start(int t0, int h) {
  return min(max(t0 - kHalo, 0), h - kBulkRows);
}

// the slab of rows [start, start + kBulkRows) of the band at c0 into
// `slot`, columns [c0 - 4, c0 + kBand + 4), by one tensor copy (its
// columns outside the grid land as zeros, unread); the first band's 4
// wrapped west columns into the slot's west wrap area and the last
// band's 4 east ones into its east one, a tensor copy each; all
// completing on `bar`
__device__ __forceinline__ void fill_slab(const CUtensorMap* slab_map,
                                          const CUtensorMap* wrap_map,
                                          float* slot, int start, int c0,
                                          int w, uint64_t* bar) {
  const int west = c0 == 0 ? 4 : 0;  // floats outside the grid
  const int east = c0 + kBand == w ? 4 : 0;
  bar_expect(bar, kBulkRows * kRowBytes +
                      (west + east) * kBulkRows * static_cast<int>(
                          sizeof(float)));
  tensor_load(slot, slab_map, c0 - kBandAt, start, bar);
  if (west) tensor_load(slot + kWrapW, wrap_map, w - 4, start, bar);
  if (east) tensor_load(slot + kWrapE, wrap_map, 0, start, bar);
}

// a slab row as a lane holds it: its four columns 4l .. 4l + 3 of the
// band, and the two on each side, 4l - 2, 4l - 1 and 4l + 4, 4l + 5
struct Row {
  float v[4];
  float west[2];
  float east[2];
};

__device__ __forceinline__ float jpoint(float c, float n, float s, float e,
                                        float w) {
  return ((((c + n) + s) + e) + w) * 0.2f;
}

// a sweep-1 row as a lane holds it: columns 4l - 1 .. 4l + 4
struct Row1 {
  float v[6];
};

// sweep 1 at row b (a above it, c below) at columns 4l - 1 .. 4l + 4
__device__ __forceinline__ Row1 sweep1(const Row& a, const Row& b,
                                       const Row& c) {
  Row1 o;
  o.v[0] = jpoint(b.west[1], a.west[1], c.west[1], b.v[0], b.west[0]);
  o.v[1] = jpoint(b.v[0], a.v[0], c.v[0], b.v[1], b.west[1]);
  o.v[2] = jpoint(b.v[1], a.v[1], c.v[1], b.v[2], b.v[0]);
  o.v[3] = jpoint(b.v[2], a.v[2], c.v[2], b.v[3], b.v[1]);
  o.v[4] = jpoint(b.v[3], a.v[3], c.v[3], b.east[0], b.v[2]);
  o.v[5] = jpoint(b.east[0], a.east[0], c.east[0], b.east[1], b.v[3]);
  return o;
}

// sweep 2 at row b at the lane's columns 4l .. 4l + 3
__device__ __forceinline__ float4 sweep2(const Row1& a, const Row1& b,
                                         const Row1& c) {
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = jpoint(b.v[j + 1], a.v[j + 1], c.v[j + 1], b.v[j + 2], b.v[j]);
  return float4{o[0], o[1], o[2], o[3]};
}

// the tile at row t0 from its slot: slab rows downward, a row one 16-byte
// shared load of the lane's columns and two 8-byte ones of the side
// columns (lane 0's west ones in the first band, lane 31's east ones in
// the last, from the wrap areas), three input rows and three sweep-1
// rows held; sweep 2 at slab rows [2, kBulkRows - 2), grid rows
// start + 2 .., stored where they are the tile's rows of [2, h - 2)
__device__ __forceinline__ void sweep_tile(const float* slot,
                                           float* __restrict__ y, int t0,
                                           int h, int w, int c0, int lane) {
  const int start = bulk_slab_start(t0, h);
  const int lo = max(t0, kHalo), hi = min(t0 + kBulkTile, h - kHalo);
  const bool wrap_w = c0 == 0 && lane == 0;
  const bool wrap_e = c0 + kBand == w && lane == 31;
  const float* own = slot + kBandAt + 4 * lane;
  const float* west = wrap_w ? slot + kWrapW + 2 : own - 2;
  const float* east = wrap_e ? slot + kWrapE : own + 4;
  const int west_step = wrap_w ? 4 : kSlabStride;
  const int east_step = wrap_e ? 4 : kSlabStride;
  float* const out = y + static_cast<long long>(start) * w + c0 + 4 * lane;
  Row in[3];
  Row1 s1[3];
#pragma unroll
  for (int i = 0; i < kBulkRows; ++i) {
    const float4 q = *reinterpret_cast<const float4*>(own + i * kSlabStride);
    const float2 a = *reinterpret_cast<const float2*>(west + i * west_step);
    const float2 b = *reinterpret_cast<const float2*>(east + i * east_step);
    in[i % 3] = Row{{q.x, q.y, q.z, q.w}, {a.x, a.y}, {b.x, b.y}};
    if (i >= 2)  // sweep 1 at slab row i - 1
      s1[(i - 1) % 3] = sweep1(in[(i - 2) % 3], in[(i - 1) % 3], in[i % 3]);
    if (i >= 4 && start + i - 2 >= lo && start + i - 2 < hi)  // sweep 2
      *reinterpret_cast<float4*>(out + static_cast<long long>(i - 2) * w) =
          sweep2(s1[(i - 3) % 3], s1[(i - 2) % 3], s1[(i - 1) % 3]);
  }
}

// the bulk kernel. blockDim.x = (warps + 1) * 32: `warps` warps sweep,
// warp k the tiles t = k, k + warps, ..; the last warp's first lane
// fills. `depth` slots, a multiple of warps, so that each slot is one
// warp's (tile t in slot t % depth): a warp's wait on a slot's full
// barrier then always follows its own wait on that slot's phase before,
// and its parity cannot name a phase yet to complete. Each slot has a
// full and an empty barrier. x's tensor maps: the slab's box, kSlabStride
// by kBulkRows, and a wrap area's, 4 by kBulkRows.
__global__ void __launch_bounds__((kMaxWarps + 1) * 32)
    jacobi25d_tmap(const __grid_constant__ CUtensorMap slab_map,
                   const __grid_constant__ CUtensorMap wrap_map,
                   float* __restrict__ y, int h, int w, int block,
                   int depth) {
  extern __shared__ __align__(128) unsigned char smem_ring[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem_ring);
  uint64_t* const empty = full + kMaxDepth;
  float* const ring = reinterpret_cast<float*>(smem_ring + kBulkBarBytes);
  const int warps = static_cast<int>(blockDim.x / 32) - 1;
  const int warp = static_cast<int>(threadIdx.x / 32);
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int c0 = static_cast<int>(blockIdx.x) * kBand;
  const int run0 = static_cast<int>(blockIdx.y) * block;
  const int tiles = block / kBulkTile;
  if (threadIdx.x == 0) {
    if (reinterpret_cast<uintptr_t>(ring) % 128) trap();
    for (int d = 0; d < depth; ++d) {
      bar_init(&full[d], 1);
      bar_init(&empty[d], 1);
    }
    fence_bar_init();
  }
  __syncthreads();
  if (warp == warps) {
    if (lane == 0) {
      for (int t = 0; t < tiles; ++t) {
        const int slot = t % depth;
        // the slot's last tile, t - depth, has been swept
        if (t >= depth)
          bar_wait(&empty[slot], static_cast<unsigned>(t / depth - 1) & 1u);
        fill_slab(&slab_map, &wrap_map, ring + slot * kSlotFloats,
                  bulk_slab_start(run0 + t * kBulkTile, h), c0, w,
                  &full[slot]);
      }
    }
    return;
  }
#pragma unroll 1
  for (int t = warp; t < tiles; t += warps) {
    const int slot = t % depth;
    bar_wait(&full[slot], static_cast<unsigned>(t / depth) & 1u);
    sweep_tile(ring + slot * kSlotFloats, y, run0 + t * kBulkTile, h, w, c0,
               lane);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);
  }
}

int bulk_smem(int depth) { return kBulkBarBytes + depth * kSlotBytes; }

// the kernels: 0 the old one, 1 the bulk kernel
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(jacobi25d);
    case 1: return reinterpret_cast<const void*>(jacobi25d_tmap);
  }
  return nullptr;
}

bool ring_ok(int warps, int depth) {
  return warps >= 1 && warps <= kMaxWarps && depth >= warps + 2 &&
         depth % warps == 0 && depth <= kMaxDepth;
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

// the same by the bulk kernel: `warps` sweeping warps and a ring of
// `depth` slots a CTA, depth a multiple of warps and at least warps + 2;
// x and y 16-byte aligned (every copy's address and size is a multiple
// of 16 bytes)
int probe_25d_bulk_launch(const void* x, void* y, int h, int w, int block,
                          int warps, int depth, void* stream, int* ctas) {
  if (h < kBulkRows || w < kBand || w % kBand ||
      block < kBulkTile || block % kBulkTile || h % block ||
      !ring_ok(warps, depth) || ctas == nullptr ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bulk_smem(depth);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_of(1), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(w / kBand, h / block);
  const int threads = (warps + 1) * 32;
  *ctas = static_cast<int>(grid.x * grid.y);
  CUtensorMap slab_map, wrap_map;
  int status = make_map(&slab_map, x, h, w, kSlabStride, kBulkRows);
  if (status == 0) status = make_map(&wrap_map, x, h, w, 4, kBulkRows);
  if (status != 0) return status;
  jacobi25d_tmap<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      slab_map, wrap_map, static_cast<float*>(y), h, w, block, depth);
  return static_cast<int>(cudaGetLastError());
}

// CTAs an SM holds of a kernel (0 the old one; 1 the bulk kernel with
// `warps` and `depth`)
int probe_25d_resident(int kind, int warps, int depth, int* per_sm) {
  if (per_sm == nullptr || kernel_of(kind) == nullptr ||
      (kind != 0 && !ring_ok(warps, depth)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kind == 0 ? kSmemBytes : bulk_smem(depth);
  const int threads = kind == 0 ? kThreads : (warps + 1) * 32;
  cudaError_t err = cudaFuncSetAttribute(
      kernel_of(kind), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel_of(kind), threads, smem);
  return static_cast<int>(err);
}

// the geometry the kernels were built with: the band's columns and the
// old kernel's tile rows; the bulk kernel's tile rows, slot and barrier
// bytes, most sweeping warps and slots
int probe_25d_geometry(int* band, int* tile) {
  *band = kBand;
  *tile = kTile;
  return 0;
}

int probe_25d_bulk_geometry(int* tile, int* slot_bytes, int* bar_bytes,
                            int* max_warps, int* max_depth) {
  *tile = kBulkTile;
  *slot_bytes = kSlotBytes;
  *bar_bytes = kBulkBarBytes;
  *max_warps = kMaxWarps;
  *max_depth = kMaxDepth;
  return 0;
}

const char* probe_25d_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
