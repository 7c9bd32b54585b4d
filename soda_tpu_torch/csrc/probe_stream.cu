// The streaming probe: y = x + 1 over a contiguous float32 array, moved
// through shared memory a tile at a time.
//
// Replaces the Pallas probes experiments/exp27_gridloop.py:122
// (main.build: one kernel entry per grid step against one entry with a
// fori_loop, single and double buffered) and
// experiments/exp30_dma_granularity.py:110 (main.make_loop_db: the
// loop form at fixed bytes, per-step rows, DMAs per fill, prefetch
// depth). The TPU step of `blk` planes (blk x 256 KiB) becomes a tile
// of blk x 4 rows of 256 floats (blk x 4 KiB): a CTA, not the chip,
// walks the tiles here, so a tile is sized for one of 132 SMs.
//
// Bound: bytes. Every input byte is read once and every output byte
// written once (2 x 64 MiB at N = 256: 0.0401 ms at 3.35 TB/s); the add
// is free beside them. The design: a CTA fills a ring of DEPTH tile
// slots with 16-byte cp.async copies, SPLIT commit groups per fill over
// contiguous parts of the tile, keeps the fill of step s + DEPTH - 1 in
// flight while step s computes, and stores each tile from registers
// with coalesced 16-byte stores.
//
//   kind 0 (grid): no CTA carries state to another; CTA b walks tiles
//     b*run .. b*run + run - 1 (run 1: one tile per CTA, the TPU's one
//     kernel entry per grid step).
//   kind 1 (loop): a persistent grid of co-resident CTAs, CTA b walks
//     tiles b, b + gridDim.x, ... (the TPU's one entry with a loop).
//
// Every step commits SPLIT groups, empty ones past the last tile, so
// "fill s has landed" is always cp.async.wait_group (DEPTH-1)*SPLIT.
// Host interface: plain C, bound with ctypes; returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// tile `tile` of x into `slot`: SPLIT commit groups over contiguous
// parts of its `chunks` float4s; a negative tile commits empty groups
template <int SPLIT>
__device__ __forceinline__ void fill(const float4* __restrict__ x,
                                     float4* slot, long long tile,
                                     int chunks) {
  const float4* src = x + tile * chunks;
#pragma unroll
  for (int p = 0; p < SPLIT; ++p) {
    if (tile >= 0) {
      const int hi = (p + 1) * (chunks / SPLIT);
      for (int c = p * (chunks / SPLIT) + threadIdx.x; c < hi; c += kThreads)
        cp_async16(slot + c, src + c);
    }
    cp_async_commit();
  }
}

template <int KIND, int DEPTH, int SPLIT>
__global__ void __launch_bounds__(kThreads)
    probe_stream_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                        long long tiles, int chunks, int run) {
  extern __shared__ float4 smem[];
  long long first, stride, count;
  if (KIND == 1) {
    first = blockIdx.x;
    stride = gridDim.x;
    count = first < tiles ? (tiles - 1 - first) / stride + 1 : 0;
  } else {
    first = static_cast<long long>(blockIdx.x) * run;
    stride = 1;
    count = tiles - first < run ? tiles - first : run;
  }
#pragma unroll
  for (int w = 0; w < DEPTH - 1; ++w)
    fill<SPLIT>(x, smem + (w % DEPTH) * chunks,
                w < count ? first + w * stride : -1, chunks);
  for (long long s = 0; s < count; ++s) {
    const long long ahead = s + DEPTH - 1;
    fill<SPLIT>(x, smem + (ahead % DEPTH) * chunks,
                ahead < count ? first + ahead * stride : -1, chunks);
    cp_async_wait<(DEPTH - 1) * SPLIT>();
    __syncthreads();
    const float4* slot = smem + (s % DEPTH) * chunks;
    float4* out = y + (first + s * stride) * chunks;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      float4 v = slot[c];
      v.x += 1.0f;
      v.y += 1.0f;
      v.z += 1.0f;
      v.w += 1.0f;
      out[c] = v;
    }
    __syncthreads();  // the slot is refilled by a later step
  }
}

using Kernel = void (*)(const float4*, float4*, long long, int, int);

template <int KIND, int DEPTH>
Kernel pick_split(int split) {
  switch (split) {
    case 1: return probe_stream_kernel<KIND, DEPTH, 1>;
    case 2: return probe_stream_kernel<KIND, DEPTH, 2>;
    case 4: return probe_stream_kernel<KIND, DEPTH, 4>;
  }
  return nullptr;
}

template <int KIND>
Kernel pick_depth(int depth, int split) {
  switch (depth) {
    case 1: return pick_split<KIND, 1>(split);
    case 2: return pick_split<KIND, 2>(split);
    case 3: return pick_split<KIND, 3>(split);
    case 4: return pick_split<KIND, 4>(split);
  }
  return nullptr;
}

Kernel pick(int kind, int depth, int split) {
  if (kind == 0) return pick_depth<0>(depth, split);
  if (kind == 1) return pick_depth<1>(depth, split);
  return nullptr;
}

cudaError_t prepare(Kernel k, int smem) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" {

// CTAs of one kind, depth and split that fit on the card at once with
// `chunks` float4s a slot: SMs x resident CTAs per SM (0 if none fits)
int probe_stream_ctas(int kind, int depth, int split, int chunks,
                      int* ctas) {
  Kernel k = pick(kind, depth, split);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = depth * chunks * 16;
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, reinterpret_cast<const void*>(k), kThreads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  *ctas = sms * per_sm;
  return 0;
}

// y = x + 1 over `tiles` tiles of `chunks` float4s, on `ctas` CTAs of
// 256 threads; kind 0 walks `run` consecutive tiles per CTA
int probe_stream_launch(int kind, int depth, int split, const void* x,
                        void* y, long long tiles, int chunks, int run,
                        int ctas, void* stream) {
  Kernel k = pick(kind, depth, split);
  if (k == nullptr || chunks % (split * kThreads) != 0 || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = depth * chunks * 16;
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), tiles, chunks,
      run);
  return static_cast<int>(cudaGetLastError());
}

const char* probe_stream_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
