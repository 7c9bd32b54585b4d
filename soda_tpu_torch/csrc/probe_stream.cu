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
// is free beside them. Both kernels keep a ring of DEPTH tile slots,
// DEPTH - 1 fills ahead of the step that computes, each fill SPLIT
// copies over contiguous parts of the tile; tile t of a CTA's walk
// lives in slot t % DEPTH.
//
//   kind 0 (grid): no CTA carries state to another; CTA b walks tiles
//     b*run .. b*run + run - 1 (run 1: one tile per CTA, the TPU's one
//     kernel entry per grid step).
//   kind 1 (loop): a persistent grid of co-resident CTAs, CTA b walks
//     tiles b, b + gridDim.x, ... (the TPU's one entry with a loop).
//
// probe_stream_bulk, the default: the TPU script's one DMA in and one
// DMA out a step (pltpu.make_async_copy both ways) on Hopper's bulk-copy
// engine. One thread a CTA arrives on the slot's mbarrier expecting the
// tile's bytes and issues the fill as SPLIT cp.async.bulk copies global
// -> shared; the threads wait on the slot's phase parity, which flips
// each time the slot wraps. The threads add 1 in the slot with 16-byte
// shared loads and stores, each fences its writes for the copy engine,
// the CTA meets, and the one thread stores the tile with a bulk copy
// shared -> global in a bulk group of its own. Before it refills a slot
// it waits until the store of the step before (the slot's last user,
// the newest group) has read it: cp.async.bulk.wait_group.read 0.
// (Stores from registers, a warp of its own issuing the copies, and
// tiles claimed from a counter were measured against this and lost or
// tied: PERF.md §6.)
//
// probe_stream_kernel, the old kernel, kept for comparisons: each
// of 256 threads fills with 16-byte cp.async copies, SPLIT commit groups
// per fill, empty ones past the last tile, so "fill s has landed" is
// always cp.async.wait_group (DEPTH-1)*SPLIT; it stores from registers.
//
// Host interface: plain C, bound with ctypes; returns a cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // the threads that add
constexpr int kBarBytes = 128;  // the bulk kernel's mbarriers, before its ring
constexpr int kMaxTx = (1 << 20) - 1;  // an mbarrier's transaction count

}  // namespace

// -- the PTX the kernels use, in small helpers ---------------------------------
// (tests/test_torch_stream_emulation.py defines SODA_EMULATE and gives its
// own: copies that land at issue or when a wait retires them)
#ifndef SODA_EMULATE
namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// this thread's shared-memory accesses (the generic proxy), ordered
// before later accesses of the copy engine (the async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival, and `bytes` more to land before the phase completes
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
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

// `bytes` from global memory into this CTA's shared memory (named in the
// shared::cluster window, where the CTA's own addresses are valid),
// completing `bytes` transactions on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` from this CTA's shared memory to global memory, in this
// thread's open bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's bulk groups have not read their
// sources yet
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

}  // namespace
#endif  // SODA_EMULATE

namespace {

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  while (!bar_try_wait(bar, parity)) {
  }
}

// -- the bulk kernel ----------------------------------------------------------

// tile `tile` of x into `slot`: SPLIT bulk copies over contiguous parts,
// completing on `bar`, which expects the whole tile
template <int SPLIT>
__device__ __forceinline__ void fill_bulk(const float4* __restrict__ x,
                                          float4* slot, long long tile,
                                          int chunks, uint64_t* bar) {
  const int part = chunks / SPLIT;
  const float4* src = x + tile * chunks;
  bar_expect(bar, static_cast<unsigned>(chunks) * 16u);
#pragma unroll
  for (int p = 0; p < SPLIT; ++p)
    bulk_load(slot + p * part, src + p * part,
              static_cast<unsigned>(part) * 16u, bar);
}

// the threads' adds on one slot, in place, each fenced for the copy engine
__device__ __forceinline__ void add_in_place(float4* slot, int chunks,
                                             int thread) {
  for (int c = thread; c < chunks; c += kThreads) {
    float4 v = slot[c];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    slot[c] = v;
  }
  fence_async();
}

template <int KIND, int DEPTH, int SPLIT>
__global__ void __launch_bounds__(kThreads)
    probe_stream_bulk(const float4* __restrict__ x, float4* __restrict__ y,
                      long long tiles, int chunks, int run) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem_raw);
  float4* const ring = reinterpret_cast<float4*>(smem_raw + kBarBytes);
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
  const unsigned bytes = static_cast<unsigned>(chunks) * 16u;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) bar_init(&full[d], 1);
    fence_bar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (long long w = 0; w < DEPTH - 1 && w < count; ++w)
      fill_bulk<SPLIT>(x, ring + w * chunks, first + w * stride, chunks,
                       &full[w]);
  }
  for (long long s = 0; s < count; ++s) {
    const int slot = static_cast<int>(s % DEPTH);
    const long long ahead = s + DEPTH - 1;
    if (threadIdx.x == 0 && ahead < count) {
      const int to = static_cast<int>(ahead % DEPTH);
      // the slot's last user was step s - 1: its store read it first
      if (s > 0) bulk_wait_read<0>();
      fill_bulk<SPLIT>(x, ring + to * chunks, first + ahead * stride, chunks,
                       &full[to]);
    }
    bar_wait(&full[slot], static_cast<unsigned>(s / DEPTH) & 1u);
    float4* const in = ring + slot * chunks;
    add_in_place(in, chunks, threadIdx.x);
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(y + (first + s * stride) * chunks, in, bytes);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait_read<0>();
}

// -- the old kernel -------------------------------------------------------------

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

// -- template selection ---------------------------------------------------------

using Kernel = void (*)(const float4*, float4*, long long, int, int);

template <int KIND, int DEPTH, int SPLIT>
Kernel pick_kernel(bool old) {
  return old ? probe_stream_kernel<KIND, DEPTH, SPLIT>
             : probe_stream_bulk<KIND, DEPTH, SPLIT>;
}

template <int KIND, int DEPTH>
Kernel pick_split(int split, bool old) {
  switch (split) {
    case 1: return pick_kernel<KIND, DEPTH, 1>(old);
    case 2: return pick_kernel<KIND, DEPTH, 2>(old);
    case 4: return pick_kernel<KIND, DEPTH, 4>(old);
  }
  return nullptr;
}

template <int KIND>
Kernel pick_depth(int depth, int split, bool old) {
  switch (depth) {
    case 1: return pick_split<KIND, 1>(split, old);
    case 2: return pick_split<KIND, 2>(split, old);
    case 3: return pick_split<KIND, 3>(split, old);
    case 4: return pick_split<KIND, 4>(split, old);
  }
  return nullptr;
}

Kernel pick(int kind, int depth, int split, bool old) {
  if (kind == 0) return pick_depth<0>(depth, split, old);
  if (kind == 1) return pick_depth<1>(depth, split, old);
  return nullptr;
}

int smem_of(bool old, int depth, int chunks) {
  return (old ? 0 : kBarBytes) + depth * chunks * 16;
}

cudaError_t prepare(Kernel k, int smem) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// CTAs that fit on the card at once: SMs x resident CTAs per SM
int resident(int kind, int depth, int split, bool old, int chunks,
             int* ctas) {
  Kernel k = pick(kind, depth, split, old);
  if (k == nullptr || ctas == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_of(old, depth, chunks);
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

}  // namespace

extern "C" {

// CTAs of the old kernel of one kind, depth and split that fit on the
// card at once with `chunks` float4s a slot (0 if none fits)
int probe_stream_ctas(int kind, int depth, int split, int chunks,
                      int* ctas) {
  return resident(kind, depth, split, true, chunks, ctas);
}

// the same for the bulk kernel
int probe_stream_bulk_ctas(int kind, int depth, int split, int chunks,
                           int* ctas) {
  return resident(kind, depth, split, false, chunks, ctas);
}

// y = x + 1 over `tiles` tiles of `chunks` float4s, by the old kernel on
// `ctas` CTAs of 256 threads; kind 0 walks `run` consecutive tiles per
// CTA
int probe_stream_launch(int kind, int depth, int split, const void* x,
                        void* y, long long tiles, int chunks, int run,
                        int ctas, void* stream) {
  Kernel k = pick(kind, depth, split, true);
  if (k == nullptr || chunks % (split * kThreads) != 0 || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_of(true, depth, chunks);
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), tiles, chunks,
      run);
  return static_cast<int>(cudaGetLastError());
}

// the same by the bulk kernel; x and y 16-byte aligned (every copy's
// address and size is a multiple of 16 bytes)
int probe_stream_bulk_launch(int kind, int depth, int split, const void* x,
                             void* y, long long tiles, int chunks, int run,
                             int ctas, void* stream) {
  Kernel k = pick(kind, depth, split, false);
  const long long tile_bytes = 16LL * chunks;
  if (k == nullptr || chunks % (split * kThreads) != 0 || ctas < 1 ||
      tile_bytes > kMaxTx || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_of(false, depth, chunks);
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
