// The copy-shift probe: shared memory copied into shared memory at an
// offset, by the SM's bulk-copy engine, as a shift.
//
// Replaces the Pallas probes of experiments/exp32_dma_shift.py:81
// (_pallas, built by make_dma_chain, make_store_chain and
// make_overlap_chain) and :226 (make_fan_chain). On the TPU they asked
// whether a VMEM->VMEM DMA at a static offset beats the VPU's rotate as
// a shift, whether it hides under independent VPU work, and whether four
// copies in flight pipeline. Hopper has the same pair of engines: the
// threads, through offset shared-memory reads (the rotate baseline runs
// in probe_narrow.cu's strip kernel), and the bulk-copy engine,
// cp.async.bulk.shared::cluster.shared::cta with mbarrier completion,
// which copies shared memory to shared memory without the threads.
//
// Bound: a shifted step needs one store and one offset read a cell
// (8 bytes through shared memory, 128 bytes a clock an SM) and one min;
// the bytes bound it. The design: a CTA owns whole lines along the
// copy's axis (a band of columns with all rows for row copies, a group
// of whole rows for lane copies), so no copy leaves the CTA and no grid
// barrier is needed; each thread keeps its cells in registers. A step:
//
//   1. the threads store v to slab a;
//   2. fence.proxy.async.shared::cta (their writes, and their earlier
//      reads of b, ordered before the copy engine's accesses), then
//      __syncthreads;
//   3. thread 0 arrives on the step's mbarrier expecting the step's bytes
//      and issues the copy from a at the offset into slab b: a row band is
//      one contiguous copy, a lane copy one per row;
//   4. every thread waits on the barrier's phase parity and takes
//      v = min(v, b).
//
// b starts as x; its tail (the lines past the copy) keeps what it held,
// as the script's stale-tail oracle says. Kinds:
//
//   store (control): a = v ^ key; v = min(v, a), five keys an iteration,
//     the store and reload through st.shared/ld.shared, which the
//     compiler cannot forward; no copy.
//   copy: the steps' distances in turn, one copy each.
//   overlap: as copy, and chain B's register step (vb = min(vb, vb ^
//     0x5A5A); vb += vb >> 3) between the issue and the wait; the output
//     is va ^ vb.
//   fan: one store, four copies at four row offsets into four slabs on
//     four mbarriers in flight before the first wait, then a 4-way min.
//
// cp.async.bulk wants 16-byte addresses and sizes. A row copy moves
// whole rows of a band of a multiple of four lanes, so it is aligned. A
// lane copy at a distance d that is not a multiple of four would start
// at a 4-byte offset: the threads store row r of v at element offset
// (-d) mod 4 of a padded slab row instead, so that the copy's source
// a + pad + d is aligned. What cannot be a bulk copy is refused at
// launch (cudaErrorInvalidValue); no case becomes a thread copy.
//
// The launch is a cluster of one CTA (cudaLaunchKernelEx): on an H100 a
// bulk copy into shared::cluster memory raises an illegal instruction in
// a launch without cluster dimensions. Shapes, distances, copy lengths
// and n are launch arguments. Host interface: plain C, bound with
// ctypes; every launch returns its cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 8;  // cells a thread: a CTA's tile is at most 2048
constexpr int kMaxSteps = 5;  // steps (distances, or store keys) an iteration
constexpr int kFan = 4;  // a fan's copies
constexpr int kMinCtas = 128;  // CTAs a launch aims for (132 SMs)
constexpr int kAlign = 16;  // cp.async.bulk: addresses and sizes
constexpr int kSlabAlign = 128;  // bytes: each slab's start
constexpr int kBarBytes = 128;  // the mbarriers' room, before the slabs
constexpr int kMaxTx = (1 << 20) - 1;  // an mbarrier's transaction count
constexpr int kMaxSmem = 232448;  // shared memory a CTA may use on sm_90

enum Kind { kStore = 0, kCopy = 1, kOverlap = 2, kFanOut = 3 };

struct Plan {
  int rows, cols;  // the block
  int axis;  // 0: row copies (bands of columns), 1: lane copies (rows)
  int tr, tc;  // a CTA's tile: tr rows x tc columns
  int cpt;  // cells a thread
  int sa, sb;  // row strides (ints) of slab a and of each slab b
  int cp;  // rows (axis 0) or lanes (axis 1) a copy moves
  int bytes;  // a copy step's bytes (a fan: each copy's)
  int steps;  // steps an iteration (a fan: copies)
  int d[kMaxSteps];  // distances (store: xor keys)
  int a_at, b_at[kFan];  // slab offsets in bytes from the base
};

__device__ __forceinline__ int add32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// p.d[s], read from the kernel's parameters at constant offsets (a
// dynamic index there would copy the plan to local memory)
__device__ __forceinline__ int step_arg(const Plan& p, int s) {
  int v = p.d[0];
#pragma unroll
  for (int q = 1; q < kMaxSteps; ++q)
    if (s == q) v = p.d[q];
  return v;
}

}  // namespace

// -- the PTX the kernel uses, in small helpers ---------------------------------
// (tests/test_torch_copy_emulation.py defines SODA_EMULATE and gives its
// own: copies that land at issue or when a wait retires them)
#ifndef SODA_EMULATE
namespace {

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

// `bytes` from src to dst, both this CTA's shared memory (dst named in
// the shared::cluster window, where this CTA's own addresses are valid;
// the launch is a cluster of one CTA), completing `bytes` transactions
// on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "r"(smem_addr(src)), "r"(bytes), "r"(smem_addr(bar))
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

__device__ __forceinline__ void st_shared(int* p, int v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(smem_addr(p)), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_shared(const int* p) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(smem_addr(p))
               : "memory");
  return v;
}

// chain B's value, as the compiler must take it here: its step stays
// before the wait that follows (an empty asm emits no instruction)
__device__ __forceinline__ void opaque(int& v) { asm volatile("" : "+r"(v)); }

}  // namespace
#endif  // SODA_EMULATE

namespace {

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  while (!bar_try_wait(bar, parity)) {
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    copy_chain(const int* __restrict__ x, int* __restrict__ y, Plan p,
               long long n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem_raw);
  int* const a = reinterpret_cast<int*>(smem_raw + p.a_at);
  int* b[kFan];
#pragma unroll
  for (int j = 0; j < kFan; ++j)
    b[j] = reinterpret_cast<int*>(smem_raw + p.b_at[j]);
  const int slabs = K == kFanOut ? kFan : 1;
  const int row0 = p.axis ? blockIdx.x * p.tr : 0;
  const int col0 = p.axis ? 0 : blockIdx.x * p.tc;
  int v[kMaxPer], w[kMaxPer], oa[kMaxPer], ob[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    if (k >= p.cpt) break;
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / p.tc, c = idx - r * p.tc;
    oa[k] = r * p.sa + c;
    ob[k] = r * p.sb + c;
    v[k] = x[static_cast<long long>(row0 + r) * p.cols + col0 + c];
    w[k] = v[k];
    if (K != kStore) {
#pragma unroll
      for (int j = 0; j < slabs; ++j) b[j][ob[k]] = v[k];  // b starts as x
    }
  }
  if (K != kStore && threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < slabs; ++j) bar_init(&bars[j], 1);
    fence_bar_init();
  }
  __syncthreads();
  unsigned parity = 0;
#pragma unroll 1
  for (long long it = 0; it < n; ++it) {
    if constexpr (K == kStore) {
      // a = v ^ key stored and read back, a step a key
#pragma unroll 1
      for (int s = 0; s < p.steps; ++s) {
        const int key = step_arg(p, s);
#pragma unroll
        for (int k = 0; k < kMaxPer; ++k) {
          if (k >= p.cpt) break;
          st_shared(a + oa[k], v[k] ^ key);
        }
#pragma unroll
        for (int k = 0; k < kMaxPer; ++k) {
          if (k >= p.cpt) break;
          v[k] = min(v[k], ld_shared(a + oa[k]));
        }
      }
    } else if constexpr (K == kFanOut) {
      // one store, every copy in flight, then the fold
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        if (k >= p.cpt) break;
        a[oa[k]] = v[k];
      }
      fence_async();
      __syncthreads();
      if (threadIdx.x == 0) {
#pragma unroll
        for (int j = 0; j < kFan; ++j) {
          bar_expect(&bars[j], p.bytes);
          bulk_copy(b[j], a + p.d[j] * p.sa, p.bytes, &bars[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kFan; ++j) bar_wait(&bars[j], parity);
      parity ^= 1;
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        if (k >= p.cpt) break;
#pragma unroll
        for (int j = 0; j < kFan; ++j) v[k] = min(v[k], b[j][ob[k]]);
      }
    } else {
#pragma unroll 1
      for (int s = 0; s < p.steps; ++s) {
        const int d = step_arg(p, s);
        const int pad = p.axis ? (-d) & 3 : 0;
#pragma unroll
        for (int k = 0; k < kMaxPer; ++k) {
          if (k >= p.cpt) break;
          a[oa[k] + pad] = v[k];
        }
        fence_async();
        __syncthreads();
        if (threadIdx.x == 0) {
          if (p.axis == 0) {
            bar_expect(&bars[0], p.bytes);
            bulk_copy(b[0], a + d * p.sa, p.bytes, &bars[0]);
          } else {
            bar_expect(&bars[0], p.bytes);
            for (int r = 0; r < p.tr; ++r)
              bulk_copy(b[0] + r * p.sb, a + r * p.sa + pad + d, p.cp * 4,
                        &bars[0]);
          }
        }
        if constexpr (K == kOverlap) {
          // chain B's step in registers while the copy flies
#pragma unroll
          for (int k = 0; k < kMaxPer; ++k) {
            if (k >= p.cpt) break;
            w[k] = min(w[k], w[k] ^ 0x5A5A);
            w[k] = add32(w[k], w[k] >> 3);
            opaque(w[k]);
          }
        }
        bar_wait(&bars[0], parity);
        parity ^= 1;
#pragma unroll
        for (int k = 0; k < kMaxPer; ++k) {
          if (k >= p.cpt) break;
          v[k] = min(v[k], b[0][ob[k]]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    if (k >= p.cpt) break;
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / p.tc, c = idx - r * p.tc;
    y[static_cast<long long>(row0 + r) * p.cols + col0 + c] =
        K == kOverlap ? v[k] ^ w[k] : v[k];
  }
}

using Launch = cudaError_t (*)(const int*, int*, const Plan&, long long, int,
                               int, cudaStream_t);

template <int K>
cudaError_t launch_kind(const int* x, int* y, const Plan& p, long long n,
                        int ctas, int smem, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(copy_chain<K>);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return err;
  // a cluster of one CTA: on an H100 a bulk copy into shared::cluster
  // memory raises an illegal instruction in a launch without cluster
  // dimensions (a copy from global memory does not)
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, copy_chain<K>, x, y, p, n);
}

const Launch kLaunch[] = {&launch_kind<kStore>, &launch_kind<kCopy>,
                          &launch_kind<kOverlap>, &launch_kind<kFanOut>};

int round_up(int v, int to) { return (v + to - 1) / to * to; }

// a CTA's tile along `axis`: as many lines as keep at least kMinCtas
// CTAs, up to kThreads * kMaxPer cells, at least a cell a thread (a row
// band a multiple of four lanes); false if the block has none
bool plan_tile(int axis, int rows, int cols, Plan* p) {
  const int len = axis ? cols : rows, lines = axis ? rows : cols;
  int per = axis ? 1 : 4;
  while (2 * per * len <= kThreads * kMaxPer && lines % (2 * per) == 0 &&
         lines / (2 * per) >= kMinCtas)
    per *= 2;
  while (per * len < kThreads && lines % (2 * per) == 0) per *= 2;
  const int cells = per * len;
  if (lines % per || cells % kThreads || cells > kThreads * kMaxPer)
    return false;
  p->tr = axis ? per : rows;
  p->tc = axis ? cols : per;
  p->cpt = cells / kThreads;
  return true;
}

}  // namespace

extern "C" {

// Kind 0, store: `args` the xor keys; 1, copy: the steps' distances; 2,
// overlap: the same, chain B beside them; 3, fan: the four copies'
// distances (rows). `n_args` of them (1 to kMaxSteps; a fan kFan), n
// iterations on the rows x cols int32 block x into y, copies of `cp`
// rows (axis 0) or lanes (axis 1) from a at each distance to b's start.
// ctas receives the grid size.
int probe_copy_launch(int kind, int axis, const int* args, int n_args,
                      int rows, int cols, int cp, const void* x, void* y,
                      long long n, void* stream, int* ctas) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (kind < kStore || kind > kFanOut || (axis != 0 && axis != 1) ||
      n < 1 || rows < 1 || cols < 1 || n_args < 1 || n_args > kMaxSteps ||
      (kind == kFanOut && (n_args != kFan || axis != 0)) || ctas == nullptr)
    return bad;
  Plan p = {};
  p.rows = rows;
  p.cols = cols;
  p.axis = kind == kStore ? 0 : axis;
  p.steps = n_args;
  for (int s = 0; s < kMaxSteps; ++s) p.d[s] = s < n_args ? args[s] : 0;
  if (!plan_tile(p.axis, rows, cols, &p)) return bad;
  const int len = p.axis ? cols : rows;
  if (kind != kStore) {
    for (int s = 0; s < n_args; ++s)
      if (args[s] < 0 || cp < 1 || args[s] + cp > len) return bad;
    // row copies move whole rows of a band of a multiple of four lanes;
    // lane copies a multiple of four lanes from an aligned source
    if (p.axis == 1 && (cp % 4 || cols % 4)) return bad;
  }
  p.cp = cp;
  p.sb = p.tc;
  p.sa = p.axis ? p.tc + 4 : p.tc;  // room for the lane copies' pad
  const long long bytes = p.axis ? 4LL * p.tr * cp : 4LL * cp * p.sa;
  if (kind != kStore && (bytes % kAlign || bytes > kMaxTx)) return bad;
  p.bytes = static_cast<int>(bytes);
  const int slab_a = round_up(4 * p.tr * p.sa, kSlabAlign);
  const int slab_b = round_up(4 * p.tr * p.sb, kSlabAlign);
  p.a_at = kBarBytes;
  const int slabs = kind == kStore ? 0 : kind == kFanOut ? kFan : 1;
  for (int j = 0; j < kFan; ++j)
    p.b_at[j] = kBarBytes + slab_a + (j < slabs ? j : 0) * slab_b;
  const int smem = kBarBytes + slab_a + slabs * slab_b;
  if (smem > kMaxSmem) return bad;
  *ctas = p.axis ? rows / p.tr : cols / p.tc;
  return static_cast<int>(kLaunch[kind](
      static_cast<const int*>(x), static_cast<int*>(y), p, n, *ctas, smem,
      static_cast<cudaStream_t>(stream)));
}

const char* probe_copy_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
