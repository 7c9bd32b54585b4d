// The narrow probe: the 16-bit and op-rate probes of six JAX scripts as
// hand-written kernels, on blocks whose shape is a launch argument.
//
// Replaces the Pallas probes experiments/exp13_narrow_i16.py:57
// (legal_probes.run) and :195 (chain_time.make),
// exp29_pack_i16.py:72 (pallas_loop), exp16_swar_erosion.py:76 and :126
// (wide_kernel.make, swar_kernel.make), exp1_value_mode.py:50 and :76
// (probe_i16_ops, probe_sublane_roll), exp2_diag.py:87 and :148
// (vpu_chain.make, probe_i16_ops) and exp12_mosaic_reprobe.py:68, :147,
// :161 and :174 (main.run1, chain_kernel, roll_kernel, widen_kernel). On
// the TPU they asked which 16-bit ops Mosaic lowers and what each costs
// on a block kept in VMEM. nvcc lowers them all, so here they price each
// op: a time per element-op, and the SASS each body compiles to.
//
// Bound: a one-shot body (binary, fold) reads its inputs and writes its
// output once, so its bytes bound it; a chain keeps its block on chip
// for all n iterations, so its operations do. Four forms:
//
//   binary: y = f(a, b), a cell (or a 32-bit word of two packed int16)
//     at a time; vec_binary on the card, 16 bytes a thread and access.
//   ew: y = f^n(x), each cell in a register for all n iterations, no
//     barrier. Each iteration's body takes a runtime zero (a launch
//     argument) into one of its own operations, so that neither nvcc's
//     front end nor ptxas can fold iterations into one another (n
//     doublings into one shift): the main loop runs kUnroll iterations
//     a trip, each with the body's instructions.
//   fold: y[i, j] = x[i + di0, j + dj0] (+ or min) x[i + di1, j + dj1]
//     ..., indices wrapping modulo x's extents: a fold over shifted
//     slices of an input with a margin, or (one tap) a roll; tile_fold
//     on the card, each tile's input in shared memory once.
//   strip: a chain of wrap-around shifts, n iterations in one launch. A
//     CTA holds a strip of whole lines along a phase's axis (rows for a
//     lane shift, columns for a sublane shift) in registers and
//     exchanges them through shared memory once a step (two buffers,
//     one block barrier a step), so a wrap never leaves the CTA and a
//     body of one phase needs no grid barrier in all n iterations. A
//     body of several phases (exp16's two stages; exp24's one-step
//     phases) runs each phase over its own strips, values ping-ponged
//     through global memory (the L2), one grid barrier a phase
//     (cooperative launch). A phase's steps are chained (each reads the
//     step before) or, in an independent phase (exp24's indep10; a
//     cooperative launch), all read the phase's values: the taps along
//     the phase's axis from the exchange, those along the other axis
//     ("cross") from global memory, combined by a min. A MinI32 body of
//     independent phases along the lanes whose block one cluster holds
//     runs strip_cluster instead (one thread-block cluster, the block in
//     bands of rows, see its section).
//
// 16-bit values compute in 32 bits and store the low 16, wrapping as the
// scripts' int16 arithmetic does; 32-bit integer arithmetic wraps through
// uint32; >> on a signed value stays arithmetic. A packed body holds two
// int16 in a 32-bit word (the low half first) and comes in two forms of
// one function: CUDA's intrinsics (__vmins2 for a signed pair min,
// __vadd2 for a pair add, __byte_perm for the half-word funnel shift) and
// the script's own bitwise sequence. On sm_90 each intrinsic is one
// instruction: VIMNMX.S16x2 (the DPX unit's pair min; CUDA 12.9's
// headers declare its two-way form only as __vmins2, the DPX names being
// the three-way and relu ones), VIADD.16x2, PRMT. Built with --fmad=false:
// a float multiply and add round on their own. Host interface: plain C,
// bound with ctypes; every launch returns its cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFold = 24;  // taps of a fold
constexpr int kMaxSteps = 10;  // steps of a strip phase, and its cross taps
constexpr int kMaxPhases = 10;  // phases of a strip body
constexpr int kUnroll = 16;  // ew iterations a trip of the main loop
// strip cells per thread: a (2048)-cell strip, the longest line here;
// the cells' values and positions stay in registers for a strip's
// whole chain, well under 128 a thread
constexpr int kMaxPer = 8;
constexpr int kStripCells = kThreads * kMaxPer;
constexpr int kMinStrips = 128;  // strips a phase aims for (132 SMs)

__device__ __forceinline__ int add32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int sub32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int mul32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int shl32(int a, int k) {
  return static_cast<int>(static_cast<unsigned>(a) << k);
}

// exp12's, exp13's and exp16's per-half signed min of two packed words,
// in the scripts' own bitwise sequences
__device__ __forceinline__ unsigned swar_min_bias(unsigned x, unsigned y) {
  const unsigned bias = 0x80008000u;  // exp12: sign-bias, unsigned halves
  const unsigned xb = x ^ bias, yb = y ^ bias;
  const unsigned lo = min(xb & 0xFFFFu, yb & 0xFFFFu);
  const unsigned hi = min(xb & 0xFFFF0000u, yb & 0xFFFF0000u);
  return (lo | hi) ^ bias;
}
__device__ __forceinline__ int swar_min_top(int x, int y) {
  const int m = static_cast<int>(0xFFFF0000u);  // shift-to-top compares
  const int lo = (shl32(x, 16) < shl32(y, 16) ? x : y) & 0xFFFF;
  const int hi = ((x & m) < (y & m) ? x : y) & m;
  return lo | hi;
}

// -- binary: y = f(a, b) -----------------------------------------------------

#define BINARY(Name, Type, expr)                  \
  struct Name {                                   \
    using T = Type;                               \
    __device__ static T f(T a, T b) {             \
      return static_cast<T>(expr);                \
    }                                             \
  };

BINARY(I16Min, short, min(static_cast<int>(a), static_cast<int>(b)))
BINARY(I16Max, short, max(static_cast<int>(a), static_cast<int>(b)))
BINARY(I16Add, short, add32(a, b))
BINARY(I16Mul, short, mul32(a, b))
BINARY(U16Min, unsigned short,
       min(static_cast<unsigned>(a), static_cast<unsigned>(b)))
BINARY(I32Mix, int, ((a & 0xFFFF) | shl32(b, 16)) ^ ((a >> 15) & 0x10001))
BINARY(U32Min, unsigned, a < b ? a : b)
BINARY(SwarMinSimd, unsigned, __vmins2(a, b))
BINARY(SwarMinBias, unsigned, swar_min_bias(a, b))
BINARY(SwarAddV2, unsigned, __vadd2(a & 0x7FFF7FFFu, b & 0x7FFF7FFFu))
BINARY(SwarAddGuard, unsigned, (a & 0x7FFF7FFFu) + (b & 0x7FFF7FFFu))
BINARY(I16WhereMin, short, a < b ? a : b)
BINARY(I16Sub, short, sub32(a, b))
BINARY(I16SynthSub, short, add32(add32(a, b ^ -1), 1))
BINARY(I16AndOrXor, short, (a & b) | (a ^ b))
BINARY(I16ShlShr, short, add32(shl32(a, 2), b >> 3))
BINARY(I16MaskMin, short, add32(b, sub32(a, b) & -static_cast<int>(a < b)))
BINARY(I16Less, short, static_cast<int>(a < b))
#undef BINARY

#define BINARY_OPS(X)                                                       \
  X(I16Min) X(I16Max) X(I16Add) X(I16Mul) X(U16Min) X(I32Mix) X(U32Min)     \
  X(SwarMinSimd) X(SwarMinBias) X(SwarAddV2) X(SwarAddGuard) X(I16WhereMin)  \
  X(I16Sub) X(I16SynthSub) X(I16AndOrXor) X(I16ShlShr) X(I16MaskMin)        \
  X(I16Less)

template <class Op>
__global__ void __launch_bounds__(kThreads)
    binary(const typename Op::T* __restrict__ a,
           const typename Op::T* __restrict__ b,
           typename Op::T* __restrict__ y, int cells) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c < cells) y[c] = Op::f(a[c], b[c]);
}

// -- ew: y = f^n(x) ----------------------------------------------------------

#define UNARY(Name, Type, expr)           \
  struct Name {                           \
    using T = Type;                       \
    __device__ static T f(T v, int z) {   \
      return static_cast<T>(expr);        \
    }                                     \
  };

// z: a runtime zero, in the body's own add (or the constant of its add)
UNARY(EwMul3Min, int, min(v, add32(mul32(v, 3), 1 + z)))  // exp29 ew_i32
UNARY(EwAddXor16, short, add32(add32(v, v), z) ^ 3)
UNARY(EwAddXor32, int, add32(add32(v, v), z) ^ 3)
UNARY(PackRoundtrip, unsigned, __vadd2(v, 1u + z))  // low half + 1, high kept
UNARY(MinPlusOne16, short,
      min(static_cast<int>(v), static_cast<int>(static_cast<short>(
                                   add32(v, 1 + z)))))
// exp2's fma: acc * float32(1.0000001) + float32(1e-9) (no add of z: a
// float chain does not fold)
UNARY(Fma32, float, v * 0x1.000002p+0f + 0x1.12e0bep-30f)
UNARY(Double32, int, add32(add32(v, v), z))
UNARY(Double16, short, add32(add32(v, v), z))
#undef UNARY

#define EW_OPS(X)                                                          \
  X(EwMul3Min) X(EwAddXor16) X(EwAddXor32) X(PackRoundtrip) X(MinPlusOne16) \
  X(Fma32) X(Double32) X(Double16)

// the value as nvcc's front end must take it after each iteration:
// unknown. An empty asm emits no instruction; ptxas, which sees no asm
// there, is held by the runtime zero in each body instead
__device__ __forceinline__ void opaque(int& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void opaque(unsigned& v) {
  asm volatile("" : "+r"(v));
}
__device__ __forceinline__ void opaque(short& v) { asm volatile("" : "+h"(v)); }
__device__ __forceinline__ void opaque(float& v) { asm volatile("" : "+f"(v)); }

template <class Op>
__global__ void __launch_bounds__(kThreads)
    ew(const typename Op::T* __restrict__ x, typename Op::T* __restrict__ y,
       int cells, long long n, int z) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cells) return;
  typename Op::T v = x[c];
  long long it = 0;
#pragma unroll 1
  for (; it + kUnroll <= n; it += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      v = Op::f(v, z);
      opaque(v);
    }
  }
#pragma unroll 1
  for (; it < n; ++it) {
    v = Op::f(v, z);
    opaque(v);
  }
  y[c] = v;
}

// -- fold: shifted slices of an input, combined ------------------------------

struct Taps {
  int n;
  int di[kMaxFold];  // each in [0, in_rows)
  int dj[kMaxFold];  // each in [0, in_cols)
};

#define FOLD(Name, Type, expr)              \
  struct Name {                             \
    using T = Type;                         \
    __device__ static T f(T v, T s) {       \
      return static_cast<T>(expr);          \
    }                                       \
  };

FOLD(FoldAddI16, short, add32(v, s))
FOLD(FoldMinI16, short, s < v ? s : v)  // jnp.where(s < v, s, v)
FOLD(FoldAddI32, int, add32(v, s))
FOLD(RollI32, int, s)  // one tap: the fold is its read
FOLD(RollF32, float, s)
#undef FOLD

#define FOLD_OPS(X) \
  X(FoldAddI16) X(FoldMinI16) X(FoldAddI32) X(RollI32) X(RollF32)

template <class T>
__device__ __forceinline__ T fold_at(const T* x, int i, int j, int di, int dj,
                                     int in_rows, int in_cols) {
  int ii = i + di, jj = j + dj;
  if (ii >= in_rows) ii -= in_rows;
  if (jj >= in_cols) jj -= in_cols;
  return x[static_cast<long long>(ii) * in_cols + jj];
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
    fold(const typename Op::T* __restrict__ x, typename Op::T* __restrict__ y,
         int in_rows, int in_cols, int rows, int cols, Taps t) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= rows * cols) return;
  const int i = c / cols, j = c % cols;
  typename Op::T v = fold_at(x, i, j, t.di[0], t.dj[0], in_rows, in_cols);
#pragma unroll
  for (int q = 1; q < kMaxFold; ++q)
    if (q < t.n)
      v = Op::f(v, fold_at(x, i, j, t.di[q], t.dj[q], in_rows, in_cols));
  y[c] = v;
}

// -- the one-shot forms on Hopper: vec_binary, tile_fold ---------------------
//
// The forms above (binary and fold, the first forms, kept for comparisons
// as forms 4 and 5) move 2 or 4 bytes a thread, one cell each; fold also
// recomputes a wrapped 64-bit index and reads device memory (through L1)
// once a tap.
// These two move 16 bytes a thread and access, and read each input byte
// from device memory once (a tile).

// an empty asm on each cell's result: nvcc's front end cannot merge the
// ops of two 16-bit cells that share a register into one packed op
// (VIMNMX.S16x2, VIADD.16x2), so each op under test stays the scalar op it
// is in the old forms (one cell an instruction); it emits no instruction
__device__ __forceinline__ void own_cell(short& v) { asm volatile("" : "+h"(v)); }
__device__ __forceinline__ void own_cell(unsigned short& v) {
  asm volatile("" : "+h"(v));
}
__device__ __forceinline__ void own_cell(int& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void own_cell(unsigned& v) {
  asm volatile("" : "+r"(v));
}
__device__ __forceinline__ void own_cell(float& v) { asm volatile("" : "+f"(v)); }

// 16 bytes as cells of T
template <class T>
union Vec16 {
  uint4 v;
  T t[16 / sizeof(T)];
};

#ifdef __CUDACC__
// 16 bytes from global `src` to shared `dst` (both 16-byte aligned), cached
// in L2 only: the copy a tile's box is filled by
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
// close this thread's current group of cp.async copies
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group of this thread but its newest landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
#endif

// vec_binary: y = f(a, b), a 16-byte vector of each a thread and step (8
// int16, 4 int32 or 4 packed words), a grid of the SMs' resident CTAs
// striding over the vectors; the cells past the last whole vector (every
// cell where a pointer is not 16-byte aligned: vecs 0) one a thread. Bound
// by its bytes: the 16-byte accesses and the resident grid keep enough
// loads in flight to stream them; Op::f on each cell as in binary.
template <class Op>
__global__ void __launch_bounds__(kThreads)
    vec_binary(const typename Op::T* __restrict__ a,
               const typename Op::T* __restrict__ b,
               typename Op::T* __restrict__ y, int vecs, int cells) {
  using T = typename Op::T;
  constexpr int kV = 16 / sizeof(T);
  const int stride = gridDim.x * kThreads;
  const uint4* const a4 = reinterpret_cast<const uint4*>(a);
  const uint4* const b4 = reinterpret_cast<const uint4*>(b);
  uint4* const y4 = reinterpret_cast<uint4*>(y);
  for (int v = blockIdx.x * kThreads + threadIdx.x; v < vecs; v += stride) {
    Vec16<T> va, vb, vy;
    va.v = a4[v];
    vb.v = b4[v];
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      vy.t[k] = Op::f(va.t[k], vb.t[k]);
      own_cell(vy.t[k]);
    }
    y4[v] = vy.v;
  }
  for (int c = vecs * kV + blockIdx.x * kThreads + threadIdx.x; c < cells;
       c += stride)
    y[c] = Op::f(a[c], b[c]);
}

// tile_fold's taps, resolved at launch (fold_plan). A tile is 8 * per
// rows by 32 runs of kV cells (a warp a row, a thread a run of adjacent
// cells along the minor axis). Its box, the input cells its taps read,
// starts lo_i rows and lo_j - shift columns past the tile (the taps'
// shortest arc, so that a roll's wrapped tap reads a narrow box), each
// index modulo x's extents. A CTA walks tiles blockIdx.x, + gridDim.x,
// ..., the next tile's box filled by cp.async while it computes the
// current one (two boxes). The taps fall into windows, each a mask of
// taps a run reads from shared memory at compile-time offsets (a branch
// on one uniform bit a tap; no index arithmetic, no indirect branch): a
// row window, up to kWin 16-byte vectors of one box row, which a run
// loads once for all its taps (bit o: a tap at cell o); or a column
// window, taps at one vector-aligned column in up to kColumn rows (bit k:
// a tap k rows down, one vector load each). A tap that repeats another
// opens a window of its own.
constexpr int kWin = 6;
constexpr int kColumn = 48;
struct FoldPlan {
  int rows, cols, in_rows, in_cols;
  int lo_i, lo_j, shift;
  int box_rows, box_vecs;  // rows, 16-byte vectors a row
  int per;  // rows a warp computes, 8 apart
  int tiles, tiles_c;  // tiles, and along the minor axis
  int vec_in, vec_out;  // 16-byte copies in, 16-byte stores out
  int windows;
  int w_vec[kMaxFold];  // window w's first vector past a run's own
  int w_vecs[kMaxFold];  // a row window's vectors; 0: a column window
  unsigned long long w_taps[kMaxFold];  // its taps, one bit each
};

// the fold's starting value: a first tap combined with it gives the tap
template <class Op>
__device__ __forceinline__ typename Op::T fold_start() {
  return 0;
}
template <>
__device__ __forceinline__ short fold_start<FoldMinI16>() {
  return 32767;
}

// the kV cells of a run's tap at cell Off of the N vectors w
template <class Op, int Off, int N>
__device__ __forceinline__ void fold_tap(
    typename Op::T (&acc)[16 / sizeof(typename Op::T)],
    const uint4 (&w)[N]) {
  using T = typename Op::T;
  constexpr int kV = 16 / sizeof(T);
  if constexpr (Off + kV <= N * kV) {
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      Vec16<T> u;
      u.v = w[(Off + k) / kV];
      acc[k] = Op::f(acc[k], u.t[(Off + k) % kV]);
      own_cell(acc[k]);
    }
  }
}

// a row window's tap at cell o; a column window's tap o rows down
#define FOLD_ROW(o) \
  if ((taps >> (o)) & 1) fold_tap<Op, o>(acc, w);
#define FOLD_COLUMN(o)                         \
  if ((taps >> (o)) & 1) {                     \
    const uint4 v[1] = {src[(o) * stride]};    \
    fold_tap<Op, 0>(acc, v);                   \
  }
// eight bits, skipped at once where none is set
#define FOLD_BITS8(F, o)                                                  \
  if ((taps >> (o)) & 0xff) {                                             \
    F(o) F(o + 1) F(o + 2) F(o + 3) F(o + 4) F(o + 5) F(o + 6) F(o + 7)   \
  }
#define FOLD_BITS48(F)                                                    \
  FOLD_BITS8(F, 0) FOLD_BITS8(F, 8) FOLD_BITS8(F, 16) FOLD_BITS8(F, 24)   \
      FOLD_BITS8(F, 32) FOLD_BITS8(F, 40)

// i modulo n, for i >= 0: a division only where i wraps
__device__ __forceinline__ int wrapped(int i, int n) {
  return i < n ? i : i % n;
}

// tile `tile`'s box into `box`: its row r from x's row (i0 + lo_i + r),
// its vector k from x's columns (j0 + lo_j - shift + k * kV), each
// wrapped; a warp a row, a lane a vector; 16-byte cp.async copies, or
// cell by cell where x's rows are not 16-byte aligned
template <class T>
__device__ __forceinline__ void fill_box(const T* x, uint4* box,
                                         const FoldPlan& p, int tile) {
  constexpr int kV = 16 / sizeof(T);
  const int ti = tile / p.tiles_c;
  const int row0 = (ti * 8 * p.per + p.lo_i) % p.in_rows;
  const int col0 =
      ((tile - ti * p.tiles_c) * 32 * kV + p.lo_j - p.shift) % p.in_cols;
  for (int r = threadIdx.x >> 5; r < p.box_rows; r += kThreads / 32) {
    const T* const row =
        x + static_cast<size_t>(wrapped(row0 + r, p.in_rows)) * p.in_cols;
    uint4* const line = box + r * p.box_vecs;
    for (int k = threadIdx.x & 31; k < p.box_vecs; k += 32) {
      if (p.vec_in) {
        cp_async16(line + k, row + wrapped(col0 + k * kV, p.in_cols));
      } else {
        T* const cells = reinterpret_cast<T*>(line + k);
        for (int e = 0; e < kV; ++e)
          cells[e] = row[wrapped(col0 + k * kV + e, p.in_cols)];
      }
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
    tile_fold(const typename Op::T* __restrict__ x,
              typename Op::T* __restrict__ y,
              const __grid_constant__ FoldPlan p) {
  using T = typename Op::T;
  constexpr int kV = 16 / sizeof(T);
  static_assert(kWin * 16 / sizeof(T) <= 48 && kColumn == 48,
                "FOLD_BITS48 covers 48 bits");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* const boxes = reinterpret_cast<uint4*>(smem_raw);
  const int box_size = p.box_rows * p.box_vecs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int tile = blockIdx.x;
  if (tile < p.tiles) fill_box(x, boxes, p, tile);
  cp_async_commit();
  for (int parity = 0; tile < p.tiles; tile += gridDim.x, parity ^= 1) {
    if (tile + gridDim.x < p.tiles)
      fill_box(x, boxes + (parity ^ 1) * box_size, p, tile + gridDim.x);
    cp_async_commit();
    cp_async_wait_one();  // all but the next tile's copies landed
    __syncthreads();
    const uint4* const box = boxes + parity * box_size;
    const int ti = tile / p.tiles_c;
    const int i0 = ti * 8 * p.per;
    const int j = (tile - ti * p.tiles_c) * 32 * kV + lane * kV;
    for (int m = 0; m < p.per; ++m) {
      const int r = warp + 8 * m;
      const int i = i0 + r;
      if (i >= p.rows || j >= p.cols) continue;
      const int stride = p.box_vecs;
      const uint4* const run = box + r * stride + lane;
      T acc[kV];
#pragma unroll
      for (int k = 0; k < kV; ++k) acc[k] = fold_start<Op>();
      for (int g = 0; g < p.windows; ++g) {
        const uint4* const src = run + p.w_vec[g];
        const unsigned long long taps = p.w_taps[g];
        if (p.w_vecs[g] == 0) {
          FOLD_BITS48(FOLD_COLUMN)
        } else {
          uint4 w[kWin];
#pragma unroll
          for (int v = 0; v < kWin; ++v)
            if (v < p.w_vecs[g]) w[v] = src[v];
          FOLD_BITS48(FOLD_ROW)
        }
      }
      T* const out = y + static_cast<size_t>(i) * p.cols + j;
      if (p.vec_out && j + kV <= p.cols) {
        Vec16<T> u;
#pragma unroll
        for (int k = 0; k < kV; ++k) u.t[k] = acc[k];
        *reinterpret_cast<uint4*>(out) = u.v;
      } else {
#pragma unroll
        for (int k = 0; k < kV; ++k)
          if (j + k < p.cols) out[k] = acc[k];
      }
    }
    __syncthreads();  // the next fill writes this box
  }
}
#undef FOLD_BITS48
#undef FOLD_BITS8
#undef FOLD_COLUMN
#undef FOLD_ROW

// -- strip: chains of wrap-around shifts -------------------------------------

struct Phase {
  int axis;  // 0: columns wrap (a sublane shift); 1: rows wrap (lanes)
  int steps;
  int indep;  // the steps all read the phase's values (and cross taps)
  int cross;  // an independent phase's taps along the other axis
  int per;  // lines a strip holds
  int log2per;
  int log2len;  // a line's cells
  int strips;
  int dist[kMaxSteps];  // step s reads the cell dist[s] further on
  int cross_dist[kMaxSteps];
};

struct Plan {
  int phases;
  int rows, cols;
  int half;  // cells of one shared-memory buffer
  int cooperative;  // several phases or an independent one: grid barriers
  Phase ph[kMaxPhases];
};

// the strip as a thread sees it in shared memory: cell `pos` of line `l`
// (row-major as the block lies in global memory: lines of a row strip
// one after another, a column strip's rows `per` cells wide)
template <class S>
struct Line {
  const S* buf;
  int axis, l, pos, mask, log2len, log2per;
  __device__ __forceinline__ S at(int off) const {
    const int p = (pos + off) & mask;
    return buf[axis ? (l << log2len) | p : (p << log2per) | l];
  }
};

template <class G_, class S_>
struct StripBody {
  using G = G_;  // the block's type in global memory
  using S = S_;  // its type in registers and shared memory
  __device__ static S load(G g) { return static_cast<S>(g); }
  __device__ static G store(S s) { return static_cast<G>(s); }
  static constexpr bool kMin = false;  // whether step is a min
  // a cross tap's value s (an independent phase of a min body)
  __device__ static S cross(S own, S s) { return s < own ? s : own; }
};

// s < own ? s : own: jnp.where(shifted < acc, shifted, acc), or
// jnp.minimum; i16 held narrow, or stored i16 and computed i32 (exp16)
struct MinI32 : StripBody<int, int> {
  static constexpr bool kMin = true;
  __device__ static int step(int own, const Line<int>& v, int d, int, int) {
    const int s = v.at(d);
    return s < own ? s : own;
  }
};
struct MinI16 : StripBody<short, short> {
  static constexpr bool kMin = true;
  __device__ static short step(short own, const Line<short>& v, int d, int,
                               int) {
    const short s = v.at(d);
    return s < own ? s : own;
  }
};
struct WideMinI16 : StripBody<short, int> {
  static constexpr bool kMin = true;
  __device__ static int step(int own, const Line<int>& v, int d, int, int) {
    return min(own, v.at(d));
  }
};
struct AddI32 : StripBody<int, int> {
  __device__ static int step(int own, const Line<int>& v, int d, int, int) {
    return add32(own, v.at(d));
  }
};
struct AddI16 : StripBody<short, short> {
  __device__ static short step(short own, const Line<short>& v, int d, int,
                               int) {
    return static_cast<short>(add32(own, v.at(d)));
  }
};
struct AddF32 : StripBody<float, float> {
  __device__ static float step(float own, const Line<float>& v, int d, int,
                               int) {
    return own + v.at(d);
  }
};
// exp29 roll_strided: column j rolled by 1 + j, plus 1 (d = -1)
struct RollStrided : StripBody<int, int> {
  __device__ static int step(int, const Line<int>& v, int d, int, int line) {
    return add32(v.at(d - line), 1);
  }
};
// packed pairs, intrinsics: a lane step shifts by d int16 elements (a
// funnel of two words with __byte_perm where d is odd), a sublane step
// by d whole words; then the signed pair min (VIMNMX.S16x2)
struct PairMinSimd : StripBody<unsigned, unsigned> {
  __device__ static unsigned step(unsigned own, const Line<unsigned>& v,
                                  int d, int axis, int) {
    if (axis == 0) return __vmins2(own, v.at(d));
    const unsigned v0 = v.at(d >> 1);
    const unsigned s = (d & 1) ? __byte_perm(v0, v.at((d >> 1) + 1), 0x5432)
                               : v0;
    return __vmins2(own, s);
  }
};
// exp13's lane_swar_pk as the script writes it (a lane step of d = 1)
struct Swar13 : StripBody<int, int> {
  __device__ static int step(int own, const Line<int>& v, int d, int, int) {
    const int elem = ((own >> 16) & 0xFFFF) | shl32(v.at(d), 16);
    return swar_min_top(elem, own);
  }
};
// exp16's swar kernel as the script writes it (elem_shift, swar_min)
struct Swar16 : StripBody<int, int> {
  __device__ static int step(int own, const Line<int>& v, int d, int axis,
                             int) {
    if (axis == 0) return swar_min_top(own, v.at(d));
    const int v0 = v.at(d >> 1);
    const int s = (d & 1)
                      ? ((v0 >> 16) & 0xFFFF) | shl32(v.at((d >> 1) + 1), 16)
                      : v0;
    return swar_min_top(own, s);
  }
};

#define STRIP_OPS(X)                                                      \
  X(MinI32) X(MinI16) X(WideMinI16) X(AddI32) X(AddI16) X(AddF32)          \
  X(RollStrided) X(PairMinSimd) X(Swar13) X(Swar16)

// cell `pos` of line `line` (a row, axis 1; a column, axis 0)
__device__ __forceinline__ long long global_index(int axis, int cols, int line,
                                                  int pos) {
  return axis ? static_cast<long long>(line) * cols + pos
              : static_cast<long long>(pos) * cols + line;
}

// one strip of phase p: its cells from src into registers, n iterations
// of the phase's steps, back to dst. `parity` picks the shared-memory
// buffer of the next exchange and runs on across strips and phases, so
// the buffer an exchange writes is never one another thread may still
// read. kCooperative: the launch is cooperative, p in shared memory
template <class B, bool kCooperative>
__device__ __forceinline__ void run_strip(const typename B::G* src,
                                          typename B::G* dst, int rows,
                                          int cols, int half, const Phase& p,
                                          int strip, long long n,
                                          typename B::S* smem, int& parity) {
  using S = typename B::S;
  const int mask = (1 << p.log2len) - 1;
  const int cpt = (p.per << p.log2len) / kThreads;
  const int line0 = strip * p.per;
  S reg[kMaxPer];
  int l[kMaxPer], pos[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    if (k >= cpt) break;
    const int idx = threadIdx.x + k * kThreads;
    l[k] = p.axis ? idx >> p.log2len : idx & (p.per - 1);
    pos[k] = p.axis ? idx & mask : idx >> p.log2per;
    reg[k] = B::load(src[global_index(p.axis, cols, line0 + l[k], pos[k])]);
  }
  for (long long it = 0; it < n; ++it) {
    // an independent phase (min bodies alone, in a cooperative launch,
    // where p lies in shared memory): one exchange
    if constexpr (B::kMin && kCooperative) {
      if (p.indep) {
        S* buf = smem + (parity ? half : 0);
        parity ^= 1;
#pragma unroll
        for (int k = 0; k < kMaxPer; ++k) {
          if (k >= cpt) break;
          buf[threadIdx.x + k * kThreads] = reg[k];
        }
        __syncthreads();
        // each cell the min of its value and the values the phase's
        // distances away: along the phase's axis from the exchange,
        // along the other from src, which the phase does not write. A
        // tap at a time over every cell (the taps' loops unrolled would
        // hold too many registers; the cells' loads overlap)
#pragma unroll 1
        for (int s = 0; s < p.steps; ++s) {
#pragma unroll
          for (int k = 0; k < kMaxPer; ++k) {
            if (k >= cpt) break;
            const Line<S> v{buf, p.axis, l[k], pos[k], mask, p.log2len,
                            p.log2per};
            reg[k] = B::step(reg[k], v, p.dist[s], p.axis, line0 + l[k]);
          }
        }
        const int lines = p.axis ? rows : cols;
#pragma unroll 1
        for (int s = 0; s < p.cross; ++s) {
#pragma unroll
          for (int k = 0; k < kMaxPer; ++k) {
            if (k >= cpt) break;
            const int other = (line0 + l[k] + p.cross_dist[s]) & (lines - 1);
            reg[k] = B::cross(
                reg[k],
                B::load(src[global_index(p.axis, cols, other, pos[k])]));
          }
        }
        continue;
      }
    }
    // a chained phase: one exchange a step
#pragma unroll
    for (int e = 0; e < kMaxSteps; ++e) {
      if (e >= p.steps) break;
      S* buf = smem + (parity ? half : 0);
      parity ^= 1;
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        if (k >= cpt) break;
        buf[threadIdx.x + k * kThreads] = reg[k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        if (k >= cpt) break;
        const Line<S> v{buf, p.axis, l[k], pos[k], mask, p.log2len,
                        p.log2per};
        reg[k] = B::step(reg[k], v, p.dist[e], p.axis, line0 + l[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    if (k >= cpt) break;
    dst[global_index(p.axis, cols, line0 + l[k], pos[k])] = B::store(reg[k]);
  }
}

// phase q of the plan, read from the kernel's parameters at constant
// offsets (a dynamic index there would copy the plan to local memory)
__device__ __forceinline__ Phase phase_of(const Plan& plan, int q) {
  Phase p = plan.ph[0];
#pragma unroll
  for (int r = 1; r < kMaxPhases; ++r)
    if (q == r) p = plan.ph[r];
  return p;
}

template <class B>
__global__ void __launch_bounds__(kThreads)
    strip(const typename B::G* __restrict__ x, typename B::G* y,
          typename B::G* tmp, Plan plan, long long n) {
  using G = typename B::G;
  using S = typename B::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* const smem = reinterpret_cast<S*>(smem_raw);
  int parity = 0;
  if (!plan.cooperative) {
    for (int s = blockIdx.x; s < plan.ph[0].strips; s += gridDim.x)
      run_strip<B, false>(x, y, plan.rows, plan.cols, plan.half, plan.ph[0],
                          s, n, smem, parity);
    return;
  }
  // a grid barrier a phase: each phase's writes alternate between y and
  // tmp, arranged so that the last lands in y. The phase a CTA runs lies
  // in shared memory after the exchange buffers (its fields read where
  // used, as the parameters' are, not held in registers)
  Phase& current =
      *reinterpret_cast<Phase*>(smem_raw + 2 * plan.half * sizeof(S));
  cg::grid_group grid = cg::this_grid();
  const long long writes = plan.phases * n;
  long long k = 0;
  const G* src = x;
  for (long long it = 0; it < n; ++it) {
    for (int q = 0; q < plan.phases; ++q) {
      if (threadIdx.x == 0) current = phase_of(plan, q);
      __syncthreads();
      G* dst = ((writes - 1 - k) & 1) ? tmp : y;
      for (int s = blockIdx.x; s < current.strips; s += gridDim.x)
        run_strip<B, true>(src, dst, plan.rows, plan.cols, plan.half,
                           current, s, 1, smem, parity);
      src = dst;
      if (++k < writes) grid.sync();  // (also before `current` changes)
    }
  }
}

// -- strip_cluster: an independent phase in one thread-block cluster -------
//
// The strip kernel runs a body of independent phases (exp24's indep10:
// each cell the min of itself and the cells 1, 2, 4, 8, 3 on along its row
// and along its column, all of the phase's values) one phase at a time
// over its strips, the block through global memory (the L2) and a grid
// barrier a phase: the cross taps read other strips' cells. On the TPU
// the block stayed in one core's VMEM for all n iterations. Its Hopper
// counterpart is one thread-block cluster: C CTAs on neighbouring SMs
// that read each other's shared memory (distributed shared memory), a
// cluster barrier (barrier.cluster) in place of the grid's. The block,
// rows of W 32-bit words (exp24's (256, 1024) int32 block), lies in the
// cluster's registers in bands: CTA c holds rows R c ... R c + R - 1
// (C = rows / R: 16 CTAs of 16 rows), its thread j word column j of them.
// The layout never changes:
//
//   The taps along the row stay in the CTA: a word's neighbour d words on
//     comes by a warp shuffle, and past a warp's edge from the next warp's
//     first lanes through shared memory (one CTA barrier a phase; the row
//     wraps inside the CTA).
//   The cross taps (rows further on, at most kMaxDist) need that many rows
//     after the band, its margin, read from the next band's CTA before the
//     phase: each CTA publishes its first rows in one of two buffers of its
//     shared memory, a cluster barrier, then reads its margin (mapa,
//     ld.shared::cluster; a warp's reads whole 128-byte lines).
//
// The buffers alternate, so one barrier an exchange does: a buffer is
// written again two exchanges on, after every CTA arrived at the barrier
// between, past its reads of it; a last barrier before exit lets no CTA
// free rows another still reads. Global memory is read once and written
// once a launch. Chained phases stay on the strip kernel: on an H100 the
// same cluster scheme ran roll10's two phases 1.3x and exp16's 1.5-2.9x
// the strip kernel's time (16 SMs against 128 for the same operations).
//
// Bound: the body's operations, as the strip kernel's, on C of the card's
// SMs: the cluster's own bound is the card's times its SMs / C.

constexpr int kMaxDist = 8;  // a tap's distance, along the row or across
constexpr int kEdgeLanes = 8;  // the lanes a warp posts for the warp before

#ifdef __CUDACC__
// an address in another CTA's shared memory (the shared::cluster window)
using RemoteAddr = unsigned;
// this CTA's rank in its cluster
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// a barrier across the cluster's threads, in halves: the arrival
// releases this thread's shared-memory accesses, the wait returns once
// every thread arrived, acquiring theirs
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// word p of this CTA's shared memory, in CTA `rank`'s
__device__ __forceinline__ RemoteAddr remote(const unsigned* p,
                                             unsigned rank) {
  RemoteAddr a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(a)
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(rank));
  return a;
}
// the word `word` words past a
__device__ __forceinline__ unsigned ld_remote(RemoteAddr a, int word) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(a + 4 * word)
               : "memory");
  return v;
}
#endif

// the plan as the kernel takes it, per phase (each independent, along the
// lanes): its taps' and cross taps' distances (a bit each) and the margin
// rows it reads first (its furthest cross tap; 0: none)
struct ClusterPlan {
  int phases, ctas;
  int reach[kMaxPhases];
  unsigned mask[kMaxPhases];
  unsigned cross_mask[kMaxPhases];
};

// field q of the plan, read from the parameters at constant offsets (a
// dynamic index would copy them to local memory; q is uniform, so the
// value is, and the shuffles behind a test of it need no convergence
// check)
template <class T>
__device__ __forceinline__ T pick(const T (&a)[kMaxPhases], int q) {
  T v = a[0];
#pragma unroll
  for (int r = 1; r < kMaxPhases; ++r)
    if (q == r) v = a[r];
  return v;
}

// a band of R rows of W words a CTA: the rows a thread holds (its R and
// the margin after them), and its edge runs (kEdgeLanes runs of R words
// a warp, 4 words of gap apart: 16-byte accesses of 8 lanes on distinct
// banks)
template <int R, int W>
struct Band {
  static constexpr int kHeld = R + kMaxDist, kWarps = W / 32;
  static constexpr int kEdge = R + 4;
  static constexpr int kEdgeBuf = kWarps * kEdgeLanes * kEdge;
  static constexpr int kSmemWords = 2 * kMaxDist * W + 2 * kEdgeBuf;
};

// the thread's lanes and warps, and its edge buffers' parity
struct Lanes {
  int lane, warp, next_warp, parity;
};

// the first kEdgeLanes lanes of each warp post their R words into buffer
// `parity` for the warp before (the edge buffers alternate, so one CTA
// barrier a phase does), the barrier; the buffer
template <int R, int W>
__device__ __forceinline__ const unsigned* post_edge(
    const unsigned (&v)[Band<R, W>::kHeld], unsigned* edge, Lanes& t) {
  using Bd = Band<R, W>;
  unsigned* const buf = edge + t.parity * Bd::kEdgeBuf;
  t.parity ^= 1;
  if (t.lane < kEdgeLanes) {
    uint4* const out = reinterpret_cast<uint4*>(
        buf + (t.warp * kEdgeLanes + t.lane) * Bd::kEdge);
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      out[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  __syncthreads();
  return buf;
}

// rows 4 q ... 4 q + 3 of the word Off words on along the row: by
// shuffles in the warp, past its edge from the next warp's runs in buf
// (predicated loads: the shuffles stay in converged code)
template <int R, int W, int Off>
__device__ __forceinline__ uint4 ahead4(const unsigned (&v)[Band<R, W>::kHeld],
                                        const unsigned* buf, const Lanes& t,
                                        int q) {
  const bool past = t.lane + Off >= 32;
  uint4 e = make_uint4(0, 0, 0, 0);
  if (past)
    e = *reinterpret_cast<const uint4*>(
        buf + (t.next_warp * kEdgeLanes + t.lane + Off - 32) *
                  Band<R, W>::kEdge +
        4 * q);
  const int src = (t.lane + Off) & 31;
  const unsigned a = __shfl_sync(0xffffffffu, v[4 * q], src);
  const unsigned b = __shfl_sync(0xffffffffu, v[4 * q + 1], src);
  const unsigned c = __shfl_sync(0xffffffffu, v[4 * q + 2], src);
  const unsigned d = __shfl_sync(0xffffffffu, v[4 * q + 3], src);
  return past ? e : make_uint4(a, b, c, d);
}

// MinI32's step on four words
__device__ __forceinline__ unsigned min_word(unsigned own, unsigned s) {
  return static_cast<int>(s) < static_cast<int>(own) ? s : own;
}
__device__ __forceinline__ void min4(unsigned& a, unsigned& b, unsigned& c,
                                     unsigned& d, const uint4& s) {
  a = min_word(a, s.x);
  b = min_word(b, s.y);
  c = min_word(c, s.z);
  d = min_word(d, s.w);
}

// an independent phase along the lanes: each word the min of itself, the
// words the distances in `mask` on along its row and the rows the
// distances in `cross` on (the margin read first), all of the phase's
// values: ascending, in place (a row is written once the rows it reads
// are read)
template <int R, int W>
__device__ __forceinline__ void indep_taps(unsigned (&v)[Band<R, W>::kHeld],
                                           unsigned mask, unsigned cross,
                                           unsigned* edge, Lanes& t) {
  const unsigned* const buf = post_edge<R, W>(v, edge, t);
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    unsigned a = v[4 * q], b = v[4 * q + 1], c = v[4 * q + 2],
             d = v[4 * q + 3];
#define LANE_TAP(D) \
  if ((mask >> D) & 1u) min4(a, b, c, d, ahead4<R, W, D>(v, buf, t, q));
#define CROSS_TAP(D)                                                   \
  if ((cross >> D) & 1u)                                               \
    min4(a, b, c, d,                                                   \
         make_uint4(v[4 * q + D], v[4 * q + 1 + D], v[4 * q + 2 + D],  \
                    v[4 * q + 3 + D]));
#define CLUSTER_DISTS(D) D(1) D(2) D(3) D(4) D(5) D(6) D(7) D(8)
    CLUSTER_DISTS(LANE_TAP)
    CLUSTER_DISTS(CROSS_TAP)
#undef CLUSTER_DISTS
#undef CROSS_TAP
#undef LANE_TAP
    v[4 * q] = a;
    v[4 * q + 1] = b;
    v[4 * q + 2] = c;
    v[4 * q + 3] = d;
  }
}

// the margin: the first `reach` rows after the band, from the next band's
// CTA, through buffer `ex` of the two (its last readers arrived at the
// barrier before)
template <int R, int W>
__device__ __forceinline__ void exchange(unsigned (&v)[Band<R, W>::kHeld],
                                         unsigned* pub, int reach, int& ex,
                                         int j, unsigned next) {
  unsigned* const mine = pub + (ex & 1) * kMaxDist * W;
  ++ex;
#pragma unroll
  for (int r = 0; r < kMaxDist; ++r)
    if (r < reach) mine[r * W + j] = v[r];
  cluster_arrive();
  cluster_wait();
  const RemoteAddr a = remote(mine, next);
#pragma unroll
  for (int m = 0; m < kMaxDist; ++m)
    if (m < reach) v[R + m] = ld_remote(a, m * W + j);
}

template <int R, int W>
__global__ void __launch_bounds__(W, 1)
    strip_cluster(const unsigned* __restrict__ x, unsigned* __restrict__ y,
                  const __grid_constant__ ClusterPlan plan, long long n) {
  using Bd = Band<R, W>;
  static_assert(R >= kMaxDist && R % 4 == 0 && W % 32 == 0 &&
                    kEdgeLanes >= kMaxDist,
                "a band's margin lies in the next band");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* const pub = reinterpret_cast<unsigned*>(smem_raw);
  unsigned* const edge = pub + 2 * kMaxDist * W;
  const int j = threadIdx.x;
  Lanes t;
  t.lane = j & 31;
  t.warp = j >> 5;
  t.next_warp = t.warp + 1 == Bd::kWarps ? 0 : t.warp + 1;
  t.parity = 0;
  const unsigned rank = cluster_rank();
  const unsigned next =
      rank + 1 == static_cast<unsigned>(plan.ctas) ? 0 : rank + 1;
  // the band's R rows (one base a thread, constant offsets), no margin
  // yet: an exchange fills it before a phase reads it
  unsigned v[Bd::kHeld];
  {
    const unsigned* const in = x + static_cast<long long>(rank) * R * W + j;
#pragma unroll
    for (int r = 0; r < Bd::kHeld; ++r) v[r] = r < R ? in[r * W] : 0u;
  }
  int ex = 0;  // exchanges so far
  for (long long it = 0; it < n; ++it) {
    for (int q = 0; q < plan.phases; ++q) {
      const int reach = pick(plan.reach, q);
      if (reach) exchange<R, W>(v, pub, reach, ex, j, next);
      indep_taps<R, W>(v, pick(plan.mask, q), pick(plan.cross_mask, q), edge,
                       t);
    }
  }
  unsigned* const out = y + static_cast<long long>(rank) * R * W + j;
#pragma unroll
  for (int r = 0; r < R; ++r) out[r * W] = v[r];
  // the exit barrier: no CTA leaves while another may read its rows
  if (ex) {
    cluster_arrive();
    cluster_wait();
  }
}

// -- launching ---------------------------------------------------------------

using BinaryLaunch = cudaError_t (*)(const void*, const void*, void*, int,
                                     cudaStream_t, int*);
using EwLaunch = cudaError_t (*)(const void*, void*, int, long long,
                                 cudaStream_t, int*);
using FoldLaunch = cudaError_t (*)(const void*, void*, int, int, int, int,
                                   const Taps&, cudaStream_t, int*);
using StripLaunch = cudaError_t (*)(const void*, void*, void*, const Plan&,
                                    long long, cudaStream_t, int*);

int blocks_for(int cells) { return (cells + kThreads - 1) / kThreads; }

template <class Op>
cudaError_t launch_binary(const void* a, const void* b, void* y, int cells,
                          cudaStream_t stream, int* ctas) {
  using T = typename Op::T;
  *ctas = blocks_for(cells);
  binary<Op><<<*ctas, kThreads, 0, stream>>>(static_cast<const T*>(a),
                                              static_cast<const T*>(b),
                                              static_cast<T*>(y), cells);
  return cudaGetLastError();
}

template <class Op>
cudaError_t launch_ew(const void* x, void* y, int cells, long long n,
                      cudaStream_t stream, int* ctas) {
  using T = typename Op::T;
  *ctas = blocks_for(cells);
  ew<Op><<<*ctas, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                          static_cast<T*>(y), cells, n, 0);
  return cudaGetLastError();
}

template <class Op>
cudaError_t launch_fold(const void* x, void* y, int in_rows, int in_cols,
                        int rows, int cols, const Taps& taps,
                        cudaStream_t stream, int* ctas) {
  using T = typename Op::T;
  *ctas = blocks_for(rows * cols);
  fold<Op><<<*ctas, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                            static_cast<T*>(y), in_rows,
                                            in_cols, rows, cols, taps);
  return cudaGetLastError();
}

// the SMs of the current device, and the CTAs of `kernel` (with `smem`
// bytes of dynamic shared memory) each holds at once
cudaError_t residency(const void* kernel, int smem, int* sms, int* per_sm) {
  int device = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, smem);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// vec_binary's geometry: out[0] CTAs an SM, [1] dynamic shared memory, [2]
// the grid (the resident CTAs, or fewer where the vectors are fewer), [3]
// the whole vectors (0 where a pointer is misaligned)
template <class Op>
cudaError_t binary_geometry(int cells, bool aligned, int* out) {
  constexpr int kV = 16 / sizeof(typename Op::T);
  int sms = 0;
  const cudaError_t err = residency(
      reinterpret_cast<const void*>(vec_binary<Op>), 0, &sms, &out[0]);
  if (err != cudaSuccess) return err;
  const int vecs = aligned ? cells / kV : 0;
  const int rest = cells - vecs * kV;
  const int want = ((vecs > rest ? vecs : rest) + kThreads - 1) / kThreads;
  const int resident = sms * out[0];
  out[1] = 0;
  out[2] = want < 1 ? 1 : want < resident ? want : resident;
  out[3] = vecs;
  return cudaSuccess;
}

template <class Op>
cudaError_t launch_vec_binary(const void* a, const void* b, void* y,
                              int cells, cudaStream_t stream, int* ctas) {
  using T = typename Op::T;
  int g[4];
  const cudaError_t err = binary_geometry<Op>(
      cells, aligned16(a) && aligned16(b) && aligned16(y), g);
  if (err != cudaSuccess) return err;
  *ctas = g[2];
  vec_binary<Op><<<g[2], kThreads, 0, stream>>>(static_cast<const T*>(a),
                                                 static_cast<const T*>(b),
                                                 static_cast<T*>(y), g[3],
                                                 cells);
  return cudaGetLastError();
}

// the shortest arc of [0, extent), wrapping, that holds the n offsets d:
// its first offset, its length less one, and each offset's place past it
void shortest_arc(const int* d, int n, int extent, int* lo, int* span,
                  int* rel) {
  int s[kMaxFold];
  for (int q = 0; q < n; ++q) {
    int k = q;
    for (; k > 0 && s[k - 1] > d[q]; --k) s[k] = s[k - 1];
    s[k] = d[q];
  }
  int gap = -1;
  for (int k = 0; k < n; ++k) {
    const int next = k + 1 < n ? s[k + 1] : s[0] + extent;
    if (next - s[k] > gap) {
      gap = next - s[k];
      *lo = k + 1 < n ? s[k + 1] : s[0];
    }
  }
  *span = extent - gap;
  for (int q = 0; q < n; ++q) rel[q] = (d[q] - *lo + extent) % extent;
}

constexpr long long kMaxSmem = 232448;  // a CTA's shared memory (227 KB)

// tile_fold's plan (FoldPlan) for the taps t, on a card of `sms` SMs: 4
// rows a warp (32-row tiles), or fewer where that leaves under two tiles an
// SM or two boxes past shared memory; out[1] the two boxes' bytes, out[2]
// the tiles. Two boxes past shared memory even at 8 rows a tile are
// refused.
template <class T>
cudaError_t fold_plan(int in_rows, int in_cols, int rows, int cols,
                      const Taps& t, bool x_aligned, bool y_aligned, int sms,
                      FoldPlan* p, int* out) {
  constexpr int kV = 16 / sizeof(T);
  int ri[kMaxFold], rj[kMaxFold], span_i = 0, span_j = 0;
  shortest_arc(t.di, t.n, in_rows, &p->lo_i, &span_i, ri);
  shortest_arc(t.dj, t.n, in_cols, &p->lo_j, &span_j, rj);
  p->rows = rows;
  p->cols = cols;
  p->in_rows = in_rows;
  p->in_cols = in_cols;
  p->shift = p->lo_j % kV;
  p->box_vecs = (p->shift + 32 * kV + span_j + kV - 1) / kV;
  p->tiles_c = (cols + 32 * kV - 1) / (32 * kV);
  p->vec_in = in_cols % kV == 0 && x_aligned;
  p->vec_out = cols % kV == 0 && y_aligned;
  p->windows = 0;
  for (int k = 0; k < kMaxFold; ++k) {
    p->w_vec[k] = p->w_vecs[k] = 0;
    p->w_taps[k] = 0;
  }
  // the taps by column, then row: a vector-aligned column with taps in
  // two rows or more makes column windows, the rest row windows
  int order[kMaxFold], e[kMaxFold];
  bool column[kMaxFold];
  for (int q = 0; q < t.n; ++q) {
    e[q] = p->shift + rj[q];
    int k = q;
    for (; k > 0 && (e[order[k - 1]] > e[q] ||
                     (e[order[k - 1]] == e[q] && ri[order[k - 1]] > ri[q]));
         --k)
      order[k] = order[k - 1];
    order[k] = q;
  }
  for (int k = 0; k < t.n; ++k) {
    const int q = order[k];
    const bool same_prev = k > 0 && e[order[k - 1]] == e[q];
    const bool same_next = k + 1 < t.n && e[order[k + 1]] == e[q];
    column[q] = e[q] % kV == 0 && (same_prev || same_next);
  }
  int first = 0;  // the current window's first row or vector
  for (int k = 0; k < t.n; ++k) {
    const int q = order[k];
    if (!column[q]) continue;
    const int w = p->windows - 1;
    if (w < 0 || p->w_vecs[w] != 0 || e[order[k - 1]] != e[q] ||
        ri[q] - first >= kColumn || ((p->w_taps[w] >> (ri[q] - first)) & 1)) {
      first = ri[q];
      p->w_vec[p->windows++] = first * p->box_vecs + e[q] / kV;
    }
    p->w_taps[p->windows - 1] |= 1ULL << (ri[q] - first);
  }
  // the row windows: the taps by row, then column
  for (int q = 0; q < t.n; ++q) {
    int k = q;
    for (; k > 0 && (ri[order[k - 1]] > ri[q] ||
                     (ri[order[k - 1]] == ri[q] && e[order[k - 1]] > e[q]));
         --k)
      order[k] = order[k - 1];
    order[k] = q;
  }
  int last = -1;  // the previous row-window tap
  for (int k = 0; k < t.n; ++k) {
    const int q = order[k];
    if (column[q]) continue;
    const int w = p->windows - 1;
    if (last < 0 || ri[q] != ri[last] || e[q] - first * kV > (kWin - 1) * kV ||
        ((p->w_taps[w] >> (e[q] - first * kV)) & 1)) {
      first = e[q] / kV;
      p->w_vec[p->windows++] = ri[q] * p->box_vecs + first;
    }
    const int g = p->windows - 1, off = e[q] - first * kV;
    const int vecs = (off + kV - 1) / kV + 1;
    p->w_taps[g] |= 1ULL << off;
    if (vecs > p->w_vecs[g]) p->w_vecs[g] = vecs;
    last = q;
  }
  long long bytes = 0, tiles = 0;
  for (p->per = 4;; p->per /= 2) {
    bytes = 2 * (8LL * p->per + span_i) * p->box_vecs * 16;
    tiles = (rows + 8LL * p->per - 1) / (8 * p->per) * p->tiles_c;
    if (p->per == 1 || (tiles >= 2LL * sms && bytes <= kMaxSmem)) break;
  }
  p->box_rows = 8 * p->per + span_i;
  if (bytes > kMaxSmem || tiles > (1LL << 31) - 1) return cudaErrorInvalidValue;
  p->tiles = static_cast<int>(tiles);
  out[1] = static_cast<int>(bytes);
  out[2] = p->tiles;
  return cudaSuccess;
}

// tile_fold's geometry: out[0] CTAs an SM, [1] the boxes' bytes, [2] the
// grid (the resident CTAs, or fewer where the tiles are fewer), [3] rows
// a tile
template <class Op>
cudaError_t fold_geometry(int in_rows, int in_cols, int rows, int cols,
                          const Taps& t, bool x_aligned, bool y_aligned,
                          FoldPlan* p, int* out) {
  const void* kernel = reinterpret_cast<const void*>(tile_fold<Op>);
  int sms = 0, ignored = 0;
  cudaError_t err = residency(kernel, 0, &sms, &ignored);
  if (err != cudaSuccess ||
      (err = fold_plan<typename Op::T>(in_rows, in_cols, rows, cols, t,
                                       x_aligned, y_aligned, sms, p, out)) !=
          cudaSuccess)
    return err;
  if (out[1] > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out[1])) !=
          cudaSuccess)
    return err;
  out[3] = 8 * p->per;
  if ((err = residency(kernel, out[1], &sms, &out[0])) != cudaSuccess)
    return err;
  if (out[0] < 1) return cudaErrorInvalidValue;
  if (out[2] > sms * out[0]) out[2] = sms * out[0];
  return cudaSuccess;
}

template <class Op>
cudaError_t launch_tile_fold(const void* x, void* y, int in_rows, int in_cols,
                             int rows, int cols, const Taps& taps,
                             cudaStream_t stream, int* ctas) {
  using T = typename Op::T;
  FoldPlan p;
  int g[4];
  const cudaError_t err =
      fold_geometry<Op>(in_rows, in_cols, rows, cols, taps, aligned16(x),
                        aligned16(y), &p, g);
  if (err != cudaSuccess) return err;
  *ctas = g[2];
  tile_fold<Op><<<g[2], kThreads, g[1], stream>>>(static_cast<const T*>(x),
                                                  static_cast<T*>(y), p);
  return cudaGetLastError();
}

template <class B>
cudaError_t launch_strip(const void* x, void* y, void* tmp, const Plan& plan,
                         long long n, cudaStream_t stream, int* ctas) {
  using G = typename B::G;
  for (int q = 0; q < plan.phases; ++q)
    if (plan.ph[q].cross && !B::kMin) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(strip<B>);
  // the two exchange buffers, then the current phase (cooperative)
  const int smem = 2 * plan.half * static_cast<int>(sizeof(typename B::S)) +
                   static_cast<int>(sizeof(Phase));
  int most_strips = 0;
  for (int q = 0; q < plan.phases; ++q)
    if (plan.ph[q].strips > most_strips) most_strips = plan.ph[q].strips;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return err;
  const G* xg = static_cast<const G*>(x);
  G* yg = static_cast<G*>(y);
  G* tg = static_cast<G*>(tmp);
  if (!plan.cooperative) {
    *ctas = most_strips;
    strip<B><<<most_strips, kThreads, smem, stream>>>(xg, yg, tg, plan, n);
    return cudaGetLastError();
  }
  // every CTA co-resident (a grid barrier), at most one a strip
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  // as few CTAs as walk the strips in as few rounds as the co-resident
  // ones can, each CTA the same number of strips
  const int resident = sms * per_sm;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int rounds = (most_strips + resident - 1) / resident;
  const int blocks = (most_strips + rounds - 1) / rounds;
  *ctas = blocks;
  Plan p = plan;
  void* args[] = {&xg, &yg, &tg, &p, &n};
  return cudaLaunchCooperativeKernel(kernel, blocks, kThreads, args, smem,
                                     stream);
}

// strip_cluster's plan from the strip plan `plan` on bands of `r` rows:
// rows / r CTAs (1-16); every phase independent and along the lanes, each
// tap and cross tap 1 to kMaxDist cells on. false if the kernel does not
// take it (the strip kernel does).
bool cluster_plan(const Plan& plan, int r, ClusterPlan* cp) {
  if (plan.rows % r || plan.rows / r > 16) return false;
  cp->phases = plan.phases;
  cp->ctas = plan.rows / r;
  for (int q = 0; q < kMaxPhases; ++q) {
    const Phase& p = plan.ph[q];
    if (!p.indep || p.axis != 1) return false;
    cp->reach[q] = 0;
    cp->mask[q] = cp->cross_mask[q] = 0;
    for (int s = 0; s < p.steps + p.cross; ++s) {
      const int d = s < p.steps ? p.dist[s] : p.cross_dist[s - p.steps];
      if (d < 1 || d > kMaxDist) return false;
      if (s < p.steps) {
        cp->mask[q] |= 1u << d;
      } else {
        cp->cross_mask[q] |= 1u << d;
        if (d > cp->reach[q]) cp->reach[q] = d;
      }
    }
  }
  return true;
}

// one launch of strip_cluster<R, W>: a cluster of cp.ctas CTAs (past 8, a
// non-portable size), refused unless the card can hold one such cluster
// at once (cudaOccupancyMaxActiveClusters)
template <int R, int W>
cudaError_t launch_band(const void* x, void* y, const ClusterPlan& cp,
                        long long n, cudaStream_t stream, int* ctas) {
  const void* kernel = reinterpret_cast<const void*>(strip_cluster<R, W>);
  // the published rows' two buffers and the two edge buffers
  const int smem =
      static_cast<int>(sizeof(unsigned)) * Band<R, W>::kSmemWords;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (cp.ctas > 8 &&
       (err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
           cudaSuccess))
    return err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cp.ctas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cp.ctas);
  config.blockDim = dim3(W);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, strip_cluster<R, W>,
                                            &config)) != cudaSuccess)
    return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  *ctas = cp.ctas;
  return cudaLaunchKernelEx(&config, strip_cluster<R, W>,
                            static_cast<const unsigned*>(x),
                            static_cast<unsigned*>(y), cp, n);
}

// the (band rows R, words a row W) strip_cluster is built for: exp24's
// block at 16 CTAs of 16 rows
#ifndef SODA_CLUSTER_FORMS
#define SODA_CLUSTER_FORMS(X) X(16, 1024)
#endif

// MinI32's strip body on strip_cluster; refused (cudaErrorInvalidValue)
// for a block or plan it does not take
cudaError_t launch_strip_cluster(const void* x, void* y, void*,
                                 const Plan& plan, long long n,
                                 cudaStream_t stream, int* ctas) {
  ClusterPlan cp;
#define FORM_CASE(R, W)                                                  \
  if (plan.cols == (W) && plan.rows % (R) == 0 && plan.rows / (R) <= 16) \
    return cluster_plan(plan, R, &cp)                                    \
               ? launch_band<R, W>(x, y, cp, n, stream, ctas)            \
               : cudaErrorInvalidValue;
  SODA_CLUSTER_FORMS(FORM_CASE)
#undef FORM_CASE
  return cudaErrorInvalidValue;
}

// strip_cluster's launcher of a strip op, or none where it is not built
template <class B>
constexpr StripLaunch cluster_entry() {
  if constexpr (std::is_same<B, MinI32>::value)
    return &launch_strip_cluster;
  else
    return nullptr;
}

#define BINARY_ENTRY(op) &launch_binary<op>,
#define EW_ENTRY(op) &launch_ew<op>,
#define FOLD_ENTRY(op) &launch_fold<op>,
#define STRIP_ENTRY(op) &launch_strip<op>,
#define NAME(op) #op ","

const BinaryLaunch kBinary[] = {BINARY_OPS(BINARY_ENTRY)};
const EwLaunch kEw[] = {EW_OPS(EW_ENTRY)};
const FoldLaunch kFold[] = {FOLD_OPS(FOLD_ENTRY)};
const StripLaunch kStrip[] = {STRIP_OPS(STRIP_ENTRY)};
#define STRIP_CLUSTER_ENTRY(op) cluster_entry<op>(),
const StripLaunch kStripCluster[] = {STRIP_OPS(STRIP_CLUSTER_ENTRY)};

#define VEC_BINARY_ENTRY(op) &launch_vec_binary<op>,
#define TILE_FOLD_ENTRY(op) &launch_tile_fold<op>,
#define BINARY_GEOMETRY_ENTRY(op) &binary_geometry<op>,
#define FOLD_GEOMETRY_ENTRY(op) &fold_geometry<op>,
using BinaryGeometry = cudaError_t (*)(int, bool, int*);
using FoldGeometry = cudaError_t (*)(int, int, int, int, const Taps&, bool,
                                     bool, FoldPlan*, int*);
const BinaryLaunch kVecBinary[] = {BINARY_OPS(VEC_BINARY_ENTRY)};
const FoldLaunch kTileFold[] = {FOLD_OPS(TILE_FOLD_ENTRY)};
const BinaryGeometry kBinaryGeometry[] = {BINARY_OPS(BINARY_GEOMETRY_ENTRY)};
const FoldGeometry kFoldGeometry[] = {FOLD_OPS(FOLD_GEOMETRY_ENTRY)};

template <class T, int N>
constexpr int count(T (&)[N]) {
  return N;
}

int log2_exact(int v) {  // -1 unless v is a power of two
  if (v < 1 || (v & (v - 1))) return -1;
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

// a phase from its arguments at `args` (axis, indep, steps, that many
// distances, cross taps, that many distances; `avail` of them there),
// its strips as many lines a strip as keep at least kMinStrips strips,
// up to kStripCells cells, at least a cell a thread; the count of
// arguments it took, 0 if they are not a phase the kernel runs
int plan_phase(const int* args, int avail, int rows, int cols, Phase* p) {
  if (avail < 4 || args[2] < 1 || args[2] > kMaxSteps || avail < 4 + args[2])
    return 0;
  const int axis = args[0], indep = args[1], steps = args[2];
  const int* dists = args + 3;
  const int cross = args[3 + steps];
  const int* cross_dists = args + 4 + steps;
  if ((axis != 0 && axis != 1) || (indep != 0 && indep != 1) || cross < 0 ||
      cross > kMaxSteps || (cross && !indep) || avail < 4 + steps + cross)
    return 0;
  const int len = axis ? cols : rows, lines = axis ? rows : cols;
  if (log2_exact(len) < 0 || log2_exact(lines) < 0) return 0;
  int per = 1;
  while (2 * per * len <= kStripCells && lines / (2 * per) >= kMinStrips)
    per *= 2;
  while (per * len < kThreads) per *= 2;
  if (per > lines || per * len > kStripCells) return 0;
  p->axis = axis;
  p->indep = indep;
  p->steps = steps;
  p->cross = cross;
  p->per = per;
  p->log2per = log2_exact(per);
  p->log2len = log2_exact(len);
  p->strips = lines / per;
  for (int s = 0; s < kMaxSteps; ++s) {
    p->dist[s] = s < steps ? dists[s] : 0;
    p->cross_dist[s] = s < cross ? cross_dists[s] : 0;
  }
  return 4 + steps + cross;
}

// a fold's taps from its arguments (n_args / 2 of (di, dj), each
// wrapped into [0, in_rows) and [0, in_cols)); false if they are not taps
// the kernels take
bool taps_of(const int* args, int n_args, int in_rows, int in_cols, Taps* t) {
  if (n_args < 2 || n_args > 2 * kMaxFold || n_args % 2 || in_rows < 1 ||
      in_cols < 1)
    return false;
  t->n = n_args / 2;
  for (int q = 0; q < kMaxFold; ++q) {
    const int di = q < t->n ? args[2 * q] : 0;
    const int dj = q < t->n ? args[2 * q + 1] : 0;
    t->di[q] = ((di % in_rows) + in_rows) % in_rows;
    t->dj[q] = ((dj % in_cols) + in_cols) % in_cols;
  }
  return true;
}

}  // namespace

extern "C" {

// each form's op names, in `op` order: "binary;ew;fold;strip", each a
// list of names with a comma after each
const char* probe_narrow_ops() {
  return BINARY_OPS(NAME) ";" EW_OPS(NAME) ";" FOLD_OPS(NAME) ";" STRIP_OPS(
      NAME);
}

// Form 0, binary: y = op(a, b) over rows x cols cells (vec_binary). 1,
// ew: y = op^n(a). 2, fold: y (rows x cols) from a (in_rows x in_cols;
// tile_fold); args: n_args / 2 taps (di, dj), each index wrapping. 3,
// strip: op's chain on the rows x cols block a, n iterations; args: 1 to
// kMaxPhases phases, each (axis, independent, steps, that many distances,
// cross taps, that many distances); tmp: a second block (a cooperative
// plan). 4 and 5: the old forms of 0 and 2 (binary, fold), for
// comparisons. 6: form 3's body on strip_cluster (one cluster of CTAs;
// MinI32's independent phases along the lanes, refused otherwise).
// ctas receives the grid size.
int probe_narrow_launch(int form, int op, const int* args, int n_args,
                        int rows, int cols, int in_rows, int in_cols,
                        const void* a, const void* b, void* y, void* tmp,
                        long long n, void* stream, int* ctas) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t bad = cudaErrorInvalidValue;
  if (n < 1 || rows < 1 || cols < 1 || op < 0 || ctas == nullptr)
    return static_cast<int>(bad);
  const long long cells = static_cast<long long>(rows) * cols;
  if (cells > (1 << 30)) return static_cast<int>(bad);
  if ((form == 0 || form == 4) && op < count(kBinary))
    return static_cast<int>((form == 0 ? kVecBinary : kBinary)[op](
        a, b, y, static_cast<int>(cells), s, ctas));
  if (form == 1 && op < count(kEw))
    return static_cast<int>(kEw[op](a, y, static_cast<int>(cells), n, s,
                                    ctas));
  if ((form == 2 || form == 5) && op < count(kFold)) {
    Taps t;
    if (!taps_of(args, n_args, in_rows, in_cols, &t) ||
        static_cast<long long>(in_rows) * in_cols > (1 << 30))
      return static_cast<int>(bad);
    return static_cast<int>((form == 2 ? kTileFold : kFold)[op](
        a, y, in_rows, in_cols, rows, cols, t, s, ctas));
  }
  if ((form == 3 || form == 6) && op < count(kStrip)) {
    Plan plan;
    plan.rows = rows;
    plan.cols = cols;
    plan.phases = 0;
    plan.half = 0;
    plan.cooperative = 0;
    int q = 0;
    while (q < n_args) {
      Phase& ph = plan.ph[plan.phases];
      const int took = plan.phases < kMaxPhases
                           ? plan_phase(args + q, n_args - q, rows, cols, &ph)
                           : 0;
      if (took == 0) return static_cast<int>(bad);
      if ((ph.per << ph.log2len) > plan.half) plan.half = ph.per << ph.log2len;
      plan.cooperative |= ph.indep;
      q += took;
      ++plan.phases;
    }
    if (plan.phases == 0) return static_cast<int>(bad);
    plan.cooperative |= plan.phases > 1;
    for (int r = plan.phases; r < kMaxPhases; ++r) plan.ph[r] = plan.ph[0];
    if (form == 6)
      return static_cast<int>(
          kStripCluster[op] ? kStripCluster[op](a, y, tmp, plan, n, s, ctas)
                            : bad);
    return static_cast<int>(kStrip[op](a, y, tmp, plan, n, s, ctas));
  }
  return static_cast<int>(bad);
}

// The geometry of form 0 or 2's launch of op on rows x cols cells (a
// fold's args and input as probe_narrow_launch takes them), its pointers
// 16-byte aligned: out[0] its CTAs an SM holds at once, [1] its dynamic
// shared memory, [2] its grid, [3] a fold tile's rows (a binary launch's
// whole vectors). A fold whose box passes shared memory is refused.
int probe_narrow_geometry(int form, int op, const int* args, int n_args,
                          int rows, int cols, int in_rows, int in_cols,
                          int* out) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (rows < 1 || cols < 1 || op < 0 || out == nullptr ||
      static_cast<long long>(rows) * cols > (1 << 30))
    return static_cast<int>(bad);
  if (form == 0 && op < count(kBinaryGeometry))
    return static_cast<int>(kBinaryGeometry[op](rows * cols, true, out));
  Taps t;
  if (form == 2 && op < count(kFoldGeometry) &&
      taps_of(args, n_args, in_rows, in_cols, &t) &&
      static_cast<long long>(in_rows) * in_cols <= (1 << 30)) {
    FoldPlan p;
    return static_cast<int>(kFoldGeometry[op](in_rows, in_cols, rows, cols,
                                              t, true, true, &p, out));
  }
  return static_cast<int>(bad);
}

const char* probe_narrow_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
