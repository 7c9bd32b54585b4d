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
//   binary: y = f(a, b), a thread per cell (or per 32-bit word of two
//     packed int16).
//   ew: y = f^n(x), each cell in a register for all n iterations, no
//     barrier. Each iteration's body takes a runtime zero (a launch
//     argument) into one of its own operations, so that neither nvcc's
//     front end nor ptxas can fold iterations into one another (n
//     doublings into one shift): the main loop runs kUnroll iterations
//     a trip, each with the body's instructions.
//   fold: y[i, j] = x[i + di0, j + dj0] (+ or min) x[i + di1, j + dj1]
//     ..., indices wrapping modulo x's extents: a fold over shifted
//     slices of an input with a margin, or (one tap) a roll.
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
//     ("cross") from global memory, combined by a min.
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

#define BINARY_ENTRY(op) &launch_binary<op>,
#define EW_ENTRY(op) &launch_ew<op>,
#define FOLD_ENTRY(op) &launch_fold<op>,
#define STRIP_ENTRY(op) &launch_strip<op>,
#define NAME(op) #op ","

const BinaryLaunch kBinary[] = {BINARY_OPS(BINARY_ENTRY)};
const EwLaunch kEw[] = {EW_OPS(EW_ENTRY)};
const FoldLaunch kFold[] = {FOLD_OPS(FOLD_ENTRY)};
const StripLaunch kStrip[] = {STRIP_OPS(STRIP_ENTRY)};

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

}  // namespace

extern "C" {

// each form's op names, in `op` order: "binary;ew;fold;strip", each a
// list of names with a comma after each
const char* probe_narrow_ops() {
  return BINARY_OPS(NAME) ";" EW_OPS(NAME) ";" FOLD_OPS(NAME) ";" STRIP_OPS(
      NAME);
}

// Form 0, binary: y = op(a, b) over rows x cols cells. 1, ew: y =
// op^n(a). 2, fold: y (rows x cols) from a (in_rows x in_cols); args:
// n_args / 2 taps (di, dj), each index wrapping. 3, strip: op's chain on
// the rows x cols block a, n iterations; args: 1 to kMaxPhases phases,
// each (axis, independent, steps, that many distances, cross taps, that
// many distances); tmp: a second block (a cooperative plan). ctas
// receives the grid size.
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
  if (form == 0 && op < count(kBinary))
    return static_cast<int>(kBinary[op](a, b, y, static_cast<int>(cells), s,
                                        ctas));
  if (form == 1 && op < count(kEw))
    return static_cast<int>(kEw[op](a, y, static_cast<int>(cells), n, s,
                                    ctas));
  if (form == 2 && op < count(kFold)) {
    if (n_args < 2 || n_args > 2 * kMaxFold || n_args % 2 || in_rows < 1 ||
        in_cols < 1)
      return static_cast<int>(bad);
    Taps t;
    t.n = n_args / 2;
    for (int q = 0; q < kMaxFold; ++q) {
      const int di = q < t.n ? args[2 * q] : 0, dj = q < t.n ? args[2 * q + 1]
                                                            : 0;
      t.di[q] = ((di % in_rows) + in_rows) % in_rows;
      t.dj[q] = ((dj % in_cols) + in_cols) % in_cols;
    }
    return static_cast<int>(kFold[op](a, y, in_rows, in_cols, rows, cols, t,
                                      s, ctas));
  }
  if (form == 3 && op < count(kStrip)) {
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
    return static_cast<int>(kStrip[op](a, y, tmp, plan, n, s, ctas));
  }
  return static_cast<int>(bad);
}

const char* probe_narrow_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
