// C semantics of SODA stencil statements, shared by the generated CUDA
// kernels and their host-compiled check (soda_tpu_torch/backend/
// cuda_source.py). The contract is the NumPy oracle's
// (soda_tpu/backend/semantics.py): integer operands promoted to at
// least 32 bits, truncating division, wrap-around at stores and casts,
// floats at their own precision, half as a storage format.
//
// What C leaves undefined is defined here to match the oracle:
// - signed + - * and negation wrap: they run in the unsigned type of
//   the same width (signed overflow is undefined behaviour, and -O3
//   exploits it);
// - a / 0 is 1 for negative signed a and 0 otherwise, a % 0 == a, and
//   MIN / -1 wraps to MIN (numpy's floor division, fixed up to
//   truncation by soda_tpu.backend.semantics.c_int_div);
// - wrap to N bits masks and sign-extends, for any N in 1..64.
// Float -> int conversion truncates toward zero through a 64-bit
// integer. C leaves out-of-range values undefined (numpy gives INT_MIN);
// stencil programs keep their float -> int conversions in range.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#ifdef __CUDACC__
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#define SODA_HD __host__ __device__ __forceinline__
#else
#define SODA_HD inline
#endif

namespace soda {

template <class T>
using unsigned_t = typename std::make_unsigned<T>::type;

// ---- wrapping integer arithmetic ------------------------------------------
template <class T>
SODA_HD T add(T a, T b) {
  return (T)(unsigned_t<T>)((unsigned_t<T>)a + (unsigned_t<T>)b);
}
template <class T>
SODA_HD T sub(T a, T b) {
  return (T)(unsigned_t<T>)((unsigned_t<T>)a - (unsigned_t<T>)b);
}
template <class T>
SODA_HD T mul(T a, T b) {
  return (T)(unsigned_t<T>)((unsigned_t<T>)a * (unsigned_t<T>)b);
}
template <class T>
SODA_HD T neg(T a) {
  return (T)(unsigned_t<T>)((unsigned_t<T>)0 - (unsigned_t<T>)a);
}
template <class T>
SODA_HD T div(T a, T b) {
  if (b == 0) {
    if constexpr (std::is_signed<T>::value) return a < 0 ? T(1) : T(0);
    return T(0);
  }
  if constexpr (std::is_signed<T>::value) {
    if (b == T(-1)) return neg(a);
  }
  return a / b;
}
template <class T>
SODA_HD T mod(T a, T b) {
  if (b == 0) return a;
  if constexpr (std::is_signed<T>::value) {
    if (b == T(-1)) return T(0);
  }
  return a % b;
}
template <class T>
SODA_HD T iabs(T a) {
  if constexpr (std::is_signed<T>::value) return a < 0 ? neg(a) : a;
  return a;
}

// numpy's minimum/maximum: NaN propagates from either side
template <class T>
SODA_HD T min_(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <class T>
SODA_HD T max_(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// ---- wrap to N bits ---------------------------------------------------------
template <class T, int N, class S>
SODA_HD T wrap_int(S x) {
  static_assert(N >= 1 && N <= 64, "width out of range");
  const unsigned long long mask = ((1ull << (N - 1)) << 1) - 1ull;
  unsigned long long u = (unsigned long long)x & mask;
  if constexpr (std::is_signed<T>::value) {
    if ((u >> (N - 1)) & 1ull) u |= ~mask;
  }
  return (T)(long long)u;
}

// float -> int as numpy's trunc-then-astype (in range)
template <class T, int N, class F>
SODA_HD T f2i(F x) {
  if constexpr (std::is_signed<T>::value || N < 64) {
    return wrap_int<T, N>((long long)x);
  } else {
    return (T)(unsigned long long)x;
  }
}

// ---- bit casts ----------------------------------------------------------------
SODA_HD uint32_t f32_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  return u;
#endif
}
SODA_HD float f32_from_bits(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, sizeof(x));
  return x;
#endif
}
SODA_HD uint64_t f64_bits(double x) {
#ifdef __CUDA_ARCH__
  return (uint64_t)__double_as_longlong(x);
#else
  uint64_t u;
  memcpy(&u, &x, sizeof(u));
  return u;
#endif
}

// ---- half: a storage format; arithmetic runs at float ----------------------
// Round to nearest even from a sign, a biased binary exponent `e` (the
// value's exponent + 15) and a mantissa `m` holding `mbits` fraction
// bits below an explicit leading one.
SODA_HD uint16_t half_round(uint32_t sign, int e, uint64_t m, int mbits) {
  if (e >= 31) return (uint16_t)(sign | 0x7c00u);
  int shift = mbits - 10;  // normal: keep 10 fraction bits
  if (e <= 0) shift += 1 - e;  // subnormal: denormalize
  if (shift > mbits + 1) return (uint16_t)sign;  // below half the least subnormal
  uint64_t hm = m >> shift;
  const uint64_t rem = m & ((1ull << shift) - 1ull);
  const uint64_t halfway = 1ull << (shift - 1);
  if (rem > halfway || (rem == halfway && (hm & 1ull))) ++hm;
  // a normal's hidden bit lands on the exponent field: add e - 1 so the
  // field reads e; a carry out of the mantissa bumps it (to inf at most)
  const uint32_t bits = e > 0 ? (uint32_t)(((uint64_t)(e - 1) << 10) + hm)
                              : (uint32_t)hm;
  return (uint16_t)(sign | (bits > 0x7c00u ? 0x7c00u : bits));
}

SODA_HD uint16_t f2h(float x) {
#ifdef __CUDA_ARCH__
  return __half_as_ushort(__float2half_rn(x));
#else
  const uint32_t u = f32_bits(x);
  const uint32_t sign = (u >> 16) & 0x8000u;
  const uint32_t a = u & 0x7fffffffu;
  if (a >= 0x7f800000u) return (uint16_t)(sign | 0x7c00u | (a > 0x7f800000u ? 0x200u : 0u));
  if (a == 0) return (uint16_t)sign;
  const int e = (int)(a >> 23) - 127 + 15;
  uint64_t m = a & 0x7fffffu;
  if (a >> 23) m |= 0x800000u;
  else return (uint16_t)sign;  // float subnormals are far below half's range
  return half_round(sign, e, m, 23);
#endif
}

SODA_HD uint16_t d2h(double x) {
  const uint64_t u = f64_bits(x);
  const uint32_t sign = (uint32_t)((u >> 48) & 0x8000u);
  const uint64_t a = u & 0x7fffffffffffffffull;
  if (a >= 0x7ff0000000000000ull)
    return (uint16_t)(sign | 0x7c00u | (a > 0x7ff0000000000000ull ? 0x200u : 0u));
  if ((a >> 52) == 0) return (uint16_t)sign;  // zero or far below half's range
  const int e = (int)(a >> 52) - 1023 + 15;
  if (e < -30) return (uint16_t)sign;
  const uint64_t m = (a & 0xfffffffffffffull) | (1ull << 52);
  if (e >= 31) return (uint16_t)(sign | 0x7c00u);
  // keep 53 bits of mantissa: shift stays below 64
  return half_round(sign, e, m, 52);
}

SODA_HD float h2f(uint16_t h) {
#ifdef __CUDA_ARCH__
  return __half2float(__ushort_as_half(h));
#else
  const uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  const uint32_t e = (h >> 10) & 0x1fu;
  uint32_t m = h & 0x3ffu;
  uint32_t bits;
  if (e == 0) {
    if (m == 0) {
      bits = sign;
    } else {
      int s = -1;
      do {
        ++s;
        m <<= 1;
      } while (!(m & 0x400u));
      bits = sign | ((uint32_t)(112 - s) << 23) | ((m & 0x3ffu) << 13);
    }
  } else if (e == 31) {
    bits = sign | 0x7f800000u | (m << 13);
  } else {
    bits = sign | ((e + 112u) << 23) | (m << 13);
  }
  return f32_from_bits(bits);
#endif
}

// a float rounded to half precision, carried as float
SODA_HD float rh(float x) { return h2f(f2h(x)); }
SODA_HD float rh(double x) { return h2f(d2h(x)); }

#ifdef __CUDACC__
// ---- the mode kernels' copies (cuda_source.py _mode_kernel) ---------------
// cp.async of Bytes (4, 8 or 16) from global `src` to shared `dst`, both
// aligned to Bytes; bytes past `src_bytes` are written as 0, and with
// src_bytes == 0 nothing is read.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  static_assert(Bytes == 4 || Bytes == 8 || Bytes == 16,
                "cp.async copies 4, 8 or 16 bytes");
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(Bytes), "r"(src_bytes)
               : "memory");
}
// close this thread's current group of cp.async copies
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 16 bytes from shared `src` to global `dst`, both 16-byte aligned
__device__ __forceinline__ void store16(void* dst, const void* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
#endif

#if defined(__CUDACC__) || defined(SODA_EMULATE)
// ---- the layout forms' warp windows (cuda_source.py _value_blocks) --------
// A warp window's row holds C cells per lane, lane l the cells
// l * C .. l * C + C - 1 of a 32 * C-cell frame row. Every index below
// is a compile-time constant once the caller's loops are unrolled, so
// the row stays in registers and the source lane and slot are fixed.
// A shuffle needs all 32 lanes: callers run these unconditionally.
#ifdef __CUDACC__
#define SODA_LAYOUT __device__ __forceinline__
#else
#define SODA_LAYOUT inline
#endif

// ``v`` of the lane ``k`` lanes further on (wrapping around the warp)
template <class T>
SODA_LAYOUT T shfl(T v, int k) {
  const int src = (int)((threadIdx.x + (unsigned)k) & 31u);
  if constexpr (sizeof(T) == 8) {
    unsigned long long u;
    memcpy(&u, &v, 8);
    u = __shfl_sync(0xffffffffu, u, src);
    memcpy(&v, &u, 8);
  } else {
    unsigned u = 0;
    memcpy(&u, &v, sizeof(T));
    u = __shfl_sync(0xffffffffu, u, src);
    memcpy(&v, &u, sizeof(T));
  }
  return v;
}

// index i of a frame of E cells, wrapped (roll)
template <int E>
SODA_LAYOUT int wrap_index(int i) {
  return ((i % E) + E) % E;
}

// (lanes further on, slot) of cell j of this lane's block of C
template <int C>
SODA_LAYOUT int lane_of(int j) {
  return j >= 0 ? j / C : -((C - 1 - j) / C);
}

// cell j (relative to this lane's first; any integer) of a frame row:
// a register of this lane or a lane rotate, wrapping around the frame
template <int C, class T>
SODA_LAYOUT T lane_get(const T (&row)[C], int j) {
  const int k = lane_of<C>(j);
  const int s = j - k * C;
  return k == 0 ? row[s] : shfl(row[s], k);
}

// ---- packed 16-bit pairs (narrow stages): cells 2q, 2q + 1 of a lane's
// block in word q, the first in the low half; C is even
SODA_LAYOUT uint32_t pack2(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5410);
}
SODA_LAYOUT uint32_t vadd2(uint32_t a, uint32_t b) { return __vadd2(a, b); }

// a 16-bit half as a value of T (sign- or zero-extended by T's sign)
template <class T>
SODA_LAYOUT T unpack16(uint32_t h) {
  if constexpr (std::is_signed<T>::value) {
    return (T)(int16_t)(uint16_t)(h & 0xffffu);
  } else {
    return (T)(uint16_t)(h & 0xffffu);
  }
}

// word w of this lane's packed block, or of a lane k lanes on
template <int C>
SODA_LAYOUT uint32_t word_at(const uint32_t (&row)[C / 2], int k, int w) {
  return k == 0 ? row[w] : shfl(row[w], k);
}

// cell j of a packed frame row, as T
template <int C, class T>
SODA_LAYOUT T pcell_get(const uint32_t (&row)[C / 2], int j) {
  const int k = lane_of<C>(j);
  const int s = j - k * C;
  const uint32_t w = word_at<C>(row, k, s >> 1);
  return unpack16<T>((s & 1) ? (w >> 16) : w);
}

// cells j, j + 1 of a frame row of cells, packed
template <int C, class T>
SODA_LAYOUT uint32_t pair_get(const T (&row)[C], int j) {
  return pack2((uint32_t)lane_get<C>(row, j), (uint32_t)lane_get<C>(row, j + 1));
}

// cells j, j + 1 of a packed frame row: one word at an even cell; at an
// odd one the pair straddles two words (of this lane, or the last of
// this lane's and the first of the next), realigned on the word
template <int C>
SODA_LAYOUT uint32_t ppair_get(const uint32_t (&row)[C / 2], int j) {
  const int k = lane_of<C>(j);
  const int s = j - k * C;
  if ((s & 1) == 0) return word_at<C>(row, k, s >> 1);
  const uint32_t a = word_at<C>(row, k, s >> 1);
  const uint32_t b = s + 1 < C ? word_at<C>(row, k, (s + 1) >> 1)
                               : word_at<C>(row, k + 1, 0);
  return __byte_perm(a, b, 0x5432);
}

// ---- per-warp scratch: slice rows and the padded transpose tile ------
// cell i of a buffer of Word-byte cells
template <int Word, class T>
SODA_LAYOUT void xput(unsigned char* buf, int i, T v) {
  *reinterpret_cast<T*>(buf + i * Word) = v;
}
template <int Word, class T>
SODA_LAYOUT T xget(const unsigned char* buf, int i) {
  return *reinterpret_cast<const T*>(buf + i * Word);
}
#endif

}  // namespace soda
