// Multi-limb Montgomery arithmetic for the zktpu_torch kernels.
//
// A field element is L little-endian 32-bit limbs, Montgomery form with
// R = 2^(32 L), canonical (< p).  These device helpers are the Hopper
// counterparts of zktpu/fields/pallas_mont.py::RowOps (mul, add, sub, dbl and
// cond_sub_p); every helper returns a canonical result, so any composition of
// them gives the same words as the reference's digit arithmetic.
#pragma once

#include <cstdint>

template <int L>
struct FieldConsts {
  uint32_t p[L];
  uint32_t pinv;  // -p^{-1} mod 2^32
};

// out = v - p if (top || v >= p) else v, for a value top * 2^(32 L) + v < 2p.
// When top is set, v - p wraps mod 2^(32 L) to the true difference (< p).
template <int L>
__device__ __forceinline__ void reduce_once(uint32_t* out, const uint32_t* v, uint32_t top,
                                            const FieldConsts<L>& f) {
  uint32_t d[L];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint64_t s = (uint64_t)v[j] - f.p[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool take = top != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = take ? d[j] : v[j];
}

// Montgomery product a * b * R^{-1} mod p (CIOS).  The word t[L] keeps the
// carry above R: for Goldilocks p > R/2, so t can reach 2p > R and the top
// word is what tells reduce_once to subtract (pallas_mont.py cond_sub_p's
// carry_top branch).
template <int L>
__device__ __forceinline__ void fmul(uint32_t* out, const uint32_t* a, const uint32_t* b,
                                     const FieldConsts<L>& f) {
  uint32_t t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[L] + c;
    t[L] = (uint32_t)s;
    t[L + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * f.pinv;
    s = (uint64_t)m * f.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      s = (uint64_t)m * f.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[L] + c;
    t[L - 1] = (uint32_t)s;
    t[L] = t[L + 1] + (uint32_t)(s >> 32);
  }
  reduce_once<L>(out, t, t[L], f);
}

template <int L>
__device__ __forceinline__ void fadd(uint32_t* out, const uint32_t* a, const uint32_t* b,
                                     const FieldConsts<L>& f) {
  uint32_t s[L];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint64_t v = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  reduce_once<L>(out, s, c, f);
}

template <int L>
__device__ __forceinline__ void fsub(uint32_t* out, const uint32_t* a, const uint32_t* b,
                                     const FieldConsts<L>& f) {
  uint32_t d[L];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  // a < b: add p back (mod 2^(32 L)); the mask keeps the code branch-free
  const uint32_t mask = 0u - borrow;
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint64_t v = (uint64_t)d[j] + (f.p[j] & mask) + c;
    out[j] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
}

template <int L>
__device__ __forceinline__ void fdbl(uint32_t* out, const uint32_t* a, const FieldConsts<L>& f) {
  fadd<L>(out, a, a, f);
}

template <int L>
__device__ __forceinline__ bool is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) acc |= a[j];
  return acc == 0;
}

template <int L>
__device__ __forceinline__ void copy_limbs(uint32_t* dst, const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j] = src[j];
}

template <int L>
inline FieldConsts<L> make_consts(const uint32_t* p_host, uint32_t pinv) {
  FieldConsts<L> f;
  for (int j = 0; j < L; ++j) f.p[j] = p_host[j];
  f.pinv = pinv;
  return f;
}
