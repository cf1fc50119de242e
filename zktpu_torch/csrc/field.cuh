// Multi-limb Montgomery arithmetic for the zktpu_torch kernels.
//
// A field element is L little-endian 32-bit limbs, Montgomery form with
// R = 2^(32 L).  These device helpers are the Hopper counterparts of
// zktpu/fields/pallas_mont.py::RowOps (mul, add, sub, dbl and cond_sub_p).
//
// Two families:
// - the canonical helpers (fmul, fadd, fsub, fdbl) take and return values
//   < p, so any composition of them gives the reference's words;
// - the lazy helpers (mont_mul_lazy, add_nr, add_red, sub_red, cond_sub) let
//   values run above p inside a formula (g1.cuh states the bound on every
//   intermediate), and the formula canonicalizes its outputs only.  Equal
//   field elements canonicalize to equal words, so the outputs are the same.
//
// The Montgomery product is written as PTX carry chains (mad.lo.cc,
// madc.hi.cc, addc): each row a * b_i and m * p is two chains of L
// multiply-adds whose carries ride the condition code, with no separate
// add or shift for the carry.  The header also compiles as host C++ (g++):
// there the PTX instructions are emulated one for one, so the CPU tests run
// the same chains and the same formulas.
#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define ZK_FN __device__ __forceinline__
#else
#define ZK_FN inline
#endif

template <int L>
struct FieldConsts {
  uint32_t p[L];
  uint32_t p2[L];  // 2p mod 2^(32 L): the lazy helpers' modulus multiple
  uint32_t pinv;   // -p^{-1} mod 2^32
};

// ---------------------------------------------------------------------------
// Carry-chain primitives: PTX on the device, an emulation of the condition
// code's carry flag on the host.
// ---------------------------------------------------------------------------
namespace cc {
#if defined(__CUDA_ARCH__)
#define ZK_ASM2(name, op)                                                       \
  ZK_FN uint32_t name(uint32_t a, uint32_t b) {                                 \
    uint32_t r;                                                                 \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));                \
    return r;                                                                   \
  }
#define ZK_ASM3(name, op)                                                       \
  ZK_FN uint32_t name(uint32_t a, uint32_t b, uint32_t c) {                     \
    uint32_t r;                                                                 \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));    \
    return r;                                                                   \
  }
ZK_ASM2(add_cc, "add.cc.u32")
ZK_ASM2(addc_cc, "addc.cc.u32")
ZK_ASM2(addc, "addc.u32")
ZK_ASM2(sub_cc, "sub.cc.u32")
ZK_ASM2(subc_cc, "subc.cc.u32")
ZK_ASM2(subc, "subc.u32")
ZK_ASM3(mad_lo_cc, "mad.lo.cc.u32")
ZK_ASM3(madc_lo_cc, "madc.lo.cc.u32")
ZK_ASM3(mad_hi_cc, "mad.hi.cc.u32")
ZK_ASM3(madc_hi_cc, "madc.hi.cc.u32")
ZK_ASM3(madc_hi, "madc.hi.u32")
#undef ZK_ASM2
#undef ZK_ASM3
#else
inline thread_local uint32_t flag;  // the carry (or borrow) flag of the condition code
inline uint32_t add_(uint64_t s, bool set) {
  if (set) flag = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t add_cc(uint32_t a, uint32_t b) { return add_((uint64_t)a + b, true); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return add_((uint64_t)a + b + flag, true); }
inline uint32_t addc(uint32_t a, uint32_t b) { return add_((uint64_t)a + b + flag, false); }
inline uint32_t sub_(uint64_t a, uint64_t b, bool set) {
  if (set) flag = a < b;
  return (uint32_t)(a - b);
}
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return sub_(a, b, true); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) { return sub_(a, (uint64_t)b + flag, true); }
inline uint32_t subc(uint32_t a, uint32_t b) { return sub_(a, (uint64_t)b + flag, false); }
inline uint32_t lo(uint32_t a, uint32_t b) { return (uint32_t)((uint64_t)a * b); }
inline uint32_t hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(lo(a, b), c); }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(lo(a, b), c); }
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(hi(a, b), c); }
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(hi(a, b), c); }
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) { return addc(hi(a, b), c); }
#endif
}  // namespace cc

// t[0..L] += a * w: a chain over the low halves into t[0..L-1] (carry into
// t[L]), then a chain over the high halves into t[1..L].  The caller
// guarantees that the sum fits in L + 1 words, so the last carry is 0.
template <int L>
ZK_FN void mad_row(uint32_t* t, const uint32_t* a, uint32_t w) {
  t[0] = cc::mad_lo_cc(a[0], w, t[0]);
#pragma unroll
  for (int j = 1; j < L; ++j) t[j] = cc::madc_lo_cc(a[j], w, t[j]);
  t[L] = cc::addc(t[L], 0);
  t[1] = cc::mad_hi_cc(a[0], w, t[1]);
#pragma unroll
  for (int j = 1; j < L - 1; ++j) t[j + 1] = cc::madc_hi_cc(a[j], w, t[j + 1]);
  t[L] = cc::madc_hi(a[L - 1], w, t[L]);
}

// Lazy Montgomery product (CIOS): out = (a b + M p) / R for the M < R that
// makes the division exact, so out == a b R^{-1} (mod p) and
//     out < a b / R + p.
// Requires a + p < R.  Then every partial sum t stays below a + p < R
// between rows and below 2^32 R inside one, so L + 1 words hold it and no
// carry leaves the top word (the extra carry word of fmul_wide is not
// needed).  For Fq (p < 0.102 R): a < 4p, b < 2p gives out < 1.82 p < 2p;
// for canonical inputs out < 2p in every field with 2p < R.
template <int L>
ZK_FN void mont_mul_lazy(uint32_t* out, const uint32_t* a, const uint32_t* b,
                         const FieldConsts<L>& f) {
  uint32_t t[L + 1];
#pragma unroll
  for (int j = 0; j < L + 1; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    mad_row<L>(t, a, b[i]);
    const uint32_t m = t[0] * f.pinv;
    mad_row<L>(t, f.p, m);  // t[0] becomes 0: shift down one word
#pragma unroll
    for (int j = 0; j < L; ++j) t[j] = t[j + 1];
    t[L] = 0;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = t[j];
}

// out = v - m if v >= m else v, for a value v < 2^(32 L) and a modulus
// multiple m (p or 2p).
template <int L>
ZK_FN void cond_sub(uint32_t* out, const uint32_t* v, const uint32_t* m) {
  uint32_t d[L];
  d[0] = cc::sub_cc(v[0], m[0]);
#pragma unroll
  for (int j = 1; j < L; ++j) d[j] = cc::subc_cc(v[j], m[j]);
  const uint32_t borrow = cc::subc(0, 0);  // 0xffffffff if v < m
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = borrow ? v[j] : d[j];
}

// out = a + b with no reduction; the caller guarantees a + b < 2^(32 L).
template <int L>
ZK_FN void add_nr(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  out[0] = cc::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < L - 1; ++j) out[j] = cc::addc_cc(a[j], b[j]);
  out[L - 1] = cc::addc(a[L - 1], b[L - 1]);
}

// out = a + b reduced once by m: for a + b < 2m (and 2m < 2^(32 L)), out < m.
template <int L>
ZK_FN void add_red(uint32_t* out, const uint32_t* a, const uint32_t* b, const uint32_t* m) {
  uint32_t s[L];
  add_nr<L>(s, a, b);
  cond_sub<L>(out, s, m);
}

// out = a - b, plus m if that borrows: for a, b < m, out < m.
template <int L>
ZK_FN void sub_red(uint32_t* out, const uint32_t* a, const uint32_t* b, const uint32_t* m) {
  uint32_t d[L];
  d[0] = cc::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < L; ++j) d[j] = cc::subc_cc(a[j], b[j]);
  const uint32_t mask = cc::subc(0, 0);  // 0xffffffff if a < b
  out[0] = cc::add_cc(d[0], m[0] & mask);
#pragma unroll
  for (int j = 1; j < L - 1; ++j) out[j] = cc::addc_cc(d[j], m[j] & mask);
  out[L - 1] = cc::addc(d[L - 1], m[L - 1] & mask);
}

// out = v - p if (top || v >= p) else v, for a value top * 2^(32 L) + v < 2p.
// When top is set, v - p wraps mod 2^(32 L) to the true difference (< p).
template <int L>
ZK_FN void reduce_once(uint32_t* out, const uint32_t* v, uint32_t top, const FieldConsts<L>& f) {
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

// CIOS with an extra carry word t[L + 1], for a field with p > R/2: t can
// reach 2p > R, and the top word tells reduce_once to subtract
// (pallas_mont.py cond_sub_p's carry_top branch).  Goldilocks used it
// before gl_mul below; the host tests keep it as gl_mul's reference.
template <int L>
ZK_FN void fmul_wide(uint32_t* out, const uint32_t* a, const uint32_t* b, const FieldConsts<L>& f) {
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

// ---------------------------------------------------------------------------
// Goldilocks, p = 2^64 - 2^32 + 1, on one 64-bit word (limb 0 its low half):
// the port's only field of two limbs, so L = 2 means Goldilocks below.
// ---------------------------------------------------------------------------
constexpr uint64_t GL_P = 0xFFFFFFFF00000001ull;

ZK_FN uint64_t gl_word(const uint32_t* a) { return (uint64_t)a[0] | ((uint64_t)a[1] << 32); }

ZK_FN void gl_limbs(uint32_t* out, uint64_t v) {
  out[0] = (uint32_t)v;
  out[1] = (uint32_t)(v >> 32);
}

// The 128-bit a * b as four 32 x 32 -> 64-bit products, each taking the
// carry of the one before as its addend (one IMAD.WIDE.U32 each on the
// card): the product's only multiplications.  Returns the low word, the
// high one in *hi.  No partial sum overflows: (2^32 - 1)^2 + 2 (2^32 - 1)
// = 2^64 - 1.
ZK_FN uint64_t gl_mul_wide(uint64_t a, uint64_t b, uint64_t* hi) {
  const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32), b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
  const uint64_t p00 = (uint64_t)a0 * b0;
  const uint64_t p01 = (uint64_t)a0 * b1 + (p00 >> 32);
  const uint64_t p10 = (uint64_t)a1 * b0 + (uint32_t)p01;
  *hi = (uint64_t)a1 * b1 + (p01 >> 32) + (p10 >> 32);
  return (p10 << 32) | (uint32_t)p00;
}

// Montgomery product a b R^{-1} mod p, R = 2^64, for canonical a, b; the
// result is canonical.  With t = a b = t_hi R + t_lo: p^{-1} = 1 + 2^32
// (mod R), so m = t_lo p^{-1} mod R = t_lo + (t_lo << 32), and m p =
// m R - m 2^32 + m has the high word h = m - m_hi - [m_hi < m_lo] (m_hi,
// m_lo the halves of m).  Then (t - m p) / R = t_hi - h, since the low
// words cancel, and it lies in (-p, p): where it borrows, add p, i.e.
// subtract 2^64 - p = 2^32 - 1, which is the borrow mask itself.  The
// reduction is carry chains of 32-bit adds and subtracts (field.cuh's cc::
// primitives: the borrow [m_hi < m_lo] rides in the flag), no compare or
// select.
ZK_FN uint64_t gl_mul(uint64_t a, uint64_t b) {
  uint64_t hi;
  const uint64_t lo = gl_mul_wide(a, b, &hi);
  const uint32_t m0 = (uint32_t)lo, m1 = (uint32_t)(lo >> 32) + m0;
  cc::sub_cc(m1, m0);  // the flag: [m1 < m0]
  const uint32_t h0 = cc::subc_cc(m0, m1);
  const uint32_t h1 = cc::subc(m1, 0);
  const uint32_t r0 = cc::sub_cc((uint32_t)hi, h0);
  const uint32_t r1 = cc::subc_cc((uint32_t)(hi >> 32), h1);
  const uint32_t mask = cc::subc(0, 0);  // 0xffffffff if t_hi < h
  const uint32_t s0 = cc::sub_cc(r0, mask);
  return ((uint64_t)cc::subc(r1, 0) << 32) | s0;
}

// a + b mod p, canonical in and out: t = a + b + 2^32 - 1 carries past
// 2^64 exactly when a + b >= p, and is then a + b - p; otherwise a + b is
// t - (2^32 - 1).  Eight carry-chain instructions.
ZK_FN uint64_t gl_add(uint64_t a, uint64_t b) {
  const uint32_t s0 = cc::add_cc((uint32_t)a, (uint32_t)b);
  const uint32_t s1 = cc::addc_cc((uint32_t)(a >> 32), (uint32_t)(b >> 32));
  const uint32_t c = cc::addc(0, 0);
  const uint32_t t0 = cc::add_cc(s0, 0xffffffffu);
  const uint32_t t1 = cc::addc_cc(s1, 0);
  const uint32_t keep = cc::addc(c, 0xffffffffu);  // 0 if a + b >= p, else 0xffffffff
  const uint32_t r0 = cc::sub_cc(t0, keep);
  return ((uint64_t)cc::subc(t1, 0) << 32) | r0;
}

// a - b mod p, canonical in and out: where a - b borrows, add p (subtract
// the borrow mask 2^32 - 1).  Five carry-chain instructions.
ZK_FN uint64_t gl_sub(uint64_t a, uint64_t b) {
  const uint32_t d0 = cc::sub_cc((uint32_t)a, (uint32_t)b);
  const uint32_t d1 = cc::subc_cc((uint32_t)(a >> 32), (uint32_t)(b >> 32));
  const uint32_t mask = cc::subc(0, 0);  // 0xffffffff if a < b
  const uint32_t r0 = cc::sub_cc(d0, mask);
  return ((uint64_t)cc::subc(d1, 0) << 32) | r0;
}

// Canonical Montgomery product a * b * R^{-1} mod p of canonical inputs.
// Fields with 2p < R (Fq, Fr) take the carry-chain product, whose output
// < 2p needs one conditional subtraction; Goldilocks takes gl_mul.
template <int L>
ZK_FN void fmul(uint32_t* out, const uint32_t* a, const uint32_t* b, const FieldConsts<L>& f) {
  if constexpr (L == 2) {
    gl_limbs(out, gl_mul(gl_word(a), gl_word(b)));
  } else {
    uint32_t t[L];
    mont_mul_lazy<L>(t, a, b, f);
    cond_sub<L>(out, t, f.p);
  }
}

template <int L>
ZK_FN void fadd(uint32_t* out, const uint32_t* a, const uint32_t* b, const FieldConsts<L>& f) {
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
ZK_FN void fsub(uint32_t* out, const uint32_t* a, const uint32_t* b, const FieldConsts<L>& f) {
  sub_red<L>(out, a, b, f.p);
}

template <int L>
ZK_FN void fdbl(uint32_t* out, const uint32_t* a, const FieldConsts<L>& f) {
  fadd<L>(out, a, a, f);
}

template <int L>
ZK_FN bool is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) acc |= a[j];
  return acc == 0;
}

template <int L>
ZK_FN void copy_limbs(uint32_t* dst, const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j] = src[j];
}

// One row of L limbs from or to memory: on the card as 16-byte words when L
// is a multiple of 4 (Fr, Fq).
template <int L>
ZK_FN void load_elem(uint32_t* dst, const uint32_t* src) {
#if defined(__CUDA_ARCH__)
  if constexpr (L % 4 == 0) {  // the caller passes a 16-byte aligned row
#pragma unroll
    for (int k = 0; k < L / 4; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[k];
      dst[4 * k] = v.x;
      dst[4 * k + 1] = v.y;
      dst[4 * k + 2] = v.z;
      dst[4 * k + 3] = v.w;
    }
  } else {
    copy_limbs<L>(dst, src);
  }
#else
  std::memcpy(dst, src, L * sizeof(uint32_t));
#endif
}

template <int L>
ZK_FN void store_elem(uint32_t* dst, const uint32_t* src) {
#if defined(__CUDA_ARCH__)
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int k = 0; k < L / 4; ++k)
      reinterpret_cast<uint4*>(dst)[k] = make_uint4(src[4 * k], src[4 * k + 1], src[4 * k + 2], src[4 * k + 3]);
  } else {
    copy_limbs<L>(dst, src);
  }
#else
  std::memcpy(dst, src, L * sizeof(uint32_t));
#endif
}

template <int L>
inline FieldConsts<L> make_consts(const uint32_t* p_host, uint32_t pinv) {
  FieldConsts<L> f;
  uint64_t c = 0;
  for (int j = 0; j < L; ++j) {
    f.p[j] = p_host[j];
    const uint64_t s = ((uint64_t)p_host[j] << 1) + c;
    f.p2[j] = (uint32_t)s;
    c = s >> 32;
  }
  f.pinv = pinv;
  return f;
}

// ---------------------------------------------------------------------------
// Exchanges between the lanes of a warp, for the kernels whose lanes share
// values (the Horner combine in g1.cuh, the scans' look-back in
// field_ops.cuh): the intrinsics on the card, all 32 lanes taking part; in
// a host build, functions of the test shim (tests/warp_host.h), which runs
// a warp's lanes as fibers, each from one exchange to the next.
// ---------------------------------------------------------------------------
#if defined(__CUDA_ARCH__)
ZK_FN uint32_t warp_shfl(uint32_t v, uint32_t src) { return __shfl_sync(0xffffffffu, v, src); }
ZK_FN uint32_t warp_ballot(bool pred) { return __ballot_sync(0xffffffffu, pred); }
ZK_FN uint32_t warp_shfl_down(uint32_t v, uint32_t d, uint32_t) { return __shfl_down_sync(0xffffffffu, v, d); }
ZK_FN uint32_t lowest_lane(uint32_t mask) { return __ffs(mask) - 1; }  // mask != 0
#else
uint32_t warp_shfl(uint32_t v, uint32_t src);  // lane src's v (mod 32)
uint32_t warp_ballot(bool pred);               // bit l set where lane l's pred is
inline uint32_t warp_shfl_down(uint32_t v, uint32_t d, uint32_t lane) {  // lane + d's v, or its own past lane 31
  return warp_shfl(v, lane + d < 32 ? lane + d : lane);
}
inline uint32_t lowest_lane(uint32_t mask) { return (uint32_t)__builtin_ctz(mask); }
#endif
