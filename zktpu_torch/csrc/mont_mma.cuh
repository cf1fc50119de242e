// The chained Montgomery product with its two constant convolutions on the
// tensor cores: the per-warp code of kernels 5m and 5f (mont_mma.cu).
//
// Replaces the "mxu" and "f32" bodies of tools/prof_mulkernels.py::make_chain
// (RowOpsMXU.mul and RowOpsF32.conv_full), the structure of the reference's
// production product for D >= 16 (zktpu/fields/pallas_mont.py RowOps.mul
// with _const_mxu).  One product x * y * R^{-1} mod p is
//
//   1. t = x y, 2L words: the variable convolution.  "mxu": the carry-chain
//      rows of field.cuh (mad_row) on the integer multiply-add pipe; "f32":
//      FP32 FMAs over 8-bit digits into two accumulators per column (accA:
//      lo*lo at offset i + j, hi*hi at i + j + 1; accB: lo*hi + hi*lo at
//      i + j, weight 256), exact because every sum stays below 2^24;
//   2. m_cols = (t mod R) * (-p^{-1}) as D base-2^16 column sums, on the
//      tensor cores; m = their value mod R;
//   3. mp_cols = m * p as 2D column sums, on the tensor cores;
//   4. (t + m p) / R from t and mp_cols, then one conditional subtraction.
//
// Steps 2 and 3 are u8 matrix products, mma.sync.m16n8k32 with s32
// accumulators: the 8-bit digits of 32 elements (two m-tiles of 16 rows)
// against the constant matrices of fields/mont_mats.py::kernel_mats
// (k = byte r of the operand in natural order, so a 32-bit limb is the four
// k of one fragment register; n = 2 s + w, the weight-1 and weight-256
// digit products of column s side by side, so that a lane's accumulator
// pair c[0], c[1] is one column: c[0] + (c[1] << 8)).  Each sum is at most
// 2D * 255^2 < 2^22, and the combined column below 2^31.  Blocks of the
// matrix that are all zero (the band structure of a convolution) are
// skipped at compile time: 26 of Fq's 36 products per m-tile are left
// (6,656 multiply-accumulates an element), 12 of Fr's 12.
//
// Layout: each lane owns one element for the per-element work (steps 1 and
// 4 and the carries).  The operand and the columns move between that
// layout and the fragments through shared memory: one row of XS words per
// element for the operand's bytes, one row of CS words for its columns.
// The strides (XS = 12, CS = 2D + 4) make the fragment loads, the
// fragment stores and the lanes' 16-byte row accesses free of bank
// conflicts.  The constant B fragments are loaded once per warp and stay in
// registers across the chain.
//
// The code is per lane with two warp-collective points, warp_sync() and
// mma_u8(); as host C++ the test shim (tests/mont_mma_host.cpp) runs a warp
// as 32 threads and emulates the two with the PTX ISA's fragment layouts.
#pragma once

#include "field.cuh"

#if defined(__CUDACC__)
#define ZK_CX __host__ __device__ constexpr
#else
#define ZK_CX constexpr
#endif

#if defined(__CUDA_ARCH__)
ZK_FN void warp_sync() { __syncwarp(); }

// c (16 x 8, s32) += a (16 x 32, u8, row) * b (32 x 8, u8, col): lane 4 g + t holds
//   a[0]: row g, k 4t..4t+3;  a[1]: row g + 8, the same k;  a[2], a[3]: the same rows, k 16 + 4t..
//   b[0]: column g, k 4t..4t+3;  b[1]: column g, k 16 + 4t..
//   c[0], c[1]: row g, columns 2t, 2t + 1;  c[2], c[3]: row g + 8, the same columns
ZK_FN void mma_u8(uint32_t* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

ZK_FN float f32_of_bits(uint32_t u) { return __uint_as_float(u); }
ZK_FN uint32_t bits_of_f32(float f) { return __float_as_uint(f); }
#else
#include <cmath>

void warp_sync();
void mma_u8(uint32_t* c, const uint32_t* a, const uint32_t* b);

inline float f32_of_bits(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t bits_of_f32(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
#endif

template <int L>
struct MmaShape {
  static constexpr int D = 2 * L;                    // 16-bit digits of an element
  static constexpr int K8 = 2 * D;                   // its bytes: the k of the products
  static constexpr int KS = (K8 + 31) / 32;          // k-steps of 32 bytes (Fq 2, Fr 1)
  static constexpr int KW = 8 * KS;                  // words of a matrix row
  static constexpr int XS = L % 8 == 0 ? L + 4 : L;  // words of an operand row in shared memory
  static constexpr int CS = 2 * D + 4;               // words of a column row
  static constexpr int WARP_WORDS = 32 * (XS + CS);  // one warp's shared memory
};

// One constant convolution with S column sums (D: the product mod R; 2D: the
// whole product).  n-tile j holds columns 4j..4j+3.
template <int L, int S>
struct ConstConv {
  using Sh = MmaShape<L>;
  static constexpr int NT = S / 4;
  // A[s][r] and B[s][r] are bytes 2s - r and 2s + 1 - r of the constant, so
  // tile j meets only the bytes r in [8j - K8 + 1, 8j + 7]: block (j, ks) is
  // zero unless k-step ks holds one of them.
  static ZK_CX bool used(int j, int ks) {
    return 32 * ks < Sh::K8 && 32 * ks <= 8 * j + 7 && 32 * ks + 31 >= 8 * j - Sh::K8 + 1;
  }
  // b[1] and a[2], a[3] hold bytes 16..31 of the k-step: past the operand for Fq's second step
  static ZK_CX bool has_hi(int ks) { return 32 * ks + 16 < Sh::K8; }
};

// The B fragments of one constant matrix (2S rows of KW words), for the
// lane, zero in the blocks that are skipped.
template <int L, int S>
ZK_FN void load_b(uint32_t (&bf)[S / 4][MmaShape<L>::KS][2], const uint32_t* mat, int lane) {
  using Sh = MmaShape<L>;
  using C = ConstConv<L, S>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < C::NT; ++j) {
#pragma unroll
    for (int ks = 0; ks < Sh::KS; ++ks) {
      const uint32_t* row = mat + (8 * j + g) * Sh::KW + 8 * ks;
      bf[j][ks][0] = C::used(j, ks) ? row[t] : 0;
      bf[j][ks][1] = C::used(j, ks) && C::has_hi(ks) ? row[4 + t] : 0;
    }
  }
}

// Warp-collective: for the warp's 32 elements e (rows of xs), the column
// sums cols[e][s] = sum_r x8[e][r] (A[s][r] + 256 B[s][r]), s < S, into the
// rows of cs.
template <int L, int S>
ZK_FN void const_conv(uint32_t* cs, const uint32_t* xs, const uint32_t (&bf)[S / 4][MmaShape<L>::KS][2], int lane) {
  using Sh = MmaShape<L>;
  using C = ConstConv<L, S>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t a[Sh::KS][4];
#pragma unroll
    for (int ks = 0; ks < Sh::KS; ++ks) {
      const uint32_t* r0 = xs + (16 * mt + g) * Sh::XS + 8 * ks + t;
      a[ks][0] = r0[0];
      a[ks][1] = r0[8 * Sh::XS];
      a[ks][2] = C::has_hi(ks) ? r0[4] : 0;
      a[ks][3] = C::has_hi(ks) ? r0[8 * Sh::XS + 4] : 0;
    }
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      uint32_t c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < Sh::KS; ++ks)
        if (C::used(j, ks)) mma_u8(c, a[ks], bf[j][ks]);
      uint32_t* o = cs + (16 * mt + g) * Sh::CS + 4 * j + t;
      o[0] = c[0] + (c[1] << 8);
      o[8 * Sh::CS] = c[2] + (c[3] << 8);
    }
  }
}

// t = x y (2L words): L carry-chain rows.
template <int L>
ZK_FN void conv_int(uint32_t* t, const uint32_t* x, const uint32_t* y) {
#pragma unroll
  for (int j = 0; j < 2 * L; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) mad_row<L>(t + i, x, y[i]);
}

// t = x y (2L words) from FP32 FMAs over 8-bit digits.  The accumulators
// start at 2^23, where a float holds the integer v - 2^23 < 2^23 in its
// mantissa bits, so each column reads back with a mask instead of a
// conversion (the conversion pipe issues 16 a clock per SM, FMA 128).
template <int L>
ZK_FN void conv_f32(uint32_t* t, const uint32_t* x, const uint32_t* y) {
  constexpr int D = 2 * L;
  constexpr uint32_t EXP23 = 0x4B000000u;  // the bits of 2^23
  constexpr float BIAS = 8388608.0f;
  float al[D], ah[D], acc_a[2 * D], acc_b[2 * D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const uint32_t d = (x[i / 2] >> (16 * (i & 1))) & 0xFFFF;
    al[i] = f32_of_bits(EXP23 | (d & 0xFF)) - BIAS;
    ah[i] = f32_of_bits(EXP23 | (d >> 8)) - BIAS;
  }
#pragma unroll
  for (int k = 0; k < 2 * D; ++k) acc_a[k] = acc_b[k] = BIAS;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const uint32_t d = (y[j / 2] >> (16 * (j & 1))) & 0xFFFF;
    const float bl = f32_of_bits(EXP23 | (d & 0xFF)) - BIAS;
    const float bh = f32_of_bits(EXP23 | (d >> 8)) - BIAS;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      acc_a[i + j] = fmaf(al[i], bl, acc_a[i + j]);
      acc_a[i + j + 1] = fmaf(ah[i], bh, acc_a[i + j + 1]);
      acc_b[i + j] = fmaf(al[i], bh, acc_b[i + j]);
      acc_b[i + j] = fmaf(ah[i], bl, acc_b[i + j]);
    }
  }
  uint64_t c = 0;
#pragma unroll
  for (int l = 0; l < 2 * L; ++l) {
    uint32_t col[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      col[h] = (bits_of_f32(acc_a[2 * l + h]) & 0x7FFFFF) + ((bits_of_f32(acc_b[2 * l + h]) & 0x7FFFFF) << 8);
    c += (uint64_t)col[0] + ((uint64_t)col[1] << 16);
    t[l] = (uint32_t)c;
    c >>= 32;
  }
}

// m = sum_{s < D} cols[s] 2^(16 s) mod R.
template <int L>
ZK_FN void cols_mod_r(uint32_t* m, const uint32_t* cols) {
  uint64_t c = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    c += (uint64_t)cols[2 * l] + ((uint64_t)cols[2 * l + 1] << 16);
    m[l] = (uint32_t)c;
    c >>= 32;
  }
}

// x = (t + sum_s cols[s] 2^(16 s)) / R, reduced once: the division is exact
// (the low L words are 0) and the quotient below 2p.
template <int L>
ZK_FN void finish(uint32_t* x, const uint32_t* t, const uint32_t* cols, const FieldConsts<L>& f) {
  uint32_t v[L];
  uint64_t c = 0;
#pragma unroll
  for (int l = 0; l < 2 * L; ++l) {
    c += (uint64_t)t[l] + cols[2 * l] + ((uint64_t)cols[2 * l + 1] << 16);
    if (l >= L) v[l - L] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once<L>(x, v, (uint32_t)c, f);
}

// One warp's chain: element e of the lane (e >= n: the lane computes on
// zeros for the warp's products and stores nothing), x = x y R^{-1} mod p
// `chain` times; ws: the warp's WARP_WORDS of shared memory.
template <int L, bool F32>
ZK_FN void mma_chain_warp(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n, int64_t e, int lane,
                          int chain, const uint32_t* qmat, const uint32_t* pmat, uint32_t* ws,
                          const FieldConsts<L>& f) {
  using Sh = MmaShape<L>;
  constexpr int D = Sh::D;
  uint32_t* xrow = ws + lane * Sh::XS;
  uint32_t* cs = ws + 32 * Sh::XS;
  const uint32_t* crow = cs + lane * Sh::CS;
  uint32_t x[L], y[L];
  if (e < n) {
    copy_limbs<L>(x, a + e * L);
    copy_limbs<L>(y, b + e * L);
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) x[j] = y[j] = 0;
  }
  uint32_t bq[D / 4][Sh::KS][2], bp[2 * D / 4][Sh::KS][2];
  load_b<L, D>(bq, qmat, lane);
  load_b<L, 2 * D>(bp, pmat, lane);
#pragma unroll 1
  for (int k = 0; k < chain; ++k) {
    uint32_t t[2 * L];
    if constexpr (F32) {
      conv_f32<L>(t, x, y);
    } else {
      conv_int<L>(t, x, y);
    }
    store_elem<L>(xrow, t);  // t mod R
    warp_sync();
    const_conv<L, D>(cs, ws, bq, lane);  // m_cols
    warp_sync();
    uint32_t cols[2 * D];
    load_elem<D>(cols, crow);
    uint32_t m[L];
    cols_mod_r<L>(m, cols);
    store_elem<L>(xrow, m);
    warp_sync();
    const_conv<L, 2 * D>(cs, ws, bp, lane);  // mp_cols
    warp_sync();
    load_elem<2 * D>(cols, crow);
    finish<L>(x, t, cols, f);
  }
  if (e < n) copy_limbs<L>(out + e * L, x);
}
