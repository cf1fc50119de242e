// The field linear combination over Fr as per-row code (csrc/lincomb.cu runs
// it on the card, one thread a row; tests/lincomb_host.cpp runs the same
// functions row by row on the CPU).
//
// out[i] = sum_{k < K} (+-) a_k[i] b_k[i] + sum_{j < J} (+-) c_j[i]
//
// in Montgomery form and canonical, for K + J <= LC_MAX_TERMS terms.  Each
// a_k and c_j is an (n_k, 8) operand whose rows at n_k and beyond read as
// 0 (a term is skipped there), so polynomials of unequal lengths need no
// padding copies and a constant is an addend of one row (row 0 only).  Each
// b_k has n_k rows or one (a scalar, read at row 0).
//
// Arithmetic, as the matrix-vector product's (matvec.cuh, whose mv_mad and
// mv_reduce these rows call as they are): each product a b is exact in 16
// words and added into one 17-word accumulator; an addend c enters as
// c R, that is, added at word offset 8; a negative term enters as p - x
// (its product (p - a) b, its addend (p - c) R); then one Montgomery
// reduction of the accumulator gives the canonical row.
//
// Why the words equal the chain's.  Every operand x = X R (mod p), so the
// exact sum S = sum a_k b_k + sum c_j R satisfies S R^{-1} = (sum A_k B_k +
// sum C_j) R (mod p): the Montgomery form of the field sum that the chain
// of products, adds and subs computes.  mv_reduce returns S R^{-1} mod p,
// canonical, and each step of the chain is canonical, so the words agree.
//
// Headroom.  p < 2^254.86.  A product (p - a) b or a b is at most p (p - 1)
// < 2^509.72; an addend at most p 2^256 < 2^510.86.  So S < 8 2^510.86 =
// 2^513.86 for K + J <= 8, far below the 2^540.72 that mv_reduce takes
// (matvec.cuh, its phase 2), and no carry leaves the 17th word.
#pragma once

#include "matvec.cuh"

constexpr int LC_MAX_TERMS = 8;
constexpr int LC_DESC_WORDS = 5;  // a term's int64 words on the host: a, its rows, b or 0, its rows, negate

struct LincombTerm {
  const uint32_t* a;
  const uint32_t* b;  // nullptr for an addend
  int64_t na;         // a's rows
  int64_t nb;         // b's rows: 1 or na
  uint32_t neg;
};

struct LincombArgs {
  LincombTerm t[LC_MAX_TERMS];
  int terms;
};

// The terms of a launch from the host's description (LC_DESC_WORDS int64 a
// term), or false for what the kernel refuses: no terms or too many, n < 1,
// a term longer than n, a product whose b is neither one row nor as long as
// its a, or a pointer that is not 16-byte aligned.
inline bool lc_args(const int64_t* desc, int terms, int64_t n, LincombArgs* out) {
  if (terms < 1 || terms > LC_MAX_TERMS || n < 1) return false;
  out->terms = terms;
  for (int k = 0; k < LC_MAX_TERMS; ++k) out->t[k] = LincombTerm{nullptr, nullptr, 0, 0, 0};
  for (int k = 0; k < terms; ++k) {
    const int64_t* d = desc + LC_DESC_WORDS * k;
    LincombTerm& t = out->t[k];
    t.a = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(d[0]));
    t.na = d[1];
    t.b = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(d[2]));
    t.nb = d[3];
    t.neg = d[4] != 0;
    if (t.na < 0 || t.na > n || ((uintptr_t)t.a & 15) || ((uintptr_t)t.b & 15)) return false;
    if (t.b != nullptr && !(t.nb == 1 || t.nb == t.na)) return false;
  }
  return true;
}

// x = p - x, for a canonical x (0 gives p, which the headroom allows).
ZK_FN void lc_negate(uint32_t* x, const uint32_t* p) {
  x[0] = cc::sub_cc(p[0], x[0]);
#pragma unroll
  for (int j = 1; j < MV_L - 1; ++j) x[j] = cc::subc_cc(p[j], x[j]);
  x[MV_L - 1] = cc::subc(p[MV_L - 1], x[MV_L - 1]);
}

// acc[8..16] += c: the addend c R.
ZK_FN void lc_add_shifted(uint32_t* acc, const uint32_t* c) {
  acc[MV_L] = cc::add_cc(acc[MV_L], c[0]);
#pragma unroll
  for (int j = 1; j < MV_L; ++j) acc[MV_L + j] = cc::addc_cc(acc[MV_L + j], c[j]);
  acc[2 * MV_L] = cc::addc(acc[2 * MV_L], 0);
}

// Row i of the combination, canonical, into out (8 words).
ZK_FN void lc_row(uint32_t* out, const LincombArgs& args, int64_t i, const MatvecConsts& c) {
  uint32_t acc[MV_ACC];
#pragma unroll
  for (int w = 0; w < MV_ACC; ++w) acc[w] = 0;
#pragma unroll
  for (int k = 0; k < LC_MAX_TERMS; ++k) {
    if (k >= args.terms) break;
    const LincombTerm& t = args.t[k];
    if (i >= t.na) continue;
    uint32_t x[MV_L];
    load_elem<MV_L>(x, t.a + i * MV_L);
    if (t.neg) lc_negate(x, c.f.p);
    if (t.b != nullptr) {
      uint32_t y[MV_L];
      load_elem<MV_L>(y, t.b + (t.nb == 1 ? 0 : i) * MV_L);
      mv_mad(acc, x, y);
    } else {
      lc_add_shifted(acc, x);
    }
  }
  mv_reduce(out, acc, c);
}
