// Nova's matrix-vector product over Fr as per-thread and per-block code
// (csrc/matvec.cu runs it on the card; tests/matvec_host.cpp runs the same
// functions block by block, thread by thread, on the CPU, with the warp
// shuffles emulated).
//
// out[r] = sum_j A[r, j] z[j] (Montgomery form, canonical) for a dense
// (m, n, 8) matrix A and an (n, 8) vector z of canonical Montgomery words.
//
// Partition.  Block b takes the MV_ROWS rows [b TR, (b + 1) TR) (TR =
// MV_ROWS; rows past m re-read row m - 1 and are not written), across all n
// columns.  Thread t walks the columns j = t, t + T, ... < n (T =
// MV_THREADS): it loads z[j] once for its TR rows and each A[r, j] once, so
// a warp reads 1 KB of one row contiguously.  In a thread:
//   1. for each row, the exact sum of its a * z products in a 17-word
//      accumulator: each product's 16 words by the schoolbook carry chains
//      (mad_row), then one 17-word add; no reduction inside the loop;
//   2. for each row, one Montgomery reduction of that sum to a canonical
//      value (mv_reduce);
// then the block adds the threads' canonical values: the lanes of a warp by
// shuffles, the warps through shared memory (mv_block_total), and writes
// each of its rows once.
//
// Why the words equal the reference's.  a_j = A_j R and z_j = Z_j R
// (mod p), so the exact sum S = sum a_j z_j satisfies S R^{-1} = (sum A_j
// Z_j) R (mod p): the Montgomery form of the reference's sum.  Every value
// leaves step 2 canonical, and the field add is canonical, commutative and
// associative, so any grouping gives the same words.
//
// Headroom.  p < 2^254.86, so one product a z <= (p - 1)^2 < 2^509.72 and
// 16 words hold only 4 of them; 17 words hold S for up to 2^34 terms.  A
// thread sums k <= n < 2^31 terms (the entry point refuses larger n), so
// S <= k (p - 1)^2 < 2^540.72.
#pragma once

#include "field.cuh"

#ifndef ZK_MATVEC_ROWS
#define ZK_MATVEC_ROWS 1
#endif
#ifndef ZK_MATVEC_THREADS
#define ZK_MATVEC_THREADS 128
#endif

#if defined(__CUDACC__)
#define ZK_MV_HD __host__ __device__ __forceinline__
#else
#define ZK_MV_HD inline
#endif

constexpr int MV_L = 8;               // Fr's limbs
constexpr int MV_ACC = 2 * MV_L + 1;  // the accumulator's words
constexpr int MV_ROWS = ZK_MATVEC_ROWS;
constexpr uint32_t MV_THREADS = ZK_MATVEC_THREADS;
constexpr uint32_t MV_WARPS = MV_THREADS / 32;
constexpr int64_t MV_MAX_COLS = (int64_t{1} << 31) - 1;
static_assert(MV_ROWS >= 1 && MV_ROWS <= 32, "1 to 32 rows a block");
static_assert(MV_THREADS % 32 == 0 && MV_WARPS >= 1 && MV_WARPS <= 32, "1 to 32 whole warps a block");

struct MatvecConsts {
  FieldConsts<MV_L> f;
  uint32_t k[MV_L];  // 2^32 R mod p: fmul(w, k) = w 2^32 mod p
};

ZK_MV_HD bool mv_args_ok(int64_t m, int64_t n) { return m >= 1 && n >= 1 && n <= MV_MAX_COLS; }

ZK_MV_HD int64_t mv_blocks(int64_t m) { return (m + MV_ROWS - 1) / MV_ROWS; }

inline MatvecConsts mv_consts(const uint32_t* p, uint32_t pinv, const uint32_t* k) {
  MatvecConsts c;
  c.f = make_consts<MV_L>(p, pinv);
  for (int j = 0; j < MV_L; ++j) c.k[j] = k[j];
  return c;
}

// A's words are read once: on the card as 16-byte streaming loads (evict
// first), so that z, re-read by every block, stays in L2.
ZK_FN void mv_load_a(uint32_t* d, const uint32_t* s) {
#if defined(__CUDA_ARCH__)
  const uint4 v0 = __ldcs(reinterpret_cast<const uint4*>(s)), v1 = __ldcs(reinterpret_cast<const uint4*>(s) + 1);
  d[0] = v0.x, d[1] = v0.y, d[2] = v0.z, d[3] = v0.w, d[4] = v1.x, d[5] = v1.y, d[6] = v1.z, d[7] = v1.w;
#else
  std::memcpy(d, s, MV_L * sizeof(uint32_t));
#endif
}

ZK_FN void mv_load_z(uint32_t* d, const uint32_t* s) {
#if defined(__CUDA_ARCH__)
  const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(s)), v1 = __ldg(reinterpret_cast<const uint4*>(s) + 1);
  d[0] = v0.x, d[1] = v0.y, d[2] = v0.z, d[3] = v0.w, d[4] = v1.x, d[5] = v1.y, d[6] = v1.z, d[7] = v1.w;
#else
  std::memcpy(d, s, MV_L * sizeof(uint32_t));
#endif
}

// acc[0..16] += a z: the 16-word product by eight rows of carry chains
// (row i adds a z_i into prod[i..i+8], whose word i + 8 is still 0, and the
// partial product a (z mod 2^(32 (i + 1))) fits in i + 9 words, so no carry
// leaves the row), then one 17-word add.  The caller keeps acc below 2^544.
ZK_FN void mv_mad(uint32_t* acc, const uint32_t* a, const uint32_t* z) {
  uint32_t prod[2 * MV_L];
#pragma unroll
  for (int j = 0; j < 2 * MV_L; ++j) prod[j] = 0;
#pragma unroll
  for (int i = 0; i < MV_L; ++i) mad_row<MV_L>(prod + i, a, z[i]);
  acc[0] = cc::add_cc(acc[0], prod[0]);
#pragma unroll
  for (int j = 1; j < 2 * MV_L; ++j) acc[j] = cc::addc_cc(acc[j], prod[j]);
  acc[2 * MV_L] = cc::addc(acc[2 * MV_L], 0);
}

// Phase 1, thread t of the block at row r0: acc[r] = the exact sum over
// its columns j = t, t + T, ... < n of A[row r, j] z[j], row r being r0 + r,
// or m - 1 past the last row.
ZK_FN void mv_thread_sums(const uint32_t* A, const uint32_t* z, int64_t m, int64_t n, int64_t r0, uint32_t t,
                          uint32_t (&acc)[MV_ROWS][MV_ACC]) {
  const uint32_t* rows[MV_ROWS];
#pragma unroll
  for (int r = 0; r < MV_ROWS; ++r) {
    rows[r] = A + (r0 + r < m ? r0 + r : m - 1) * n * MV_L;
#pragma unroll
    for (int w = 0; w < MV_ACC; ++w) acc[r][w] = 0;
  }
#pragma unroll 1
  for (int64_t j = t; j < n; j += MV_THREADS) {
    uint32_t zj[MV_L], a[MV_ROWS][MV_L];
    mv_load_z(zj, z + j * MV_L);
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) mv_load_a(a[r], rows[r] + j * MV_L);
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) mv_mad(acc[r], a[r], zj);
  }
}

// Phase 2: out = S R^{-1} mod p, canonical, for one accumulator S = t <
// 2^540.72 (destroyed).  Nine Montgomery rounds, each adding m_i p 2^(32 i)
// with m_i = t[i] (-p^{-1}) mod 2^32, so that word i becomes 0 (the
// window's carries ride up to word 16), give
//     W = (S + M p) / 2^288,  M < 2^288,
// with S + M p < 2^540.72 + 2^542.86 < 2^543.16: no carry leaves word 16,
// and W < 2^255.16 < 1.23 p < 2p, so one conditional subtraction of p makes
// it canonical.  W = S 2^(-288) = S R^{-1} 2^(-32) (mod p), so the product
// fmul(W, k) = W 2^32 R R^{-1} = S R^{-1} (mod p), canonical.
ZK_FN void mv_reduce(uint32_t* out, uint32_t* t, const MatvecConsts& c) {
  const uint32_t* p = c.f.p;
#pragma unroll
  for (int i = 0; i <= MV_L; ++i) {
    const uint32_t m = t[i] * c.f.pinv;
    t[i] = cc::mad_lo_cc(p[0], m, t[i]);
#pragma unroll
    for (int j = 1; j < MV_L; ++j) t[i + j] = cc::madc_lo_cc(p[j], m, t[i + j]);
#pragma unroll
    for (int j = i + MV_L; j < 2 * MV_L; ++j) t[j] = cc::addc_cc(t[j], 0);
    t[2 * MV_L] = cc::addc(t[2 * MV_L], 0);
    t[i + 1] = cc::mad_hi_cc(p[0], m, t[i + 1]);
#pragma unroll
    for (int j = 1; j < MV_L; ++j) t[i + 1 + j] = cc::madc_hi_cc(p[j], m, t[i + 1 + j]);
    if (i < MV_L) {  // the high chain's carry, up from word i + 9 (in round 8 that chain ends at word 16)
#pragma unroll
      for (int j = i + MV_L + 1; j < 2 * MV_L; ++j) t[j] = cc::addc_cc(t[j], 0);
      t[2 * MV_L] = cc::addc(t[2 * MV_L], 0);
    }
  }
  uint32_t w[MV_L];
  cond_sub<MV_L>(w, t + MV_L + 1, c.f.p);
  fmul<MV_L>(out, w, c.k, c.f);
}

// After the warps' shuffles: row r's total over the MV_WARPS warp sums in
// s (MV_WARPS x MV_ROWS x 8 words), written to out.
ZK_FN void mv_block_total(uint32_t* out, const uint32_t* s, uint32_t r, const FieldConsts<MV_L>& f) {
  uint32_t v[MV_L], x[MV_L];
  copy_limbs<MV_L>(v, s + r * MV_L);
#pragma unroll 1
  for (uint32_t w = 1; w < MV_WARPS; ++w) {
    copy_limbs<MV_L>(x, s + (w * MV_ROWS + r) * MV_L);
    fadd<MV_L>(v, v, x, f);
  }
  store_elem<MV_L>(out, v);
}
