// The NTT of zktpu_torch/poly/ntt_kernel.py over Fr (8 little-endian u32
// Montgomery limbs an element) as per-thread code for one block: csrc/ntt.cu
// runs it on the card, tests/ntt_host.cpp runs the same functions block by
// block, thread by thread, on the CPU.  Goldilocks has a design of its own,
// csrc/ntt_gl.cuh, whose pass and step structure this one follows.
//
// A transform of n = 2^log_n elements (rows of a (B, n, 8) batch) is the
// reference's radix-2 DIT: the bit-reverse gather, then for s = 1..log_n and
// m = 2^s the butterflies
//     (u, v) <- (u + w v, u - w v),  w = tw[(i mod m/2) (n / m)]
// on the pairs (i, i + m/2) of each group of m, tw = gen^i (i < n/2).  The
// input is multiplied by an optional factor (offset^i for the coset
// transform) and the output by another (n^-1, or n^-1 offset^-i for the
// coset inverse).
//
// Passes.  Pass k runs stages s0 + 1 .. s0 + ns on tiles of 2^ns rows x
// 2^cols columns.  The first pass (s0 = 0) gathers through the bit
// reversal: column c of tile t holds the source elements
// (rev_ns(q) << (log_n - ns)) + cbase + c (cbase = t 2^cols), a 2^ns-point
// transform of its own written to the output run rev_(log_n - ns)(cbase + c)
// << ns.  A later pass takes tile element (q, c) from position
// h 2^(s0 + ns) + q 2^s0 + C, C = l0 + c, in place; stage s0 + r pairs rows
// of one column with twiddle w_(2^(s0+r))^((q mod 2^(r-1)) 2^s0 + C).  Each
// block stages the twiddles of its pass into shared memory once, before its
// first step: the first pass's 2^ns - 1 (the same for every tile and
// column), a later pass's 2^ns - 1 for each of its columns (strided in the
// table of gen^i; stage r's entries at (2^(r-1) - 1 + e) 2^tcols + c, tcols
// the table's log2 columns, 0 in the first pass), so no butterfly reads a
// twiddle from device memory.
//
// Steps.  A thread holds 2^k elements in registers (k = 1 or 2, the pass's
// radix_log) and runs k stages on them with no barrier: step j takes rows
// Jhi 2^(r0 + k) + i 2^r0 + jlo (i < 2^k, r0 = j k) of one column.  Between
// steps the tile goes through shared memory once (a barrier per k stages);
// the first step loads from device memory and the last one stores there, so
// a pass of one step never touches the shared tile.  A last step of fewer
// stages runs 2^(k - stages) groups a thread.  In the first pass's first
// step (r0 = 0) the twiddle of i mod 2^s = 0 is 1 for every thread and its
// product is skipped (3 of a radix-4 step's 4).
//
// Lazy values (Harvey's butterfly).  Every value between stages and between
// passes lies in [0, 2p), 2p < R = 2^256 (p < 0.454 R):
// - w v: a Montgomery product (ntt_mul below) with the canonical twiddle
//   (or factor) first, w < p, and v < 2p second: the product is
//   < w v / R + p < (1 + 2p/R) p < 1.91 p;
// - u + w v < 4p needs a ninth (carry) word: one conditional subtraction of
//   2p, with the carry, gives < 2p (ntt_add_2p);
// - u - w v lies in (-2p, 2p): field.cuh's sub_red against 2p adds 2p where
//   it borrows, giving [0, 2p);
// - the input factor's product (canonical factor, canonical input) is
//   < 1.91 p.
// The last pass's store canonicalizes once: the output factor's product
// (< 1.91 p) or the value itself (< 2p), less p where it is >= p.  Equal
// field elements canonicalize to equal words, so the output equals the
// stage loop's word for word.
//
// The library builds with the defaults below; the host tests build smaller
// tiles and other radix cuts with -D so that several passes, several steps
// and partial steps run at small n.
#pragma once

#include "field.cuh"

#ifndef ZK_NTT_LOG_TILE
#define ZK_NTT_LOG_TILE 10  // the largest tile of a multi-pass plan: 2^10 elements, 32 KB
#endif
#ifndef ZK_NTT_LOG_COLS
#define ZK_NTT_LOG_COLS 1  // a row of a multi-pass tile: at least 2 elements, 64 bytes
#endif
#ifndef ZK_NTT_ONE_PASS
#define ZK_NTT_ONE_PASS 10  // transforms up to 2^10 points take one pass (one block a row)
#endif
#ifndef ZK_NTT_LOG_MIN_THREADS
#define ZK_NTT_LOG_MIN_THREADS 6  // a multi-pass block has at least 2^6 threads: two warps
#endif
#ifndef ZK_NTT_RADIX2_WORK
#define ZK_NTT_RADIX2_WORK 16  // a call of at most 2^16 elements in all (batch x n) takes radix-2 steps
#endif

// Host and device: the launcher sizes its grid and shared memory with these.
#if defined(__CUDACC__)
#define ZK_HD __host__ __device__ __forceinline__
#else
#define ZK_HD inline
#endif

constexpr int NTT_L = 8;  // Fr's limbs
constexpr int NTT_MAX_LOG_TILE = ZK_NTT_LOG_TILE > ZK_NTT_ONE_PASS ? ZK_NTT_LOG_TILE : ZK_NTT_ONE_PASS;
constexpr int NTT_MAX_PASSES = 32;

// The most threads a block of radix 2^k takes.
constexpr uint32_t ntt_max_threads(int k) { return NTT_MAX_LOG_TILE > k ? 1u << (NTT_MAX_LOG_TILE - k) : 1u; }

static_assert(ntt_max_threads(1) <= 1024, "a tile of more than 1024 threads");
static_assert(ZK_NTT_LOG_MIN_THREADS + 2 <= NTT_MAX_LOG_TILE, "the thread floor makes tiles above the largest");

using FrConsts = FieldConsts<NTT_L>;

struct NttPass {
  int s0;    // stages done before this pass
  int ns;    // stages this pass runs
  int cols;  // log2 of the tile's columns
  int k;     // log2 of the elements a thread's radix step takes: 1 or 2
};

// The radix of a call's steps: 2-point steps (twice the threads, a product
// a step) for calls of at most 2^ZK_NTT_RADIX2_WORK elements, which fill a
// fraction of the card and wait on the products' latency; 4-point steps
// (half the barriers and shared-memory round trips) above.
inline int ntt_radix_log(int log_n, int64_t batch) {
  return (batch << log_n) <= ((int64_t)1 << ZK_NTT_RADIX2_WORK) ? 1 : 2;
}

// The passes of a 2^log_n transform (log_n <= 30) in radix-2^k steps;
// returns their number, or -1 if the tile macros leave a pass no stages.
// Up to 2^ZK_NTT_ONE_PASS points: one pass, one column.  Above: the fewest
// passes (at least two) whose tiles hold 2^ZK_NTT_LOG_TILE elements, the
// stages spread evenly, the first passes taking one more; a pass's columns
// are at least 2^ZK_NTT_LOG_COLS and enough for 2^ZK_NTT_LOG_MIN_THREADS
// threads, as far as the transform has them.
inline int ntt_plan(int log_n, int k, NttPass* passes) {
  if (log_n <= ZK_NTT_ONE_PASS) {
    passes[0] = NttPass{0, log_n, 0, k};
    return 1;
  }
  const int per = ZK_NTT_LOG_TILE - ZK_NTT_LOG_COLS;
  if (per < 1) return -1;
  int np = (log_n + per - 1) / per;
  np = np < 2 ? 2 : np;
  int s0 = 0;
  for (int i = 0; i < np; ++i) {
    const int ns = log_n / np + (i < log_n % np ? 1 : 0);
    const int most = i == 0 ? log_n - ns : s0;  // the first pass's tiles, a later pass's columns
    int cols = ZK_NTT_LOG_MIN_THREADS + k - ns;
    cols = cols < ZK_NTT_LOG_COLS ? ZK_NTT_LOG_COLS : cols;
    passes[i] = NttPass{s0, ns, cols < most ? cols : most, k};
    s0 += ns;
  }
  return np;
}

// log2 of the elements a thread of the pass holds, its threads, its radix
// steps and the stages of step j.
ZK_HD int ntt_log_elems(const NttPass& p) { return p.ns + p.cols < p.k ? p.ns + p.cols : p.k; }
ZK_HD uint32_t ntt_threads(const NttPass& p) { return 1u << (p.ns + p.cols - ntt_log_elems(p)); }
ZK_HD int ntt_steps(const NttPass& p) { return p.ns == 0 ? 1 : (p.ns + p.k - 1) / p.k; }
ZK_HD int ntt_step_stages(const NttPass& p, int j) { return p.ns - j * p.k < p.k ? p.ns - j * p.k : p.k; }

// log2 of the twiddle table's columns: a later pass stages its own columns'
// strided twiddles, the first pass one column for all.
ZK_HD int ntt_table_cols(const NttPass& p) { return p.s0 > 0 ? p.cols : 0; }

// Shared memory of a block, in elements of 32 bytes: the twiddle table
// (2^ns - 1 entries a column, rounded up to 2^ns), then the tile with one
// row of padding after every 2^k rows (none when the pass is one step).
// Each region keeps an element's two 16-byte halves apart (words 0-3 of
// element e at 4 e, words 4-7 at 4 (slots + e)), so that consecutive
// threads' 16-byte accesses hit consecutive banks.
ZK_HD uint32_t ntt_table_slots(const NttPass& p) { return (1u << p.ns) << ntt_table_cols(p); }
ZK_HD uint32_t ntt_tile_slots(const NttPass& p) {
  const uint32_t rows = ntt_steps(p) > 1 ? (1u << p.ns) + (1u << (p.ns - p.k)) : 0;
  return rows << p.cols;
}
ZK_HD uint32_t ntt_smem_bytes(const NttPass& p) { return (ntt_table_slots(p) + ntt_tile_slots(p)) * 32u; }

// One pass over a batch: pointers to rows of 8 words.
struct NttArgs {
  const uint32_t* in;     // the input (read by the first pass only)
  uint32_t* out;          // the output (later passes read and write it in place)
  const uint32_t* tw;     // gen^i, i < n/2
  const uint32_t* in_f;   // input factor rows, or null; row i (stride in_fs: 1 or 0)
  const uint32_t* out_f;  // output factor rows, or null (stride out_fs)
  uint32_t in_fs, out_fs;
  int log_n;
  NttPass pass;
  bool first, last;
};

ZK_HD uint32_t ntt_tiles(const NttArgs& a) { return 1u << (a.log_n - a.pass.ns - a.pass.cols); }

ZK_FN uint32_t ntt_bitrev(uint32_t i, int log_n) {
  if (log_n == 0) return 0;
#if defined(__CUDA_ARCH__)
  return __brev(i) >> (32 - log_n);
#else
  uint32_t r = 0;
  for (int b = 0; b < log_n; ++b) r |= ((i >> b) & 1u) << (log_n - 1 - b);
  return r;
#endif
}

// Where a tile lies.  First pass: column c of tile t holds the source
// elements (rev_ns(q) << (log_n - ns)) + cbase + c and goes to output run
// rev_(log_n - ns)(cbase + c) << ns.  Later passes: (q, c) is at
// base + (q << s0) + c, and C = l0 + c.
struct NttTile {
  uint32_t base, l0, cbase;
  uint64_t row;  // the batch row's first element
};

ZK_FN NttTile ntt_tile(const NttArgs& a, uint32_t tile, uint32_t row) {
  const NttPass& p = a.pass;
  NttTile t{0, 0, 0, (uint64_t)row << a.log_n};
  if (a.first) {
    t.cbase = tile << p.cols;
  } else {
    const int per_h = p.s0 - p.cols;  // log2 of the tiles that share one h
    t.l0 = (tile & ((1u << per_h) - 1)) << p.cols;
    t.base = ((tile >> per_h) << p.s0 << p.ns) + t.l0;
  }
  return t;
}

ZK_FN uint32_t ntt_pos(const NttArgs& a, const NttTile& t, uint32_t q, uint32_t c) {
  const NttPass& p = a.pass;
  if (a.first) return (ntt_bitrev(t.cbase + c, a.log_n - p.ns) << p.ns) + q;
  return t.base + (q << p.s0) + c;
}

ZK_FN uint32_t ntt_tile_at(const NttPass& p, uint32_t q, uint32_t c) {
  return ((q + (q >> p.k)) << p.cols) + c;
}

// Element e of a region of `slots` split elements, from and to registers.
ZK_FN void ntt_sm_load(uint32_t* x, const uint32_t* sm, uint32_t slots, uint32_t e) {
  load_elem<4>(x, sm + 4 * e);
  load_elem<4>(x + 4, sm + 4 * (slots + e));
}
ZK_FN void ntt_sm_store(uint32_t* sm, uint32_t slots, uint32_t e, const uint32_t* x) {
  store_elem<4>(sm + 4 * e, x);
  store_elem<4>(sm + 4 * (slots + e), x + 4);
}

// out = a + b less 2p where that is >= 2p, for a, b < 2p: a + b < 4p < 2R
// carries into a ninth word, which the subtraction's borrow takes into
// account, so out < 2p.
ZK_FN void ntt_add_2p(uint32_t* out, const uint32_t* a, const uint32_t* b, const FrConsts& f) {
  uint32_t s[NTT_L], d[NTT_L];
  s[0] = cc::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NTT_L; ++j) s[j] = cc::addc_cc(a[j], b[j]);
  const uint32_t top = cc::addc(0, 0);
  d[0] = cc::sub_cc(s[0], f.p2[0]);
#pragma unroll
  for (int j = 1; j < NTT_L; ++j) d[j] = cc::subc_cc(s[j], f.p2[j]);
  const uint32_t keep = cc::subc(top, 0);  // 0xffffffff if top:s < 2p
#pragma unroll
  for (int j = 0; j < NTT_L; ++j) out[j] = keep ? s[j] : d[j];
}

// The NTT's Montgomery product, (a b + M p) / R for the M < R that makes the
// division exact, like field.cuh's mont_mul_lazy (the same words out, the
// same bound: < a b / R + p, so < 1.91 p for a canonical a and b < 2p), but
// with the chains split by the parity of a's words.  field.cuh's rows add
// the low halves of a b_i into t[0..7], then the high halves into t[1..8],
// and the card's SASS has no multiply-add that carries out: each word
// product there is an IMAD, an IMAD.HI and about 1.7 IADD3.X for its two
// carries.  Here the product of word j lands, low and high, on two
// neighbouring words of one array (even j in `even`, odd j in `odd`, which
// holds the value one word up), so the two halves of one product sit next
// to each other in a single carry chain (mad.lo.cc, madc.hi.cc), the shape
// of a 64-bit multiply-add with carry.  Per row of b_i: the two arrays take
// a b_i and then m p (m from even[0]), and swap roles (odd, one word up,
// becomes the low array after the division by 2^32); the word that the
// shift leaves over, even[0] + odd[1], rides the carry into the next row's
// chain.  A chain's dropped carry (after the odd array's m p; the high
// half of madc_rshift's last product) is 0: each array is a part of a sum
// below 2^32 (a + p) < 2^288 whose top word it holds.  After the 8 rows the
// arrays are merged.  a is the canonical operand (a twiddle or a factor).
ZK_FN void ntt_mul_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < NTT_L; j += 2) {
    const uint64_t r = (uint64_t)a[j] * bi;
    acc[j] = (uint32_t)r;
    acc[j + 1] = (uint32_t)(r >> 32);
  }
}

// acc[0..7] += the products a[j] bi, j even: one chain; the carry out stays
// in the flag.
ZK_FN void ntt_cmad_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
  acc[0] = cc::mad_lo_cc(a[0], bi, acc[0]);
  acc[1] = cc::madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < NTT_L; j += 2) {
    acc[j] = cc::madc_lo_cc(a[j], bi, acc[j]);
    acc[j + 1] = cc::madc_hi_cc(a[j], bi, acc[j + 1]);
  }
}

// odd[j] = odd[j + 2] + the products a[j] bi (j even), the flag's carry in
// first: the sum and the shift down by two words in one chain.
ZK_FN void ntt_madc_rshift(uint32_t* odd, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < NTT_L - 2; j += 2) {
    odd[j] = cc::madc_lo_cc(a[j], bi, odd[j + 2]);
    odd[j + 1] = cc::madc_hi_cc(a[j], bi, odd[j + 3]);
  }
  odd[NTT_L - 2] = cc::madc_lo_cc(a[NTT_L - 2], bi, 0);
  odd[NTT_L - 1] = cc::madc_hi(a[NTT_L - 2], bi, 0);
}

// One row: (even, odd) += a bi, then m p with m = even[0] (-p^-1).
ZK_FN void ntt_mad_redc(uint32_t* even, uint32_t* odd, const uint32_t* a, uint32_t bi, bool first,
                        const FrConsts& f) {
  if (first) {
    ntt_mul_n(odd, a + 1, bi);
    ntt_mul_n(even, a, bi);
  } else {
    even[0] = cc::add_cc(even[0], odd[1]);
    ntt_madc_rshift(odd, a + 1, bi);
    ntt_cmad_n(even, a, bi);
    odd[NTT_L - 1] = cc::addc(odd[NTT_L - 1], 0);
  }
  const uint32_t m = even[0] * f.pinv;
  ntt_cmad_n(odd, f.p + 1, m);
  ntt_cmad_n(even, f.p, m);
  odd[NTT_L - 1] = cc::addc(odd[NTT_L - 1], 0);
}

// The product every multiplication of the transform takes: a canonical
// (a twiddle or a factor), b lazy (< 2p); out < 1.91 p.  out may alias b.
ZK_FN void ntt_mul(uint32_t* out, const uint32_t* a, const uint32_t* b, const FrConsts& f) {
  uint32_t even[NTT_L], odd[NTT_L];
#pragma unroll
  for (int i = 0; i < NTT_L; i += 2) {
    ntt_mad_redc(even, odd, a, b[i], i == 0, f);
    ntt_mad_redc(odd, even, a, b[i + 1], false, f);
  }
  out[0] = cc::add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < NTT_L - 1; ++j) out[j] = cc::addc_cc(even[j], odd[j + 1]);
  out[NTT_L - 1] = cc::addc(even[NTT_L - 1], 0);
}

// One butterfly in place: (u, v) <- (u + t, u - t), all in [0, 2p).
ZK_FN void ntt_butterfly(uint32_t* u, uint32_t* v, const uint32_t* t, const FrConsts& f) {
  uint32_t s[NTT_L];
  ntt_add_2p(s, u, t, f);
  sub_red<NTT_L>(v, u, t, f.p2);
  copy_limbs<NTT_L>(u, s);
}

// Thread tid's share of the pass's twiddle table (16 bytes a thread at a
// time: half h of entry k).  Stage r's entry (e, c), e < 2^(r-1), is
// w_(2^(s0+r))^(e 2^s0 + l0 + c) at (2^(r-1) - 1 + e) 2^tcols + c in a
// later pass, w_(2^r)^e at 2^(r-1) - 1 + e in the first.
ZK_FN void ntt_load_table(const NttArgs& a, const NttTile& t, uint32_t tid, uint32_t* tw_sm) {
  const NttPass& p = a.pass;
  const int tc = ntt_table_cols(p);
  const uint32_t slots = ntt_table_slots(p), entries = ((1u << p.ns) - 1) << tc;
  const uint32_t threads = ntt_threads(p);
  for (uint32_t k2 = tid; k2 < 2 * entries; k2 += threads) {
    const uint32_t k = k2 >> 1, h = k2 & 1, c = k & ((1u << tc) - 1), re = (k >> tc) + 1;
#if defined(__CUDA_ARCH__)
    const int r = 32 - __clz(re);  // 2^(r-1) <= re < 2^r
#else
    int r = 1;
    while ((2u << (r - 1)) <= re) ++r;
#endif
    const uint32_t e = re - (1u << (r - 1));
    const uint32_t i = p.s0 > 0 ? ((e << p.s0) + t.l0 + c) << (a.log_n - p.s0 - r) : e << (a.log_n - r);
    load_elem<4>(tw_sm + 4 * (h * slots + k), a.tw + (uint64_t)i * NTT_L + 4 * h);
  }
}

// The rows and column of the elements of group u a thread takes in a step
// of KK stages at r0: element i of the group is row jhi 2^(r0+KK) + i 2^r0
// + jlo of column c (consecutive threads: consecutive columns, then jlo).
struct NttGroup {
  uint32_t c, first_row, jlo;
};

template <int KK>
ZK_FN NttGroup ntt_group(const NttPass& p, int r0, uint32_t g) {
  const uint32_t c = g & ((1u << p.cols) - 1), rest = g >> p.cols;
  const uint32_t jlo = rest & ((1u << r0) - 1);
  return NttGroup{c, ((rest >> r0) << (r0 + KK)) + jlo, jlo};
}

// Step 0's loads: a thread's groups from device memory, the first pass
// through the bit reversal times the input factor.
template <int KK, int G>
ZK_FN void ntt_gather(const NttArgs& a, const NttTile& t, uint32_t tid, uint32_t* x, const FrConsts& f) {
  const NttPass& p = a.pass;
  const uint32_t threads = ntt_threads(p);
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const NttGroup gr = ntt_group<KK>(p, 0, u * threads + tid);
#pragma unroll
    for (int i = 0; i < (1 << KK); ++i) {
      const uint32_t q = gr.first_row + i;
      uint32_t* v = x + (u * (1 << KK) + i) * NTT_L;
      if (a.first) {
        const uint32_t src = (ntt_bitrev(q, p.ns) << (a.log_n - p.ns)) + t.cbase + gr.c;
        load_elem<NTT_L>(v, a.in + (t.row + src) * NTT_L);
        if (a.in_f) {
          uint32_t w[NTT_L];
          load_elem<NTT_L>(w, a.in_f + (uint64_t)src * a.in_fs * NTT_L);
          ntt_mul(v, w, v, f);
        }
      } else {
        load_elem<NTT_L>(v, a.out + (t.row + ntt_pos(a, t, q, gr.c)) * NTT_L);
      }
    }
  }
}

// The KK stages of one group in registers.  Stage r0 + s + 1 pairs elements
// i and i + 2^s, with the table entry of e = (i mod 2^s) 2^r0 + jlo in
// column c; with UNIT (the first pass's first step: r0 = 0, jlo = 0, one
// column of table) the entry of i mod 2^s = 0 is 1 and its product is
// skipped.
template <int KK, bool UNIT>
ZK_FN void ntt_radix(uint32_t* y, const uint32_t* tw_sm, uint32_t slots, int tc, int r0, uint32_t jlo, uint32_t c,
                     const FrConsts& f) {
#pragma unroll
  for (int s = 0; s < KK; ++s) {
    const uint32_t row = (1u << (r0 + s)) - 1 + jlo;
#pragma unroll
    for (int e = 0; e < (1 << s); ++e) {
      const bool unit = UNIT && e == 0;
      uint32_t w[NTT_L];
      if (!unit) ntt_sm_load(w, tw_sm, slots, ((row + ((uint32_t)e << r0)) << tc) + (c & ((1u << tc) - 1)));
#pragma unroll
      for (int b = 0; b < (1 << KK); b += 2 << s) {
        uint32_t* u0 = y + (b + e) * NTT_L;
        uint32_t* v = y + (b + e + (1 << s)) * NTT_L;
        uint32_t t[NTT_L];
        if (unit)
          copy_limbs<NTT_L>(t, v);
        else
          ntt_mul(t, w, v, f);
        ntt_butterfly(u0, v, t, f);
      }
    }
  }
}

// Step j of KK stages (r0 = j k): read the thread's groups from shared
// memory (j > 0), run the KK stages in registers, then write them back (not
// the last step) or store them to device memory: lazy between passes,
// canonical (times the output factor) from the last pass.
template <int KK, int G>
ZK_FN void ntt_step(const NttArgs& a, const NttTile& t, int j, uint32_t tid, uint32_t* x, uint32_t* tile_sm,
                    const uint32_t* tw_sm, const FrConsts& f) {
  const NttPass& p = a.pass;
  const uint32_t threads = ntt_threads(p), slots = ntt_tile_slots(p), tslots = ntt_table_slots(p);
  const int r0 = j * p.k, tc = ntt_table_cols(p);
  const bool last = j == ntt_steps(p) - 1;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const NttGroup gr = ntt_group<KK>(p, r0, u * threads + tid);
    uint32_t* y = x + u * (1 << KK) * NTT_L;
    if (j > 0) {
#pragma unroll
      for (int i = 0; i < (1 << KK); ++i)
        ntt_sm_load(y + i * NTT_L, tile_sm, slots, ntt_tile_at(p, gr.first_row + (i << r0), gr.c));
    }
    if (j == 0 && p.s0 == 0)
      ntt_radix<KK, true>(y, tw_sm, tslots, 0, 0, 0, 0, f);
    else
      ntt_radix<KK, false>(y, tw_sm, tslots, tc, r0, gr.jlo, gr.c, f);
#pragma unroll
    for (int i = 0; i < (1 << KK); ++i) {
      const uint32_t q = gr.first_row + (i << r0);
      uint32_t* v = y + i * NTT_L;
      if (!last) {
        ntt_sm_store(tile_sm, slots, ntt_tile_at(p, q, gr.c), v);
      } else {
        const uint32_t pos = ntt_pos(a, t, q, gr.c);
        if (a.last) {
          if (a.out_f) {
            uint32_t g[NTT_L];
            load_elem<NTT_L>(g, a.out_f + (uint64_t)pos * a.out_fs * NTT_L);
            ntt_mul(v, g, v, f);
          }
          cond_sub<NTT_L>(v, v, f.p);
        }
        store_elem<NTT_L>(a.out + (t.row + pos) * NTT_L, v);
      }
    }
  }
}

// The steps' shapes in a kernel of radix 2^K: KK stages and G groups a
// thread (G = 2^(K - KK) in a partial last step, 1 in a full one and in a
// tile smaller than 2^K).
#define ZK_NTT_DISPATCH(FN, ...)                                                     \
  switch (kk) {                                                                      \
    case 0: FN<0, 1>(__VA_ARGS__); break;                                            \
    case 1: if (g == 1) FN<1, 1>(__VA_ARGS__); else FN<1, (1 << (K - 1))>(__VA_ARGS__); break; \
    default: FN<K, 1>(__VA_ARGS__); break;                                           \
  }

ZK_FN int ntt_groups(const NttPass& p, int kk) { return 1 << (ntt_log_elems(p) - kk); }

// Phase 1 of a block (before its first barrier): the twiddle table and
// step 0's loads.  smem: the table's ntt_table_slots, then the tile's.  x:
// the thread's 2^K elements (K = a.pass.k).
template <int K>
ZK_FN void ntt_load_thread(const NttArgs& a, uint32_t tile, uint32_t row, uint32_t tid, uint32_t* x, uint32_t* smem,
                           const FrConsts& f) {
  const NttTile t = ntt_tile(a, tile, row);
  ntt_load_table(a, t, tid, smem);
  const int kk = ntt_step_stages(a.pass, 0), g = ntt_groups(a.pass, kk);
  ZK_NTT_DISPATCH(ntt_gather, a, t, tid, x, f)
}

// Step j of a block (a barrier before each step after the first).
template <int K>
ZK_FN void ntt_step_thread(const NttArgs& a, uint32_t tile, uint32_t row, int j, uint32_t tid, uint32_t* x,
                           uint32_t* smem, const FrConsts& f) {
  const NttTile t = ntt_tile(a, tile, row);
  const int kk = ntt_step_stages(a.pass, j), g = ntt_groups(a.pass, kk);
  ZK_NTT_DISPATCH(ntt_step, a, t, j, tid, x, smem + 4 * 2 * ntt_table_slots(a.pass), smem, f)
}
