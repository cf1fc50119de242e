// The Goldilocks NTT of zktpu_torch/poly/ntt_kernel.py (L = 2) as per-thread
// code for one block: csrc/ntt.cu runs it on the card, tests/ntt_host.cpp
// runs the same functions block by block, thread by thread, on the CPU.
//
// It computes what ntt.cuh computes for Fr: for rows of n = 2^log_n
// elements (one 64-bit Montgomery word each), the bit-reverse gather, then
// for s = 1..log_n and m = 2^s the radix-2 DIT butterflies
//     (u, v) <- (u + w v, u - w v),  w = tw[(i mod m/2) (n / m)],
// tw = gen^i (i < n/2), with an optional input factor (offset^i) multiplied
// in as it loads and an optional output factor (n^-1, n^-1 offset^-i, or
// the raw 1 that turns the output canonical) as it stores.  Every value is
// canonical (field.cuh's gl_mul, gl_add, gl_sub), so the words equal the
// stage loop's.
//
// Passes.  Pass k runs stages s0 + 1 .. s0 + ns on tiles of 2^ns rows x
// 2^cols columns.  A later pass (s0 > 0) takes tile element (q, c) from
// position h 2^(s0 + ns) + q 2^s0 + C, C = l0 + c, in place.  Its stages
// combine the 2^ns blocks A_q of 2^s0 elements that the passes before it
// made, Y(j 2^s0 + C) = sum_q A_q(C) w_(2^(s0+ns))^((j 2^s0 + C) rev(q)), so
// the pass multiplies element (q, c) by w_(2^(s0+ns))^(C rev_ns(q)) as it
// loads and then runs a plain DIT of 2^ns points over the rows: its twiddles
// w_(2^r)^e (r <= ns) are the same for every tile and column.  The first
// pass (s0 = 0) gathers through the bit reversal; its columns are 2^cols
// neighbouring values of the low source bits, so that each row of the tile
// is 2^cols consecutive input words, and each column c is written to its
// own run of 2^ns outputs.
//
// Inside a pass a thread holds 2^K elements in registers (K =
// ZK_NTT_GL_RADIX) and runs K stages on them with no barrier: step j takes
// rows Jhi 2^(r0 + K) + i 2^r0 + jlo (i < 2^K, r0 = j K) of one column.
// Between steps the tile goes through shared memory once (a barrier per K
// stages); the first step loads from device memory and the last one
// stores there.  A last step of k < K stages runs 2^(K - k) groups per
// thread.  The pass's twiddles are staged once per block into shared
// memory, stage by stage (w_(2^r)^e at 2^(r-1) - 1 + e), so the stage loop
// makes no device-memory load.  The library builds with the defaults
// below; the host tests build smaller tiles and radices with -D so that
// several passes, several steps and partial steps run at small n.
#pragma once

#include "ntt.cuh"  // ntt_bitrev, ZK_HD

#ifndef ZK_NTT_GL_RADIX
#define ZK_NTT_GL_RADIX 3  // 8 elements a thread: radix-8 steps
#endif
#ifndef ZK_NTT_GL_LOG_TILE
#define ZK_NTT_GL_LOG_TILE 13  // the largest tile: 2^13 words, 64 KB
#endif
#ifndef ZK_NTT_GL_LOG_COLS
#define ZK_NTT_GL_LOG_COLS 3  // a row of a multi-pass tile: 8 words, 64 bytes
#endif
#ifndef ZK_NTT_GL_ONE_PASS
#define ZK_NTT_GL_ONE_PASS 11  // transforms up to 2^11 points take one pass (one block a row)
#endif

constexpr int GL_K = ZK_NTT_GL_RADIX;
constexpr int GL_E = 1 << GL_K;  // elements a thread holds
constexpr int GL_MAX_LOG_TILE = ZK_NTT_GL_LOG_TILE > ZK_NTT_GL_ONE_PASS ? ZK_NTT_GL_LOG_TILE : ZK_NTT_GL_ONE_PASS;
constexpr uint32_t GL_MAX_THREADS = GL_MAX_LOG_TILE > GL_K ? 1u << (GL_MAX_LOG_TILE - GL_K) : 1u;
constexpr int GL_MAX_PASSES = 32;

struct GlPass {
  int s0;    // stages done before this pass
  int ns;    // stages this pass runs
  int cols;  // log2 of the tile's columns
};

// The passes of a 2^log_n transform (log_n <= 30); returns their number, or
// -1 if the tile macros leave a pass without its columns.  Up to
// 2^ZK_NTT_GL_ONE_PASS points: one pass, one column.  Above: the fewest
// passes (at least two) whose tiles hold 2^ZK_NTT_GL_LOG_TILE words, the
// stages spread evenly, the first passes taking one more.
inline int gl_ntt_plan(int log_n, GlPass* passes) {
  if (log_n <= ZK_NTT_GL_ONE_PASS) {
    passes[0] = GlPass{0, log_n, 0};
    return 1;
  }
  const int per = ZK_NTT_GL_LOG_TILE - ZK_NTT_GL_LOG_COLS;
  int np = (log_n + per - 1) / per;
  np = np < 2 ? 2 : np;
  // every tile holds at least 2^K words, and the first pass's columns fit
  if (per < 1 || log_n / np < ZK_NTT_GL_LOG_COLS || log_n / np + ZK_NTT_GL_LOG_COLS < GL_K) return -1;
  int s0 = 0;
  for (int k = 0; k < np; ++k) {
    const int ns = log_n / np + (k < log_n % np ? 1 : 0);
    passes[k] = GlPass{s0, ns, ZK_NTT_GL_LOG_COLS};
    s0 += ns;
  }
  return np;
}

// log2 of the elements a thread of the pass holds, its threads, its
// radix steps and the stages of step j.
ZK_HD int gl_log_elems(const GlPass& p) { return p.ns + p.cols < GL_K ? p.ns + p.cols : GL_K; }
ZK_HD uint32_t gl_threads(const GlPass& p) { return 1u << (p.ns + p.cols - gl_log_elems(p)); }
ZK_HD int gl_steps(const GlPass& p) { return p.ns == 0 ? 1 : (p.ns + GL_K - 1) / GL_K; }
ZK_HD int gl_step_stages(const GlPass& p, int j) { return p.ns - j * GL_K < GL_K ? p.ns - j * GL_K : GL_K; }

// Shared memory of a block, in 64-bit words: the twiddle table (2^ns - 1
// words, rounded up to 2^ns), then the tile with one row of padding after
// every 2^K rows (none when the pass is one step).
ZK_HD uint32_t gl_table_words(const GlPass& p) { return 1u << p.ns; }
ZK_HD uint32_t gl_smem_words(const GlPass& p) {
  const uint32_t rows = gl_steps(p) > 1 ? (1u << p.ns) + (1u << (p.ns - GL_K)) : 0;
  return gl_table_words(p) + (rows << p.cols);
}

// One pass over a batch of rows of 64-bit words.
struct GlArgs {
  const uint64_t* in;     // the input (read by the first pass only)
  uint64_t* out;          // the output (later passes read and write it in place)
  const uint64_t* tw;     // gen^i, i < n/2
  const uint64_t* in_f;   // input factor rows, or null; row i (stride in_fs: 1 or 0)
  const uint64_t* out_f;  // output factor rows, or null (stride out_fs)
  uint32_t in_fs, out_fs;
  int log_n;
  GlPass pass;
  bool first, last;
};

ZK_HD uint32_t gl_tiles(const GlArgs& a) { return 1u << (a.log_n - a.pass.ns - a.pass.cols); }

// Where a tile lies.  First pass: column c of tile t holds the source words
// (rev_ns(q) << (log_n - ns)) + cbase + c and goes to output run
// rev_(log_n - ns)(cbase + c) << ns.  Later passes: (q, c) is at
// base + (q << s0) + c, and C = l0 + c.
struct GlTile {
  uint32_t base, l0, cbase;
  uint64_t row;  // the batch row's first word
};

ZK_FN GlTile gl_tile(const GlArgs& a, uint32_t tile, uint32_t row) {
  const GlPass& p = a.pass;
  GlTile t{0, 0, 0, (uint64_t)row << a.log_n};
  if (a.first) {
    t.cbase = tile << p.cols;
  } else {
    const int per_h = p.s0 - p.cols;  // log2 of the tiles that share one h
    t.l0 = (tile & ((1u << per_h) - 1)) << p.cols;
    t.base = ((tile >> per_h) << p.s0 << p.ns) + t.l0;
  }
  return t;
}

ZK_FN uint32_t gl_pos(const GlArgs& a, const GlTile& t, uint32_t q, uint32_t c) {
  const GlPass& p = a.pass;
  if (a.first) return (ntt_bitrev(t.cbase + c, a.log_n - p.ns) << p.ns) + q;
  return t.base + (q << p.s0) + c;
}

ZK_FN uint32_t gl_smem_at(const GlPass& p, uint32_t q, uint32_t c) {
  return ((q + (q >> GL_K)) << p.cols) + c;
}

// w_(2^m)^e for e < 2^m from the table of w_n^i (i < n/2): w_n^(n/2) = -1.
ZK_FN uint64_t gl_root_power(const GlArgs& a, uint32_t e, int m) {
  const uint32_t i = e << (a.log_n - m), half = 1u << (a.log_n - 1);
  return i < half ? a.tw[i] : gl_sub(0, a.tw[i - half]);
}

// Thread tid's share of the pass's twiddle table: w_(2^r)^e at entry
// 2^(r-1) - 1 + e, for r = 1..ns and e < 2^(r-1).
ZK_FN void gl_load_table(const GlArgs& a, uint32_t tid, uint64_t* tw_sm) {
  const uint32_t entries = (1u << a.pass.ns) - 1, threads = gl_threads(a.pass);
  for (uint32_t k = tid; k < entries; k += threads) {
#if defined(__CUDA_ARCH__)
    const int r = 32 - __clz(k + 1);  // 2^(r-1) <= k + 1 < 2^r
#else
    int r = 1;
    while ((2u << (r - 1)) <= k + 1) ++r;
#endif
    tw_sm[k] = a.tw[(k + 1 - (1u << (r - 1))) << (a.log_n - r)];
  }
}

// The rows and column of the elements of group u a thread takes in a step
// of KK stages at r0: element i of the group is row jhi 2^(r0+KK) + i 2^r0
// + jlo of column c (consecutive threads: consecutive columns, then jlo).
struct GlGroup {
  uint32_t c, first_row, jlo;
};

template <int KK>
ZK_FN GlGroup gl_group(const GlPass& p, int r0, uint32_t g) {
  const uint32_t c = g & ((1u << p.cols) - 1), rest = g >> p.cols;
  const uint32_t jlo = rest & ((1u << r0) - 1);
  return GlGroup{c, ((rest >> r0) << (r0 + KK)) + jlo, jlo};
}

// Step 0's loads: a thread's groups from device memory, the first pass
// through the bit reversal times the input factor, a later pass times its
// column twiddle w_(2^(s0+ns))^(C rev_ns(q)).
template <int KK, int G>
ZK_FN void gl_gather(const GlArgs& a, const GlTile& t, uint32_t tid, uint64_t* x) {
  const GlPass& p = a.pass;
  const uint32_t threads = gl_threads(p);
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const GlGroup gr = gl_group<KK>(p, 0, u * threads + tid);
#pragma unroll
    for (int i = 0; i < (1 << KK); ++i) {
      const uint32_t q = gr.first_row + i;
      uint64_t v;
      if (a.first) {
        const uint32_t src = (ntt_bitrev(q, p.ns) << (a.log_n - p.ns)) + t.cbase + gr.c;
        v = a.in[t.row + src];
        if (a.in_f) v = gl_mul(v, a.in_f[(uint64_t)src * a.in_fs]);
      } else {
        v = a.out[t.row + gl_pos(a, t, q, gr.c)];
        v = gl_mul(v, gl_root_power(a, (t.l0 + gr.c) * ntt_bitrev(q, p.ns), p.s0 + p.ns));
      }
      x[u * (1 << KK) + i] = v;
    }
  }
}

// The KK stages of one group in registers.  Stage r0 + s + 1 pairs elements
// i and i + 2^s, twiddle w_(2^(r0+s+1))^((i mod 2^s) 2^r0 + jlo); in a
// pass's first step (FIRST: r0 = 0, jlo = 0) the twiddle of i mod 2^s = 0
// is 1 and its product is skipped (7 of a radix-8 step's 12).
template <int KK, bool FIRST>
ZK_FN void gl_radix(uint64_t* y, const uint64_t* tw_sm, int r0, uint32_t jlo) {
#pragma unroll
  for (int s = 0; s < KK; ++s) {
    const uint64_t* row = tw_sm + (1u << (r0 + s)) - 1 + jlo;
#pragma unroll
    for (int e = 0; e < (1 << s); ++e) {
      const bool unit = FIRST && e == 0;
      const uint64_t w = unit ? 0 : row[e << r0];
#pragma unroll
      for (int b = 0; b < (1 << KK); b += 2 << s) {
        const uint64_t u0 = y[b + e], v = unit ? y[b + e + (1 << s)] : gl_mul(y[b + e + (1 << s)], w);
        y[b + e] = gl_add(u0, v);
        y[b + e + (1 << s)] = gl_sub(u0, v);
      }
    }
  }
}

// Step j of KK stages (r0 = j K): read the thread's groups from shared memory
// (j > 0), run the KK stages in registers, then write them back (not the last
// step) or store them to device memory, times the output factor in the last
// pass.
template <int KK, int G>
ZK_FN void gl_step(const GlArgs& a, const GlTile& t, int j, uint32_t tid, uint64_t* x, uint64_t* sm,
                   const uint64_t* tw_sm) {
  const GlPass& p = a.pass;
  const uint32_t threads = gl_threads(p);
  const int r0 = j * GL_K;
  const bool last = j == gl_steps(p) - 1;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const GlGroup gr = gl_group<KK>(p, r0, u * threads + tid);
    uint64_t* y = x + u * (1 << KK);
    if (j > 0) {
#pragma unroll
      for (int i = 0; i < (1 << KK); ++i) y[i] = sm[gl_smem_at(p, gr.first_row + (i << r0), gr.c)];
    }
    if (j == 0)
      gl_radix<KK, true>(y, tw_sm, 0, 0);
    else
      gl_radix<KK, false>(y, tw_sm, r0, gr.jlo);
#pragma unroll
    for (int i = 0; i < (1 << KK); ++i) {
      const uint32_t q = gr.first_row + (i << r0);
      if (!last) {
        sm[gl_smem_at(p, q, gr.c)] = y[i];
      } else {
        const uint32_t pos = gl_pos(a, t, q, gr.c);
        uint64_t v = y[i];
        if (a.last && a.out_f) v = gl_mul(v, a.out_f[(uint64_t)pos * a.out_fs]);
        a.out[t.row + pos] = v;
      }
    }
  }
}

// The steps' shapes: KK stages and G groups a thread (G = 2^(K - KK) in a
// partial last step, 1 in a full one and in a tile smaller than 2^K).
#define ZK_GL_DISPATCH(FN, ...)                                              \
  switch (kk) {                                                              \
    case 0: FN<0, 1>(__VA_ARGS__); break;                                    \
    case 1: if (g == 1) FN<1, 1>(__VA_ARGS__); else FN<1, (1 << (GL_K - 1))>(__VA_ARGS__); break; \
    case 2: if (g == 1) FN<2, 1>(__VA_ARGS__); else FN<2, (GL_K >= 2 ? 1 << (GL_K - 2) : 1)>(__VA_ARGS__); break; \
    case 3: if (g == 1) FN<3, 1>(__VA_ARGS__); else FN<3, (GL_K >= 3 ? 1 << (GL_K - 3) : 1)>(__VA_ARGS__); break; \
    default: FN<(GL_K >= 4 ? 4 : 1), 1>(__VA_ARGS__); break;                 \
  }

static_assert(GL_K >= 1 && GL_K <= 4, "ZK_NTT_GL_RADIX must be 1..4");

ZK_FN int gl_groups(const GlPass& p, int kk) { return 1 << (gl_log_elems(p) - kk); }

// Phase 1 of a block (before its first barrier): the twiddle table and
// step 0's loads.
ZK_FN void gl_load_thread(const GlArgs& a, uint32_t tile, uint32_t row, uint32_t tid, uint64_t* x, uint64_t* smem) {
  gl_load_table(a, tid, smem);
  const GlTile t = gl_tile(a, tile, row);
  const int kk = gl_step_stages(a.pass, 0), g = gl_groups(a.pass, kk);
  ZK_GL_DISPATCH(gl_gather, a, t, tid, x)
}

// Step j of a block (a barrier before each step after the first).
ZK_FN void gl_step_thread(const GlArgs& a, uint32_t tile, uint32_t row, int j, uint32_t tid, uint64_t* x,
                          uint64_t* smem) {
  const GlTile t = gl_tile(a, tile, row);
  const int kk = gl_step_stages(a.pass, j), g = gl_groups(a.pass, kk);
  ZK_GL_DISPATCH(gl_step, a, t, j, tid, x, smem + gl_table_words(a.pass), smem)
}
