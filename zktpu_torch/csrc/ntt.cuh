// The NTT of zktpu_torch/poly/ntt_kernel.py over Fr as per-thread code for
// one block (csrc/ntt.cu runs it on the card; tests/ntt_host.cpp runs the
// same functions block by block, thread by thread, on the CPU).  Every
// function is a template on the limb count L; the library instantiates
// L = 8 (Fr).  Goldilocks has a design of its own, csrc/ntt_gl.cuh.
//
// A transform of n = 2^log_n elements (L little-endian u32 Montgomery limbs
// each, rows of a (B, n, L) batch) is the reference's radix-2 DIT: the
// bit-reverse gather, then for s = 1..log_n and m = 2^s the butterflies
//     (u, v) <- (u + w v, u - w v),  w = tw[(i mod m/2) (n / m)]
// on the pairs (i, i + m/2) of each group of m, tw = gen^i (i < n/2).  The
// output is multiplied by an optional factor (n^-1, or n^-1 offset^-i for
// the coset inverse) and the input by another (offset^i for the coset
// transform).  Every value is canonical (field.cuh's fmul, fadd, fsub), so
// the words equal the stage loop's.
//
// The stages run in passes.  Pass k runs stages s0 + 1 .. s0 + ns on tiles
// of 2^ns rows x 2^log_cols columns: tile element (j, c) is position
//     h 2^(s0 + ns) + j 2^s0 + l0 + c
// of the bit-reversed order, whose butterflies in these stages pair rows j
// of one column only, so a block loads a tile into shared memory, runs its
// ns stages there and writes it back.  The first pass (s0 = 0) takes
// contiguous runs and gathers them through the bit reversal; later passes
// run in place on the output.  A tile holds at most 2^ZK_NTT_LOG_TILE
// elements, and later passes keep at least 2^ZK_NTT_LOG_MIN_COLS columns so
// that each row of a tile is that many consecutive elements in memory.  An
// Fr tile is 2^9 elements (16 KB of shared memory).  The library builds with
// the defaults below; the host tests build smaller tiles with -D so that
// several passes run at small n.
#pragma once

#include "field.cuh"

#ifndef ZK_NTT_LOG_TILE
#define ZK_NTT_LOG_TILE 9  // 2^9 elements x 32 bytes: 16 KB of shared memory
#endif
#ifndef ZK_NTT_LOG_MIN_COLS
#define ZK_NTT_LOG_MIN_COLS 3  // 8 columns: 256 contiguous bytes per row
#endif
#ifndef ZK_NTT_THREADS
#define ZK_NTT_THREADS 128
#endif

// Host and device: the launcher sizes its grid and shared memory with these.
#if defined(__CUDACC__)
#define ZK_HD __host__ __device__ __forceinline__
#else
#define ZK_HD inline
#endif

constexpr uint32_t NTT_THREADS = ZK_NTT_THREADS;
constexpr int NTT_MAX_PASSES = 32;

// The tile: log2 of its elements and of the least columns a later pass keeps.
template <int L>
struct NttTileShape {
  static constexpr int log_tile = ZK_NTT_LOG_TILE;
  static constexpr int log_min_cols = ZK_NTT_LOG_MIN_COLS;
};

struct NttPass {
  int s0;        // stages done before this pass
  int ns;        // stages this pass runs
  int log_cols;  // log2 of the tile's columns
};

// The passes of a 2^log_n transform (log_n <= 31) over a field of L limbs;
// returns their number.
template <int L>
inline int ntt_plan(int log_n, NttPass* passes) {
  constexpr int tile = NttTileShape<L>::log_tile, least = NttTileShape<L>::log_min_cols;
  int k = 0, s0 = 0;
  do {
    const int min_cols = s0 < least ? s0 : least;
    const int ns = log_n - s0 < tile - min_cols ? log_n - s0 : tile - min_cols;
    const int log_cols = s0 < tile - ns ? s0 : tile - ns;
    passes[k++] = NttPass{s0, ns, log_cols};
    s0 += ns;
  } while (s0 < log_n);
  return k;
}

// One pass over a batch: pointers to rows of L words.
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

// Where tile `tile` of a pass lies: position (j, c) is base + (j << s0) + c;
// l0 is the position of column 0 inside its group of 2^s0.
struct NttTile {
  uint32_t base, l0;
};

ZK_FN NttTile ntt_tile(const NttPass& p, uint32_t tile) {
  const int per_h = p.s0 - p.log_cols;  // log2 of the tiles that share one h
  const uint32_t h = tile >> per_h;
  const uint32_t l0 = (tile & ((1u << per_h) - 1)) << p.log_cols;
  return NttTile{(h << p.s0 << p.ns) + l0, l0};
}

ZK_HD uint32_t ntt_tile_elems(const NttPass& p) { return 1u << (p.ns + p.log_cols); }

// Thread `tid`'s share of loading tile `tile` of batch row `row` into sm
// (element e at sm + L e, e = j 2^log_cols + c).  The first pass gathers
// through the bit reversal and multiplies by the input factor.
template <int L>
ZK_FN void ntt_load_thread(const NttArgs& a, uint32_t tile, uint32_t row, uint32_t tid, uint32_t* sm,
                           const FieldConsts<L>& f) {
  const NttPass& p = a.pass;
  const NttTile t = ntt_tile(p, tile);
  const uint64_t row_base = (uint64_t)row << a.log_n;
  const uint32_t cmask = (1u << p.log_cols) - 1;
  for (uint32_t e = tid; e < ntt_tile_elems(p); e += NTT_THREADS) {
    const uint32_t pos = t.base + ((e >> p.log_cols) << p.s0) + (e & cmask);
    uint32_t x[L];
    if (a.first) {
      const uint32_t src = ntt_bitrev(pos, a.log_n);
      load_elem<L>(x, a.in + (row_base + src) * L);
      if (a.in_f) {
        uint32_t g[L];
        load_elem<L>(g, a.in_f + (uint64_t)src * a.in_fs * L);
        fmul<L>(x, x, g, f);
      }
    } else {
      load_elem<L>(x, a.out + (row_base + pos) * L);
    }
    store_elem<L>(sm + e * L, x);
  }
}

// Thread `tid`'s butterflies of the pass's local stage r (1..ns), global
// stage s = s0 + r: butterfly b is column c = b mod 2^log_cols and row pair
// (ju, ju + 2^(r-1)) of the tile.
template <int L>
ZK_FN void ntt_stage_thread(const NttArgs& a, uint32_t tile, int r, uint32_t tid, uint32_t* sm,
                            const FieldConsts<L>& f) {
  const NttPass& p = a.pass;
  const NttTile t = ntt_tile(p, tile);
  const uint32_t cmask = (1u << p.log_cols) - 1;
  const uint32_t hmask = (1u << (r - 1)) - 1;
  const int tw_shift = a.log_n - (p.s0 + r);  // stage s takes every (n / 2^s)-th power
  const uint32_t butterflies = ntt_tile_elems(p) >> 1;
  for (uint32_t b = tid; b < butterflies; b += NTT_THREADS) {
    const uint32_t c = b & cmask, q = b >> p.log_cols;
    const uint32_t jj = q & hmask;
    const uint32_t ju = ((q >> (r - 1)) << r) + jj;
    uint32_t* u = sm + ((ju << p.log_cols) + c) * L;
    uint32_t* v = u + ((1u << (r - 1)) << p.log_cols) * L;
    const uint32_t i = (jj << p.s0) + t.l0 + c;  // position in the stage's half group
    uint32_t x[L], w[L], y[L];
    load_elem<L>(x, v);
    load_elem<L>(w, a.tw + ((uint64_t)i << tw_shift) * L);
    fmul<L>(w, x, w, f);  // w v
    load_elem<L>(x, u);
    fadd<L>(y, x, w, f);
    fsub<L>(x, x, w, f);
    store_elem<L>(u, y);
    store_elem<L>(v, x);
  }
}

// Thread `tid`'s share of writing the tile back; the last pass multiplies
// by the output factor.
template <int L>
ZK_FN void ntt_store_thread(const NttArgs& a, uint32_t tile, uint32_t row, uint32_t tid, const uint32_t* sm,
                            const FieldConsts<L>& f) {
  const NttPass& p = a.pass;
  const NttTile t = ntt_tile(p, tile);
  const uint64_t row_base = (uint64_t)row << a.log_n;
  const uint32_t cmask = (1u << p.log_cols) - 1;
  for (uint32_t e = tid; e < ntt_tile_elems(p); e += NTT_THREADS) {
    const uint32_t pos = t.base + ((e >> p.log_cols) << p.s0) + (e & cmask);
    uint32_t x[L];
    load_elem<L>(x, sm + e * L);
    if (a.last && a.out_f) {
      uint32_t g[L];
      load_elem<L>(g, a.out_f + (uint64_t)pos * a.out_fs * L);
      fmul<L>(x, x, g, f);
    }
    store_elem<L>(a.out + (row_base + pos) * L, x);
  }
}
