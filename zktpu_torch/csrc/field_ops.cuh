// The field scans and the field add/sub of zktpu_torch/fields/field_kernel.py
// as per-thread code (csrc/field_ops.cu runs it on the card;
// tests/scan_host.cpp runs the same functions block by block, thread by
// thread, on the CPU, with the warp shuffles emulated).
//
// A scan runs over the rows of an (n, B) grid of field elements (L
// little-endian u32 Montgomery limbs each): element (row r, column c) lies at
// in + (r in_rs + c in_cs) L words, so a contiguous (n, B, L) tensor and an
// (B, n, L) tensor scanned along its middle axis are both read in place.  The
// combining op is the Montgomery product (cumprod, powers, batch_inv) or the
// field add (cumsum, sum); both are canonical, commutative and associative,
// so any grouping gives the plain version's words.
//
// Partition.  Logical row r of direction `dir` is physical row r (forward)
// or n - 1 - r (reverse).  Block (tile, column, z) takes logical rows
// [tile T C, (tile + 1) T C) of one column for T = SCAN_THREADS threads and
// C = chunk rows a thread; thread t takes the C consecutive rows from
// (tile T + t) C.  In a block:
//   1. each thread combines its chunk into one value (C - 1 ops);
//   2. the threads of a warp scan those values by shuffles (5 steps), and
//      each takes its exclusive prefix within the warp (one more shuffle);
//   3. lane 31 of each warp writes the warp's total to shared memory;
//   4. warp 0 scans the warp totals (5 steps), starts them from the carry of
//      the earlier tiles (multi-pass scan), and writes each warp's prefix;
//      in reduce mode the last warp's inclusive value is the block's total;
//   5. each thread combines its warp's prefix with its own, then walks its
//      chunk again and writes each row's inclusive value (C ops).
// One block per column covers n <= T C rows, so the whole scan is one launch.
// Longer scans are reduce-then-scan: tile totals (reduce mode), a scan of the
// totals (this code again, over (tiles, dirs x B) rows), then every tile once
// more with its carry (scan mode).  The host decides the passes.
#pragma once

#include "field.cuh"

#ifndef ZK_SCAN_THREADS
#define ZK_SCAN_THREADS 256
#endif

// Host and device: the launcher sizes its grid with these.
#if defined(__CUDACC__)
#define ZK_SCAN_HD __host__ __device__ __forceinline__
#else
#define ZK_SCAN_HD inline
#endif

constexpr uint32_t SCAN_THREADS = ZK_SCAN_THREADS;
constexpr uint32_t SCAN_WARPS = SCAN_THREADS / 32;
static_assert(SCAN_THREADS % 32 == 0 && SCAN_WARPS >= 1 && SCAN_WARPS <= 32, "1 to 32 whole warps a block");

enum { SCAN_OP_MUL = 0, SCAN_OP_ADD = 1 };
enum { SCAN_MODE_SCAN = 0, SCAN_MODE_REDUCE = 1 };
enum { SCAN_FORWARD = 1, SCAN_REVERSE = 2 };  // bits of ScanArgs::dirs
enum { FIELD_ADD = 0, FIELD_SUB = 1 };

template <int L>
struct Elem {
  uint32_t w[L];
};

template <int L>
struct ScanConsts {
  FieldConsts<L> f;
  uint32_t id[L];  // the op's identity: the Montgomery one, or zero
};

struct ScanArgs {
  const uint32_t* in;  // element (r, c) at in + (r in_rs + c in_cs) L
  int64_t in_rs, in_cs;
  uint32_t* out_fwd;   // scan mode: the forward scan, or null
  uint32_t* out_rev;   // scan mode: the reverse scan, or null; element (r, c) at (r out_rs + c out_cs) L
  int64_t out_rs, out_cs;
  uint32_t* totals;       // reduce mode: block totals, (tiles, nd, B) elements
  const uint32_t* carry;  // scan mode: the inclusive scan of the tile totals, (tiles, nd, B), or null
  int64_t n, B, chunk;
  int dirs;  // SCAN_FORWARD, SCAN_REVERSE or both (then blockIdx.z 0 is forward, 1 reverse)
  int mode;
};

// Which block this is: tile, column, z (direction slot) and the direction.
struct ScanBlock {
  int64_t tile, col;
  int z;
  bool rev;
};

ZK_SCAN_HD int scan_dirs_count(int dirs) { return dirs == (SCAN_FORWARD | SCAN_REVERSE) ? 2 : 1; }

ZK_FN ScanBlock scan_block(const ScanArgs& a, int64_t tile, int64_t col, int z) {
  const bool rev = a.dirs == (SCAN_FORWARD | SCAN_REVERSE) ? z == 1 : a.dirs == SCAN_REVERSE;
  return ScanBlock{tile, col, z, rev};
}

template <int L, int OP>
ZK_FN void scan_op(uint32_t* out, const uint32_t* x, const uint32_t* y, const FieldConsts<L>& f) {
  if constexpr (OP == SCAN_OP_MUL) {
    fmul<L>(out, x, y, f);
  } else {
    fadd<L>(out, x, y, f);
  }
}

// Physical row of logical row r.
ZK_FN int64_t scan_row(const ScanArgs& a, const ScanBlock& b, int64_t r) { return b.rev ? a.n - 1 - r : r; }

template <int L>
ZK_FN const uint32_t* scan_in(const ScanArgs& a, const ScanBlock& b, int64_t r) {
  return a.in + (scan_row(a, b, r) * a.in_rs + b.col * a.in_cs) * L;
}

template <int L>
ZK_FN uint32_t* scan_out(const ScanArgs& a, const ScanBlock& b, int64_t r) {
  return (b.rev ? a.out_rev : a.out_fwd) + (scan_row(a, b, r) * a.out_rs + b.col * a.out_cs) * L;
}

// Phase 1: v = the combination of thread t's chunk (the identity if empty).
template <int L, int OP>
ZK_FN void scan_chunk_total(const ScanArgs& a, const ScanConsts<L>& c, const ScanBlock& b, uint32_t t, uint32_t* v) {
  const int64_t r0 = (b.tile * SCAN_THREADS + t) * a.chunk;
  if (r0 >= a.n) {
    copy_limbs<L>(v, c.id);
    return;
  }
  const int64_t end = r0 + a.chunk < a.n ? r0 + a.chunk : a.n;
  load_elem<L>(v, scan_in<L>(a, b, r0));
#pragma unroll 1
  for (int64_t r = r0 + 1; r < end; ++r) {
    uint32_t x[L];
    load_elem<L>(x, scan_in<L>(a, b, r));
    scan_op<L, OP>(v, v, x, c.f);
  }
}

// Phases 2 and 4, one step of a lane: v = from (x) v if the lane takes it.
template <int L, int OP>
ZK_FN void scan_lane_step(uint32_t* v, const uint32_t* from, bool take, const FieldConsts<L>& f) {
  if (take) scan_op<L, OP>(v, from, v, f);
}

// Phase 4, warp 0's input: warp `lane`'s total, the identity past the last warp.
template <int L>
ZK_FN void scan_warp0_load(const ScanConsts<L>& c, uint32_t lane, const uint32_t* s_warp, uint32_t* w) {
  if (lane < SCAN_WARPS) {
    copy_limbs<L>(w, s_warp + lane * L);
  } else {
    copy_limbs<L>(w, c.id);
  }
}

// Phase 4, reduce mode: the block's total goes to its slot of `totals`.
template <int L>
ZK_FN uint32_t* scan_total_slot(const ScanArgs& a, const ScanBlock& b) {
  return a.totals + ((b.tile * scan_dirs_count(a.dirs) + b.z) * a.B + b.col) * L;
}

// Phase 4, scan mode: the prefix of warp `lane` (from the exclusive value
// `below` of the warp scan, ignored for lane 0), started from the carry of
// the tiles before this one.
template <int L, int OP>
ZK_FN void scan_warp_prefix(const ScanArgs& a, const ScanConsts<L>& c, const ScanBlock& b, uint32_t lane,
                            const uint32_t* below, uint32_t* out) {
  if (a.carry == nullptr || b.tile == 0) {  // the first tile: no carry
    if (lane == 0) {
      copy_limbs<L>(out, c.id);
    } else {
      copy_limbs<L>(out, below);
    }
    return;
  }
  uint32_t carry[L];
  load_elem<L>(carry, a.carry + (((b.tile - 1) * scan_dirs_count(a.dirs) + b.z) * a.B + b.col) * L);
  if (lane == 0) {
    copy_limbs<L>(out, carry);
  } else {
    scan_op<L, OP>(out, carry, below, c.f);
  }
}

// Phase 5: thread t's prefix (its warp's prefix, then the exclusive value
// `below` within the warp, ignored for lane 0), then its chunk's outputs.
template <int L, int OP>
ZK_FN void scan_chunk_write(const ScanArgs& a, const ScanConsts<L>& c, const ScanBlock& b, uint32_t t,
                            const uint32_t* warp_prefix, const uint32_t* below) {
  const int64_t r0 = (b.tile * SCAN_THREADS + t) * a.chunk;
  if (r0 >= a.n) return;
  uint32_t v[L], x[L];
  if (t % 32 == 0) {
    copy_limbs<L>(v, warp_prefix);
  } else {
    scan_op<L, OP>(v, warp_prefix, below, c.f);
  }
  const int64_t end = r0 + a.chunk < a.n ? r0 + a.chunk : a.n;
#pragma unroll 1
  for (int64_t r = r0; r < end; ++r) {
    load_elem<L>(x, scan_in<L>(a, b, r));
    scan_op<L, OP>(v, v, x, c.f);
    store_elem<L>(scan_out<L>(a, b, r), v);
  }
}

// powers: out[r] = z^r for r < count.  Thread g takes rows [g C, (g + 1) C):
// it builds z^(g C) from the table z^(2^j) (one product per set bit), then
// multiplies by z row by row.
template <int L>
struct PowTable {
  uint32_t z2[32][L];  // z^(2^j), Montgomery form
};

template <int L>
ZK_FN void powers_thread(uint32_t* out, int64_t count, int64_t chunk, const ScanConsts<L>& c,
                         const PowTable<L>& tab, int64_t g) {
  const int64_t r0 = g * chunk;
  if (r0 >= count) return;
  uint32_t v[L], z[L];
  copy_limbs<L>(v, c.id);
#pragma unroll 1
  for (int j = 0; j < 32; ++j) {
    if ((r0 >> j) & 1) {
      copy_limbs<L>(z, tab.z2[j]);
      fmul<L>(v, v, z, c.f);
    }
  }
  store_elem<L>(out + r0 * L, v);
  copy_limbs<L>(z, tab.z2[0]);
  const int64_t end = r0 + chunk < count ? r0 + chunk : count;
#pragma unroll 1
  for (int64_t r = r0 + 1; r < end; ++r) {
    fmul<L>(v, v, z, c.f);
    store_elem<L>(out + r * L, v);
  }
}

// batch_inv's last step for row i: out[i] = P[i - 1] S[i + 1] inv, with the
// shifted rows read by index (P[-1] = S[n] = 1).
template <int L>
ZK_FN void batch_inv_row(const uint32_t* P, const uint32_t* S, uint32_t* out, int64_t n, int64_t i,
                         const ScanConsts<L>& c, const uint32_t* inv) {
  uint32_t x[L], y[L];
  if (i > 0) {
    load_elem<L>(x, P + (i - 1) * L);
  } else {
    copy_limbs<L>(x, c.id);
  }
  if (i + 1 < n) {
    load_elem<L>(y, S + (i + 1) * L);
  } else {
    copy_limbs<L>(y, c.id);
  }
  fmul<L>(x, x, y, c.f);
  copy_limbs<L>(y, inv);
  fmul<L>(x, x, y, c.f);
  store_elem<L>(out + i * L, x);
}

// Kernel B, row i: out[i] = a[i mod na] +/- b[i mod nb] (canonical).
template <int L, int OP>
ZK_FN void addsub_row(const uint32_t* a, int64_t na, const uint32_t* b, int64_t nb, uint32_t* out, int64_t n,
                      int64_t i, const FieldConsts<L>& f) {
  uint32_t x[L], y[L];
  load_elem<L>(x, a + (na == n ? i : i % na) * L);
  load_elem<L>(y, b + (nb == n ? i : i % nb) * L);
  if constexpr (OP == FIELD_ADD) {
    fadd<L>(x, x, y, f);
  } else {
    fsub<L>(x, x, y, f);
  }
  store_elem<L>(out + i * L, x);
}
