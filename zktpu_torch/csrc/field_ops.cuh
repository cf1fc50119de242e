// The field scans and the field add/sub of zktpu_torch/fields/field_kernel.py
// as per-thread code (csrc/field_ops.cu runs it on the card;
// tests/scan_host.cpp runs the same functions block by block, thread by
// thread, on the CPU: the look-back's warp as 32 fibers with its ballot and
// shuffles exchanged between them, the other phases' shuffles read from a
// copy of the lanes' values).
//
// A scan runs over the rows of an (n, B) grid of field elements (L
// little-endian u32 Montgomery limbs each): element (row r, column c) lies at
// in + (r in_rs + c in_cs) L words, so a contiguous (n, B, L) tensor and an
// (B, n, L) tensor scanned along its middle axis are both read in place.  The
// combining op is the Montgomery product (cumprod, powers, batch_inv) or the
// field add (cumsum, sum); both are canonical, commutative and associative,
// so any grouping gives the plain version's words.
//
// One launch, one pass: a single-pass scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016).  Logical row r of direction `dir` is physical
// row r (forward) or n - 1 - r (reverse).  A column and direction (a
// "lane" of the grid: nd B of them, nd = 1 or 2 directions) is cut into
// `tiles` tiles of T C rows, T = SCAN_THREADS threads and C = chunk rows a
// thread; thread t of a tile takes the C consecutive rows from (tile T + t) C.
// A block takes its (tile, column, direction) from an atomic ticket, tile
// by tile across the lanes, so it only ever waits on tiles whose blocks
// took a ticket before it and are running or done: no order in which the
// card schedules blocks can hang it.  In a block:
//   1. each thread loads its chunk, SCAN_LOADS rows at a time (their loads
//      issued before their products), and combines it into one value;
//   2. the threads of a warp scan those values by shuffles (5 steps), and
//      each takes its exclusive prefix within the warp (one more shuffle);
//   3. lane 31 of each warp writes the warp's total to shared memory;
//   4. warp 0 scans the warp totals (5 steps), so its last live lane holds
//      the tile's aggregate, and looks back: it publishes the aggregate in
//      the tile's status slot (tile 0 publishes it as its inclusive
//      prefix), then reads its predecessors' slots 32 at a time, one a
//      lane, each lane waiting until its slot holds an aggregate or an
//      inclusive prefix of this launch; the window's values up to the
//      nearest inclusive prefix, combined across the lanes (5 steps), join
//      the tile's exclusive prefix, and the walk stops at that inclusive
//      prefix or goes on 32 tiles further back; then it publishes the tile's
//      inclusive prefix and writes each warp's prefix to shared memory (in
//      sum mode the last tile writes the column's total instead);
//   5. each thread combines its warp's prefix with its own, then walks its
//      chunk again and writes each row's inclusive value (C ops).
// A grid of one tile a lane has no predecessor to look back on: its blocks
// take their lanes from blockIdx and publish nothing.
// A status slot is a flag word and two values, the aggregate and the
// inclusive prefix (separate, so that a reader of the one never sees the
// other half-written).  The flag is (epoch << 2) | state: the launch's
// epoch, which the wrapper passes in, so a slot of an earlier launch reads
// as empty and no launch clears the buffer.  A value is written before its
// flag, with a fence between; a flag is read before its value, with a
// fence between.
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
constexpr int SCAN_LOADS = 4;  // rows a thread loads before it combines them
static_assert(SCAN_THREADS % 32 == 0 && SCAN_WARPS >= 1 && SCAN_WARPS <= 32, "1 to 32 whole warps a block");

enum { SCAN_OP_MUL = 0, SCAN_OP_ADD = 1 };
enum { SCAN_MODE_SCAN = 0, SCAN_MODE_SUM = 1 };
enum { SCAN_FORWARD = 1, SCAN_REVERSE = 2 };  // bits of ScanArgs::dirs
enum { SCAN_EMPTY = 0, SCAN_AGGREGATE = 1, SCAN_INCLUSIVE = 2 };  // a status slot's state
enum { FIELD_ADD = 0, FIELD_SUB = 1 };
constexpr uint32_t SCAN_MAX_LIMBS = 12;  // a status value's words, at most

template <int L>
struct Elem {
  uint32_t w[L];
};

template <int L>
struct ScanConsts {
  FieldConsts<L> f;
  uint32_t id[L];  // the op's identity: the Montgomery one, or zero
};

// The look-back's status buffer (one per device, kept by the wrapper): a
// 64-bit ticket counter, then a flag word per slot, then the slots'
// aggregates and their inclusive prefixes, SCAN_MAX_LIMBS words each.
struct ScanStatus {
  unsigned long long* ticket;
  uint32_t* flags;
  uint32_t* aggregate;
  uint32_t* inclusive;
};

// The status buffer's layout over `slots` slots, in 32-bit words: the
// ticket (two words), the flags from word 4, then the aggregates and the
// inclusive prefixes, each from a 16-byte boundary.
inline ScanStatus scan_status(uint32_t* st, int64_t slots) {
  const int64_t agg = 4 + (slots + 3) / 4 * 4;
  return ScanStatus{reinterpret_cast<unsigned long long*>(st), st + 4, st + agg, st + agg + slots * SCAN_MAX_LIMBS};
}

inline int64_t scan_status_words(int64_t slots) { return 4 + (slots + 3) / 4 * 4 + 2 * slots * SCAN_MAX_LIMBS; }

struct ScanArgs {
  const uint32_t* in;  // element (r, c) at in + (r in_rs + c in_cs) L
  int64_t in_rs, in_cs;
  uint32_t* out_fwd;   // scan mode: the forward scan, or null
  uint32_t* out_rev;   // scan mode: the reverse scan, or null; element (r, c) at (r out_rs + c out_cs) L
  int64_t out_rs, out_cs;
  uint32_t* total;     // sum mode: the (B, L) column totals
  ScanStatus status;
  uint64_t ticket_base;  // the ticket counter before this launch (one tile a lane: untouched)
  int64_t n, B, chunk, tiles;  // tiles of SCAN_THREADS chunk rows per column and direction
  uint32_t epoch;              // this launch's, in [1, 2^30)
  int dirs;  // SCAN_FORWARD, SCAN_REVERSE or both (then direction slot 0 is forward, 1 reverse)
  int mode;
};

// Which block this is: tile, column, z (direction slot) and the direction.
struct ScanBlock {
  int64_t tile, col;
  int z;
  bool rev;
};

ZK_SCAN_HD int scan_dirs_count(int dirs) { return dirs == (SCAN_FORWARD | SCAN_REVERSE) ? 2 : 1; }

// The block of ticket id (0 .. tiles nd B - 1 within the launch; blockIdx
// where tiles is 1): tile by tile, each tile across every column and
// direction.
ZK_FN ScanBlock scan_block(const ScanArgs& a, int64_t id) {
  const int64_t lanes = scan_dirs_count(a.dirs) * a.B, zc = id % lanes;
  const int z = (int)(zc / a.B);
  const bool rev = a.dirs == (SCAN_FORWARD | SCAN_REVERSE) ? z == 1 : a.dirs == SCAN_REVERSE;
  return ScanBlock{id / lanes, zc % a.B, z, rev};
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

// Thread t's rows [r0, end) of the block's lane (empty past the last row).
ZK_FN int64_t scan_chunk_start(const ScanArgs& a, const ScanBlock& b, uint32_t t) {
  return (b.tile * SCAN_THREADS + t) * a.chunk;
}

ZK_FN int64_t scan_chunk_end(const ScanArgs& a, int64_t r0) { return r0 + a.chunk < a.n ? r0 + a.chunk : a.n; }

// Rows r .. r + k - 1 (k <= SCAN_LOADS) into x, every load issued before
// any of them is used.
template <int L>
ZK_FN void scan_load_rows(const ScanArgs& a, const ScanBlock& b, int64_t r, int64_t k, uint32_t (*x)[L]) {
#pragma unroll
  for (int j = 0; j < SCAN_LOADS; ++j)
    if (j < k) load_elem<L>(x[j], scan_in<L>(a, b, r + j));
}

// Phase 1: v = the combination of thread t's chunk (the identity if empty).
template <int L, int OP>
ZK_FN void scan_chunk_total(const ScanArgs& a, const ScanConsts<L>& c, const ScanBlock& b, uint32_t t, uint32_t* v) {
  const int64_t r0 = scan_chunk_start(a, b, t), end = scan_chunk_end(a, r0);
  copy_limbs<L>(v, c.id);
#pragma unroll 1
  for (int64_t r = r0; r < end; r += SCAN_LOADS) {
    uint32_t x[SCAN_LOADS][L];
    const int64_t k = end - r < SCAN_LOADS ? end - r : SCAN_LOADS;
    scan_load_rows<L>(a, b, r, k, x);
#pragma unroll
    for (int j = 0; j < SCAN_LOADS; ++j) {
      if (j < k && r + j == r0) {
        copy_limbs<L>(v, x[j]);
      } else if (j < k) {
        scan_op<L, OP>(v, v, x[j], c.f);
      }
    }
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

// The status slot of tile `tile` of the block's lane.
ZK_FN int64_t scan_slot(const ScanArgs& a, const ScanBlock& b, int64_t tile) {
  return ((int64_t)b.z * a.B + b.col) * a.tiles + tile;
}

// Phase 4: the block's tile publishes `state` (SCAN_AGGREGATE or
// SCAN_INCLUSIVE) with value v: the value, a fence, the flag.
template <int L>
ZK_FN void scan_publish(const ScanArgs& a, const ScanBlock& b, int state, const uint32_t* v) {
  const int64_t slot = scan_slot(a, b, b.tile);
  volatile uint32_t* dst = (state == SCAN_INCLUSIVE ? a.status.inclusive : a.status.aggregate) + slot * SCAN_MAX_LIMBS;
#pragma unroll
  for (int k = 0; k < L; ++k) dst[k] = v[k];
#if defined(__CUDA_ARCH__)
  __threadfence();
#endif
  *(volatile uint32_t*)(a.status.flags + slot) = (a.epoch << 2) | (uint32_t)state;
}

// Phase 4, a lane of the look-back: the state of tile j of the block's lane
// in this launch, and its value in v (the identity for j < 0, SCAN_EMPTY).
// The caller waits while it reads SCAN_EMPTY for a j >= 0.
template <int L>
ZK_FN int scan_peek(const ScanArgs& a, const ScanConsts<L>& c, const ScanBlock& b, int64_t j, uint32_t* v) {
  copy_limbs<L>(v, c.id);
  if (j < 0) return SCAN_EMPTY;
  const int64_t slot = scan_slot(a, b, j);
  const uint32_t flag = *(volatile const uint32_t*)(a.status.flags + slot);
  const int state = (flag >> 2) == a.epoch ? (int)(flag & 3) : SCAN_EMPTY;
  if (state == SCAN_EMPTY) return state;
#if defined(__CUDA_ARCH__)
  __threadfence();
#endif
  volatile const uint32_t* src = (state == SCAN_INCLUSIVE ? a.status.inclusive : a.status.aggregate) + slot * SCAN_MAX_LIMBS;
#pragma unroll
  for (int k = 0; k < L; ++k) v[k] = src[k];
  return state;
}

// Limb by limb: lane + d's value, or the lane's own past lane 31.
template <int L>
ZK_FN void shfl_down_limbs(uint32_t* dst, const uint32_t* src, uint32_t d, uint32_t lane) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j] = warp_shfl_down(src[j], d, lane);
}

// Limb by limb: lane `from`'s value.
template <int L>
ZK_FN void shfl_from_limbs(uint32_t* dst, const uint32_t* src, uint32_t from) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j] = warp_shfl(src[j], from);
}

// Whether a lane of the look-back may wait for a slot that is still empty.
// On the card it spins until the slot's block publishes.  The host build
// runs one block at a time, so a slot empty there stays empty: its shim
// records the fault and the lane goes on.
#if defined(__CUDA_ARCH__)
ZK_FN bool scan_wait() { return true; }
#else
bool scan_wait();
#endif

// Phase 4, the look-back, lane `lane` of warp 0 (every lane runs it), once
// the warp holds the tile's aggregate agg: lane 0 publishes it (tile 0: as
// its inclusive prefix; a grid of one tile a lane publishes nothing), and
// pre = the tile's exclusive prefix, in every lane (the identity in tile
// 0).  Each window of 32 predecessors, nearest first, is read one slot a
// lane; the lanes past the nearest inclusive prefix (the ballot's lowest
// lane) take the identity, the window is combined into lane 0 (5 shuffles
// down) and joins pre there; the walk stops at an inclusive prefix.  Then
// pre goes to every lane and lane 0 publishes the tile's inclusive prefix,
// pre (x) agg.  The aggregate's publication stays here, and the function is
// left to the compiler to inline: with the publication in a step of its
// own, ptxas gave the Fq sum's kernel 128 registers and spilled.
#if defined(__CUDACC__)
#define ZK_SCAN_LOOK_BACK_FN __device__
#else
#define ZK_SCAN_LOOK_BACK_FN inline
#endif
template <int L, int OP>
ZK_SCAN_LOOK_BACK_FN void scan_look_back(const ScanArgs& a, const ScanConsts<L>& c, const ScanBlock& b,
                                         uint32_t lane, const uint32_t* agg, uint32_t* pre) {
  copy_limbs<L>(pre, c.id);
  if (b.tile == 0) {
    if (lane == 0 && a.tiles > 1) scan_publish<L>(a, b, SCAN_INCLUSIVE, agg);
    return;
  }
  if (lane == 0) scan_publish<L>(a, b, SCAN_AGGREGATE, agg);
#pragma unroll 1
  for (int64_t top = b.tile - 1;; top -= 32) {
    uint32_t v[L], y[L];
    int state;
    do {
      state = scan_peek<L>(a, c, b, top - (int64_t)lane, v);
    } while (state == SCAN_EMPTY && top - (int64_t)lane >= 0 && scan_wait());
    const uint32_t inclusive = warp_ballot(state == SCAN_INCLUSIVE);
    const uint32_t nearest = inclusive ? lowest_lane(inclusive) : 32;
    if (lane > nearest) copy_limbs<L>(v, c.id);
#pragma unroll 1
    for (uint32_t d = 16; d >= 1; d >>= 1) {
      shfl_down_limbs<L>(y, v, d, lane);
      if (lane + d < 32) scan_op<L, OP>(v, v, y, c.f);
    }
    if (lane == 0) scan_op<L, OP>(pre, v, pre, c.f);
    if (inclusive) break;
  }
  shfl_from_limbs<L>(pre, pre, 0);
  if (lane == 0) {
    uint32_t v[L];
    scan_op<L, OP>(v, pre, agg, c.f);
    scan_publish<L>(a, b, SCAN_INCLUSIVE, v);
  }
}

// Phase 4, the end of the look-back in lane `lane` of warp 0: the prefix of
// warp `lane` (from the tile's exclusive prefix `pre`, the identity in tile
// 0, and the exclusive value `below` of the warp-total scan, ignored for
// lane 0).
template <int L, int OP>
ZK_FN void scan_warp_prefix(const ScanConsts<L>& c, const ScanBlock& b, uint32_t lane, const uint32_t* pre,
                            const uint32_t* below, uint32_t* out) {
  if (lane == 0) {
    copy_limbs<L>(out, pre);
  } else if (b.tile == 0) {
    copy_limbs<L>(out, below);
  } else {
    scan_op<L, OP>(out, pre, below, c.f);
  }
}

// Phase 4 in sum mode: the last tile's inclusive prefix is its column's total.
template <int L>
ZK_FN void scan_write_total(const ScanArgs& a, const ScanBlock& b, const uint32_t* v) {
  if (b.tile == a.tiles - 1) store_elem<L>(a.total + b.col * L, v);
}

// Phase 5: thread t's prefix (its warp's prefix, then the exclusive value
// `below` within the warp, ignored for lane 0), then its chunk's outputs.
template <int L, int OP>
ZK_FN void scan_chunk_write(const ScanArgs& a, const ScanConsts<L>& c, const ScanBlock& b, uint32_t t,
                            const uint32_t* warp_prefix, const uint32_t* below) {
  const int64_t r0 = scan_chunk_start(a, b, t), end = scan_chunk_end(a, r0);
  if (r0 >= a.n) return;
  uint32_t v[L];
  if (t % 32 == 0) {
    copy_limbs<L>(v, warp_prefix);
  } else {
    scan_op<L, OP>(v, warp_prefix, below, c.f);
  }
#pragma unroll 1
  for (int64_t r = r0; r < end; r += SCAN_LOADS) {
    uint32_t x[SCAN_LOADS][L];
    const int64_t k = end - r < SCAN_LOADS ? end - r : SCAN_LOADS;
    scan_load_rows<L>(a, b, r, k, x);
#pragma unroll
    for (int j = 0; j < SCAN_LOADS; ++j) {
      if (j < k) {
        scan_op<L, OP>(v, v, x[j], c.f);
        store_elem<L>(scan_out<L>(a, b, r + j), v);
      }
    }
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
