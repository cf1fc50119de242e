// Host build of kernels A and B of csrc/field_ops.cu, for the CPU tests
// (tests/test_torch_csrc_host.py): csrc/field_ops.cuh compiles as C++ with
// the PTX carry chains emulated, and the entry points below take the same
// arguments as the library's (device and stream ignored, pointers to host
// memory), so the port's own wrappers drive them, status buffer, tickets and
// epochs included.  Each block of field_scan_kernel runs here as the card
// runs it: every phase for every thread in turn (what the barriers
// guarantee); in phases 1-3 and warp 0's scan of the warp totals the
// shuffles are read from a copy of the lanes' values taken before each
// step, and the look-back is the kernel's own code (scan_look_back) run by
// warp 0's 32 lanes as fibers, its ballot and shuffles exchanged between
// them and its waits for other blocks' slots yielding to them
// (warp_host.h).  Blocks take their tickets in order, in one of two
// schedules (host_scan_schedule): 0 runs each block whole, so every
// look-back finds its predecessor's inclusive prefix; 1 runs phases 1-3 of
// every block, then the look-backs of all at once, their fibers in turn
// from the last ticket to the first, so each block publishes its aggregate
// before its predecessors have, and the look-backs combine aggregates back
// to tile 0 (across windows of 32 past 32 tiles) or to an inclusive prefix
// that a shorter walk has published.  The tests build it with few threads
// a block (-DZK_SCAN_THREADS) so that small inputs take many tiles and
// several warps.  Not part of the port.
#include <vector>

#include "../zktpu_torch/csrc/field_ops.cuh"
#include "warp_host.h"

static int schedule = 0;
static bool waited = false;  // a look-back met a slot that stayed empty

// 0: blocks whole, in ticket order; 1: phases 1-3 of every block, then the
// look-backs of all at once, from the last ticket to the first.
extern "C" void host_scan_schedule(int s) { schedule = s; }

bool scan_wait() {
  if (warp_wait()) return true;
  waited = true;
  return false;
}

using Row = std::vector<uint32_t>;

// What one block holds from its warp-total scan to its writes.
struct BlockState {
  ScanBlock b;
  std::vector<Row> below;      // each thread's exclusive value within its warp
  std::vector<Row> warp_excl;  // warp 0, lane i: the warps before warp i
  Row agg;
  std::vector<Row> pre;        // warp 0, each lane's result of the look-back
};

// Phases 1-3 and warp 0's scan of the warp totals.
template <int L, int OP>
static BlockState scan_block_start(const ScanArgs& a, const ScanConsts<L>& c, const ScanBlock& b) {
  std::vector<Row> v(SCAN_THREADS, Row(L));
  std::vector<uint32_t> s_warp(SCAN_WARPS * L);
  BlockState st{b, std::vector<Row>(SCAN_THREADS, Row(L)), std::vector<Row>(32, Row(L)), Row(L),
                std::vector<Row>(32, Row(L))};
  for (uint32_t t = 0; t < SCAN_THREADS; ++t) scan_chunk_total<L, OP>(a, c, b, t, v[t].data());  // 1
  for (uint32_t d = 1; d < 32; d <<= 1) {  // 2: __shfl_up_sync(v, d) reads the lanes' values before the step
    const std::vector<Row> before = v;
    for (uint32_t t = 0; t < SCAN_THREADS; ++t) {
      const uint32_t lane = t % 32;
      scan_lane_step<L, OP>(v[t].data(), before[lane >= d ? t - d : t].data(), lane >= d, c.f);
    }
  }
  for (uint32_t t = 0; t < SCAN_THREADS; ++t) st.below[t] = v[t % 32 ? t - 1 : t];
  for (uint32_t t = 31; t < SCAN_THREADS; t += 32) copy_limbs<L>(s_warp.data() + t / 32 * L, v[t].data());  // 3
  std::vector<Row> w(32, Row(L));  // 4: warp 0
  for (uint32_t lane = 0; lane < 32; ++lane) scan_warp0_load<L>(c, lane, s_warp.data(), w[lane].data());
  for (uint32_t d = 1; d < 32; d <<= 1) {
    const std::vector<Row> before = w;
    for (uint32_t lane = 0; lane < 32; ++lane)
      scan_lane_step<L, OP>(w[lane].data(), before[lane >= d ? lane - d : lane].data(), lane >= d, c.f);
  }
  for (uint32_t lane = 0; lane < 32; ++lane) st.warp_excl[lane] = w[lane ? lane - 1 : 0];
  st.agg = w[SCAN_WARPS - 1];
  return st;
}

// Warp 0's look-back of the blocks `sts`, the warps at once (the kernel's
// scan_look_back; warp k is block sts[k]).  Returns -2 if a slot stayed
// empty, -1 if the lanes' exchanges differ or stall.
template <int L, int OP>
static int scan_look_backs(const ScanArgs& a, const ScanConsts<L>& c, std::vector<BlockState*> sts) {
  waited = false;
  const int rc = run_warps((uint32_t)sts.size(), [&](uint32_t w, uint32_t lane) {
    scan_look_back<L, OP>(a, c, sts[w]->b, lane, sts[w]->agg.data(), sts[w]->pre[lane].data());
  });
  return rc ? rc : waited ? -2 : 0;
}

// The rest of phase 4 and phase 5.  Returns -1 if the lanes' prefixes differ.
template <int L, int OP>
static int scan_block_finish(const ScanArgs& a, const ScanConsts<L>& c, const BlockState& st) {
  const ScanBlock& b = st.b;
  for (const Row& p : st.pre)
    if (p != st.pre[0]) return -1;
  const Row& pre = st.pre[0];
  if (a.mode == SCAN_MODE_SUM) {
    Row total(L);
    scan_op<L, OP>(total.data(), pre.data(), st.agg.data(), c.f);
    scan_write_total<L>(a, b, total.data());
    return 0;
  }
  std::vector<uint32_t> s_warp(SCAN_WARPS * L);
  for (uint32_t lane = 0; lane < SCAN_WARPS; ++lane)
    scan_warp_prefix<L, OP>(c, b, lane, pre.data(), st.warp_excl[lane].data(), s_warp.data() + lane * L);
  for (uint32_t t = 0; t < SCAN_THREADS; ++t)  // 5
    scan_chunk_write<L, OP>(a, c, b, t, s_warp.data() + t / 32 * L, st.below[t].data());
  return 0;
}

template <int L, int OP>
static int scan_host(const ScanConsts<L>& c, const ScanArgs& a, int64_t blocks) {
  std::vector<BlockState> states;
  for (int64_t k = 0; k < blocks; ++k) {
    const int64_t id = a.tiles == 1 ? k : (int64_t)((*a.status.ticket)++ - a.ticket_base);  // the block's ticket
    states.push_back(scan_block_start<L, OP>(a, c, scan_block(a, id)));
    if (schedule == 0) {
      if (const int rc = scan_look_backs<L, OP>(a, c, {&states.back()})) return rc;
      if (const int rc = scan_block_finish<L, OP>(a, c, states.back())) return rc;
      states.clear();
    }
  }
  if (states.empty()) return 0;
  std::vector<BlockState*> last_first;
  for (auto it = states.rbegin(); it != states.rend(); ++it) last_first.push_back(&*it);
  if (const int rc = scan_look_backs<L, OP>(a, c, last_first)) return rc;
  for (const BlockState& st : states)
    if (const int rc = scan_block_finish<L, OP>(a, c, st)) return rc;
  return 0;
}

template <int L>
static int scan_width(const uint32_t* p, uint32_t pinv, const uint32_t* ident, int op, const ScanArgs& a,
                      int64_t blocks) {
  ScanConsts<L> c;
  c.f = make_consts<L>(p, pinv);
  for (int j = 0; j < L; ++j) c.id[j] = ident[j];
  return op == SCAN_OP_MUL ? scan_host<L, SCAN_OP_MUL>(c, a, blocks) : scan_host<L, SCAN_OP_ADD>(c, a, blocks);
}

extern "C" int zk_field_scan(int, int limbs, const uint32_t* p, uint32_t pinv, const uint32_t* ident, int op,
                             int mode, const void* in, int64_t in_rs, int64_t in_cs, int64_t n, int64_t B,
                             int64_t chunk, int dirs, void* out_fwd, void* out_rev, int64_t out_rs, int64_t out_cs,
                             void* total, void* status, int64_t status_slots, uint64_t ticket_base, uint32_t epoch,
                             void*) {
  if (n < 1 || B < 1 || chunk < 1 || dirs < 1 || dirs > 3 || epoch < 1 || epoch >= (1u << 30)) return -1;
  if (mode == SCAN_MODE_SUM ? total == nullptr || dirs != SCAN_FORWARD : mode != SCAN_MODE_SCAN) return -1;
  const int64_t tiles = (n + SCAN_THREADS * chunk - 1) / (SCAN_THREADS * chunk);
  const int64_t blocks = tiles * scan_dirs_count(dirs) * B;
  if (blocks > status_slots || *scan_status(static_cast<uint32_t*>(status), status_slots).ticket != ticket_base)
    return -1;
  ScanArgs a{static_cast<const uint32_t*>(in), in_rs, in_cs, static_cast<uint32_t*>(out_fwd),
             static_cast<uint32_t*>(out_rev), out_rs, out_cs, static_cast<uint32_t*>(total),
             scan_status(static_cast<uint32_t*>(status), status_slots), ticket_base, n, B, chunk, tiles, epoch,
             dirs, mode};
  switch (limbs) {
    case 2:
      return scan_width<2>(p, pinv, ident, op, a, blocks);
    case 8:
      return scan_width<8>(p, pinv, ident, op, a, blocks);
    case 12:
      return scan_width<12>(p, pinv, ident, op, a, blocks);
    default:
      return -1;
  }
}

extern "C" int zk_field_scan_threads() { return (int)SCAN_THREADS; }

extern "C" int zk_field_scan_status_words(int64_t slots, int64_t* out) {
  *out = scan_status_words(slots);
  return 0;
}

template <int L>
static int powers_host(const uint32_t* p, uint32_t pinv, const uint32_t* one, const uint32_t* table, uint32_t* out,
                       int64_t count, int64_t chunk) {
  ScanConsts<L> c;
  c.f = make_consts<L>(p, pinv);
  for (int j = 0; j < L; ++j) c.id[j] = one[j];
  PowTable<L> tab;
  for (int j = 0; j < 32; ++j)
    for (int k = 0; k < L; ++k) tab.z2[j][k] = table[j * L + k];
  for (int64_t g = 0; g * chunk < count; ++g) powers_thread<L>(out, count, chunk, c, tab, g);
  return 0;
}

extern "C" int zk_field_powers(int, int limbs, const uint32_t* p, uint32_t pinv, const uint32_t* one,
                               const uint32_t* table, void* out, int64_t count, int64_t chunk, void*) {
  if (count < 1 || chunk < 1) return -1;
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (limbs) {
    case 2:
      return powers_host<2>(p, pinv, one, table, o, count, chunk);
    case 8:
      return powers_host<8>(p, pinv, one, table, o, count, chunk);
    case 12:
      return powers_host<12>(p, pinv, one, table, o, count, chunk);
    default:
      return -1;
  }
}

template <int L>
static int batch_inv_host(const uint32_t* p, uint32_t pinv, const uint32_t* one, const uint32_t* inv,
                          const uint32_t* P, const uint32_t* S, uint32_t* out, int64_t n) {
  ScanConsts<L> c;
  c.f = make_consts<L>(p, pinv);
  for (int j = 0; j < L; ++j) c.id[j] = one[j];
  for (int64_t i = 0; i < n; ++i) batch_inv_row<L>(P, S, out, n, i, c, inv);
  return 0;
}

extern "C" int zk_field_batch_inv(int, int limbs, const uint32_t* p, uint32_t pinv, const uint32_t* one,
                                  const uint32_t* inv, const void* P, const void* S, void* out, int64_t n, void*) {
  if (n < 1) return -1;
  const uint32_t *x = static_cast<const uint32_t*>(P), *y = static_cast<const uint32_t*>(S);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (limbs) {
    case 2:
      return batch_inv_host<2>(p, pinv, one, inv, x, y, o, n);
    case 8:
      return batch_inv_host<8>(p, pinv, one, inv, x, y, o, n);
    case 12:
      return batch_inv_host<12>(p, pinv, one, inv, x, y, o, n);
    default:
      return -1;
  }
}

template <int L>
static int addsub_host(const uint32_t* p, uint32_t pinv, int op, const uint32_t* a, int64_t na, const uint32_t* b,
                       int64_t nb, uint32_t* out, int64_t n) {
  const FieldConsts<L> f = make_consts<L>(p, pinv);
  for (int64_t i = 0; i < n; ++i) {
    if (op == FIELD_ADD) {
      addsub_row<L, FIELD_ADD>(a, na, b, nb, out, n, i, f);
    } else {
      addsub_row<L, FIELD_SUB>(a, na, b, nb, out, n, i, f);
    }
  }
  return 0;
}

extern "C" int zk_field_addsub(int, int limbs, const uint32_t* p, uint32_t pinv, int op, const void* a, int64_t na,
                               const void* b, int64_t nb, void* out, int64_t n, void*) {
  if (n < 1 || na < 1 || nb < 1 || (op != FIELD_ADD && op != FIELD_SUB)) return -1;
  const uint32_t *x = static_cast<const uint32_t*>(a), *y = static_cast<const uint32_t*>(b);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (limbs) {
    case 2:
      return addsub_host<2>(p, pinv, op, x, na, y, nb, o, n);
    case 8:
      return addsub_host<8>(p, pinv, op, x, na, y, nb, o, n);
    case 12:
      return addsub_host<12>(p, pinv, op, x, na, y, nb, o, n);
    default:
      return -1;
  }
}
