// Host build of kernels A and B of csrc/field_ops.cu, for the CPU tests
// (tests/test_torch_csrc_host.py): csrc/field_ops.cuh compiles as C++ with
// the PTX carry chains emulated, and the entry points below take the same
// arguments as the library's (device and stream ignored, pointers to host
// memory), so the port's own wrappers drive them through the same passes.
// Each block of field_scan_kernel runs here as the card runs it: every phase
// for every thread in turn (what the barriers guarantee), the warp shuffles
// read from a copy of the lanes' values taken before each step.  The tests
// build it with few threads a block (-DZK_SCAN_THREADS) so that small inputs
// take several tiles and several warps.  Not part of the port.
#include <vector>

#include "../zktpu_torch/csrc/field_ops.cuh"

template <int L, int OP>
static void scan_block_host(const ScanArgs& a, const ScanConsts<L>& c, const ScanBlock& b) {
  using Row = std::vector<uint32_t>;
  std::vector<Row> v(SCAN_THREADS, Row(L)), below(SCAN_THREADS, Row(L));
  std::vector<uint32_t> s_warp(SCAN_WARPS * L);
  for (uint32_t t = 0; t < SCAN_THREADS; ++t) scan_chunk_total<L, OP>(a, c, b, t, v[t].data());  // 1
  for (uint32_t d = 1; d < 32; d <<= 1) {  // 2: __shfl_up_sync(v, d) reads the lanes' values before the step
    const std::vector<Row> before = v;
    for (uint32_t t = 0; t < SCAN_THREADS; ++t) {
      const uint32_t lane = t % 32;
      scan_lane_step<L, OP>(v[t].data(), before[lane >= d ? t - d : t].data(), lane >= d, c.f);
    }
  }
  for (uint32_t t = 0; t < SCAN_THREADS; ++t) below[t] = v[t % 32 ? t - 1 : t];
  for (uint32_t t = 31; t < SCAN_THREADS; t += 32) copy_limbs<L>(s_warp.data() + t / 32 * L, v[t].data());  // 3
  std::vector<Row> w(32, Row(L)), y(32, Row(L));  // 4: warp 0
  for (uint32_t lane = 0; lane < 32; ++lane) scan_warp0_load<L>(c, lane, s_warp.data(), w[lane].data());
  for (uint32_t d = 1; d < 32; d <<= 1) {
    const std::vector<Row> before = w;
    for (uint32_t lane = 0; lane < 32; ++lane)
      scan_lane_step<L, OP>(w[lane].data(), before[lane >= d ? lane - d : lane].data(), lane >= d, c.f);
  }
  if (a.mode == SCAN_MODE_REDUCE) {
    copy_limbs<L>(scan_total_slot<L>(a, b), w[SCAN_WARPS - 1].data());
    return;
  }
  for (uint32_t lane = 0; lane < 32; ++lane) y[lane] = w[lane ? lane - 1 : 0];
  for (uint32_t lane = 0; lane < 32; ++lane) {
    scan_warp_prefix<L, OP>(a, c, b, lane, y[lane].data(), w[lane].data());
    if (lane < SCAN_WARPS) copy_limbs<L>(s_warp.data() + lane * L, w[lane].data());
  }
  for (uint32_t t = 0; t < SCAN_THREADS; ++t)  // 5
    scan_chunk_write<L, OP>(a, c, b, t, s_warp.data() + t / 32 * L, below[t].data());
}

template <int L>
static int scan_host(const uint32_t* p, uint32_t pinv, const uint32_t* ident, int op, const ScanArgs& a) {
  ScanConsts<L> c;
  c.f = make_consts<L>(p, pinv);
  for (int j = 0; j < L; ++j) c.id[j] = ident[j];
  const int64_t tiles = (a.n + SCAN_THREADS * a.chunk - 1) / (SCAN_THREADS * a.chunk);
  for (int z = 0; z < scan_dirs_count(a.dirs); ++z)
    for (int64_t col = 0; col < a.B; ++col)
      for (int64_t tile = 0; tile < tiles; ++tile) {
        const ScanBlock b = scan_block(a, tile, col, z);
        if (op == SCAN_OP_MUL) {
          scan_block_host<L, SCAN_OP_MUL>(a, c, b);
        } else {
          scan_block_host<L, SCAN_OP_ADD>(a, c, b);
        }
      }
  return 0;
}

extern "C" int zk_field_scan(int, int limbs, const uint32_t* p, uint32_t pinv, const uint32_t* ident, int op,
                             int mode, const void* in, int64_t in_rs, int64_t in_cs, int64_t n, int64_t B,
                             int64_t chunk, int dirs, void* out_fwd, void* out_rev, int64_t out_rs, int64_t out_cs,
                             void* totals, const void* carry, void*) {
  if (n < 1 || B < 1 || B > 65535 || chunk < 1 || dirs < 1 || dirs > 3) return -1;
  ScanArgs a{static_cast<const uint32_t*>(in), in_rs, in_cs, static_cast<uint32_t*>(out_fwd),
             static_cast<uint32_t*>(out_rev), out_rs, out_cs, static_cast<uint32_t*>(totals),
             static_cast<const uint32_t*>(carry), n, B, chunk, dirs, mode};
  switch (limbs) {
    case 2:
      return scan_host<2>(p, pinv, ident, op, a);
    case 8:
      return scan_host<8>(p, pinv, ident, op, a);
    case 12:
      return scan_host<12>(p, pinv, ident, op, a);
    default:
      return -1;
  }
}

extern "C" int zk_field_scan_threads() { return (int)SCAN_THREADS; }

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
