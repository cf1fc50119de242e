// Host build of the NTT kernel's per-block code, for the CPU tests
// (tests/test_torch_csrc_host.py): csrc/ntt.cuh compiles as C++ with the PTX
// carry chains emulated, and host_ntt runs each pass of ntt.cu's plan as
// the card runs it: every block (tile, row), and inside a block each phase
// (load, one stage after another, store) for every thread in turn, which is
// what the barriers between the phases guarantee.  The tests build it with
// small tiles (-DZK_NTT_LOG_TILE, -DZK_NTT_LOG_MIN_COLS, their _L2
// counterparts for Goldilocks, -DZK_NTT_THREADS) so that several passes run
// at small n, and once with the library's own.  Not part of the port.
#include <vector>

#include "../zktpu_torch/csrc/ntt.cuh"

template <int L>
static int run(const uint32_t* p, uint32_t pinv, const uint32_t* in, uint32_t* out, int64_t batch, int log_n,
               const uint32_t* tw, const uint32_t* in_f, int64_t in_fs, const uint32_t* out_f, int64_t out_fs) {
  const FieldConsts<L> f = make_consts<L>(p, pinv);
  NttPass passes[NTT_MAX_PASSES];
  const int np = ntt_plan<L>(log_n, passes);
  for (int k = 0; k < np; ++k) {
    NttArgs a{in, out, tw, in_f, out_f, (uint32_t)in_fs, (uint32_t)out_fs, log_n, passes[k], k == 0, k == np - 1};
    const uint32_t tiles = 1u << (log_n - a.pass.ns - a.pass.log_cols);
    std::vector<uint32_t> sm((size_t)ntt_tile_elems(a.pass) * L);
    for (int64_t row = 0; row < batch; ++row) {
      for (uint32_t tile = 0; tile < tiles; ++tile) {
        for (uint32_t t = 0; t < NTT_THREADS; ++t) ntt_load_thread<L>(a, tile, (uint32_t)row, t, sm.data(), f);
        for (int r = 1; r <= a.pass.ns; ++r)
          for (uint32_t t = 0; t < NTT_THREADS; ++t) ntt_stage_thread<L>(a, tile, r, t, sm.data(), f);
        for (uint32_t t = 0; t < NTT_THREADS; ++t) ntt_store_thread<L>(a, tile, (uint32_t)row, t, sm.data(), f);
      }
    }
  }
  return np;
}

// The transform over a field of `limbs` words (8: Fr, 2: Goldilocks);
// returns the number of passes, or -1 for another width.
extern "C" int host_ntt(int limbs, const uint32_t* p, uint32_t pinv, const uint32_t* in, uint32_t* out,
                        int64_t batch, int log_n, const uint32_t* tw, const uint32_t* in_f, int64_t in_fs,
                        const uint32_t* out_f, int64_t out_fs) {
  if (limbs == 8) return run<8>(p, pinv, in, out, batch, log_n, tw, in_f, in_fs, out_f, out_fs);
  if (limbs == 2) return run<2>(p, pinv, in, out, batch, log_n, tw, in_f, in_fs, out_f, out_fs);
  return -1;
}
