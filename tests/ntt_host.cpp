// Host build of the NTT kernel's per-block code, for the CPU tests
// (tests/test_torch_csrc_host.py): csrc/ntt.cuh compiles as C++ with the PTX
// carry chains emulated, and host_ntt_fr runs each pass of ntt.cu's plan as
// the card runs it: every block (tile, row), and inside a block each phase
// (load, one stage after another, store) for every thread in turn, which is
// what the barriers between the phases guarantee.  The tests build it with
// small tiles (-DZK_NTT_LOG_TILE, -DZK_NTT_LOG_MIN_COLS, -DZK_NTT_THREADS)
// so that several passes run at small n, and once with the library's own.
// Not part of the port.
#include <vector>

#include "../zktpu_torch/csrc/ntt.cuh"

extern "C" int host_ntt_fr(const uint32_t* p, uint32_t pinv, const uint32_t* in, uint32_t* out, int64_t batch,
                           int log_n, const uint32_t* tw, const uint32_t* in_f, int64_t in_fs,
                           const uint32_t* out_f, int64_t out_fs) {
  const FrConsts f = make_consts<FR_LIMBS>(p, pinv);
  NttPass passes[NTT_MAX_PASSES];
  const int np = ntt_plan(log_n, passes);
  for (int k = 0; k < np; ++k) {
    NttArgs a{in, out, tw, in_f, out_f, (uint32_t)in_fs, (uint32_t)out_fs, log_n, passes[k], k == 0, k == np - 1};
    const uint32_t tiles = 1u << (log_n - a.pass.ns - a.pass.log_cols);
    std::vector<uint32_t> sm((size_t)ntt_tile_elems(a.pass) * FR_LIMBS);
    for (int64_t row = 0; row < batch; ++row) {
      for (uint32_t tile = 0; tile < tiles; ++tile) {
        for (uint32_t t = 0; t < NTT_THREADS; ++t) ntt_load_thread(a, tile, (uint32_t)row, t, sm.data(), f);
        for (int r = 1; r <= a.pass.ns; ++r)
          for (uint32_t t = 0; t < NTT_THREADS; ++t) ntt_stage_thread(a, tile, r, t, sm.data(), f);
        for (uint32_t t = 0; t < NTT_THREADS; ++t) ntt_store_thread(a, tile, (uint32_t)row, t, sm.data(), f);
      }
    }
  }
  return np;
}
