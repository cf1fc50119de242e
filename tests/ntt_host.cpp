// Host build of the NTT kernels' per-block code, for the CPU tests
// (tests/test_torch_csrc_host.py): csrc/ntt.cuh, csrc/ntt_gl.cuh and
// csrc/fri_fold.cuh compile as C++ (the PTX carry chains emulated), and
// host_ntt runs each pass of the plan as the card runs it: every block
// (tile, row), and inside a block each phase for every thread in turn,
// which is what the barriers between the phases guarantee.  Fr's phases
// are the load, one stage after another and the store (ntt.cuh); the
// Goldilocks design's are the twiddle table with the first step's loads,
// then one radix step after another, each thread keeping its registers
// from phase to phase (ntt_gl.cuh).  The tests build it with small tiles
// (-DZK_NTT_LOG_TILE, -DZK_NTT_LOG_MIN_COLS, -DZK_NTT_THREADS for Fr;
// -DZK_NTT_GL_LOG_TILE, -DZK_NTT_GL_LOG_COLS, -DZK_NTT_GL_ONE_PASS,
// -DZK_NTT_GL_RADIX for Goldilocks) so that several passes and partial
// radix steps run at small n, and once with the library's own.  Also the
// Goldilocks product against fmul_wide and the FRI fold, element by
// element.  Not part of the port.
#include <vector>

#include "../zktpu_torch/csrc/fri_fold.cuh"
#include "../zktpu_torch/csrc/ntt.cuh"
#include "../zktpu_torch/csrc/ntt_gl.cuh"

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

static int run_gl(const uint64_t* in, uint64_t* out, int64_t batch, int log_n, const uint64_t* tw,
                  const uint64_t* in_f, int64_t in_fs, const uint64_t* out_f, int64_t out_fs) {
  GlPass passes[GL_MAX_PASSES];
  const int np = gl_ntt_plan(log_n, passes);
  for (int k = 0; k < np; ++k) {
    GlArgs a{in, out, tw, in_f, out_f, (uint32_t)in_fs, (uint32_t)out_fs, log_n, passes[k], k == 0, k == np - 1};
    const uint32_t threads = gl_threads(a.pass);
    std::vector<uint64_t> smem(gl_smem_words(a.pass));
    std::vector<uint64_t> regs((size_t)threads * GL_E);
    for (int64_t row = 0; row < batch; ++row) {
      for (uint32_t tile = 0; tile < gl_tiles(a); ++tile) {
        for (uint32_t t = 0; t < threads; ++t)
          gl_load_thread(a, tile, (uint32_t)row, t, regs.data() + (size_t)t * GL_E, smem.data());
        for (int j = 0; j < gl_steps(a.pass); ++j)
          for (uint32_t t = 0; t < threads; ++t)
            gl_step_thread(a, tile, (uint32_t)row, j, t, regs.data() + (size_t)t * GL_E, smem.data());
      }
    }
  }
  return np;
}

// The transform over a field of `limbs` words (8: Fr, 2: Goldilocks);
// returns the number of passes, or -1 for another width or plan.
extern "C" int host_ntt(int limbs, const uint32_t* p, uint32_t pinv, const uint32_t* in, uint32_t* out,
                        int64_t batch, int log_n, const uint32_t* tw, const uint32_t* in_f, int64_t in_fs,
                        const uint32_t* out_f, int64_t out_fs) {
  if (limbs == 8) return run<8>(p, pinv, in, out, batch, log_n, tw, in_f, in_fs, out_f, out_fs);
  if (limbs == 2) {
    auto w = [](const uint32_t* v) { return reinterpret_cast<const uint64_t*>(v); };
    return run_gl(w(in), reinterpret_cast<uint64_t*>(out), batch, log_n, w(tw), w(in_f), in_fs, w(out_f), out_fs);
  }
  return -1;
}

// Goldilocks products of n pairs of canonical words: gl_mul (wide = 0) or
// the two-limb CIOS product fmul_wide (wide = 1).
extern "C" void host_gl_mul(const uint32_t* p, uint32_t pinv, const uint64_t* a, const uint64_t* b, uint64_t* out,
                            int64_t n, int wide) {
  const FieldConsts<2> f = make_consts<2>(p, pinv);
  for (int64_t i = 0; i < n; ++i) {
    if (wide) {
      uint32_t x[2], y[2], r[2];
      gl_limbs(x, a[i]);
      gl_limbs(y, b[i]);
      fmul_wide<2>(r, x, y, f);
      out[i] = gl_word(r);
    } else {
      out[i] = gl_mul(a[i], b[i]);
    }
  }
}

// The FRI fold of n coefficients by the Montgomery word r, output by output.
extern "C" void host_fri_fold(const uint64_t* c, int64_t n, uint64_t r, uint64_t* out) {
  for (int64_t i = 0; i < (n + 1) / 2; ++i) out[i] = fri_fold_at(c, n, r, i);
}
