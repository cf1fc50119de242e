// Host build of the NTT kernels' per-block code, for the CPU tests
// (tests/test_torch_csrc_host.py): csrc/ntt.cuh, csrc/ntt_gl.cuh and
// csrc/fri_fold.cuh compile as C++ (the PTX carry chains emulated), and
// host_ntt runs each pass of the plan as the card runs it: every block
// (tile, row), and inside a block each phase for every thread in turn,
// which is what the barriers between the phases guarantee.  In both
// designs (ntt.cuh for Fr, ntt_gl.cuh for Goldilocks) the phases are the
// twiddle table's staging with the first step's loads, then one radix step
// after another, the last one storing, each thread keeping its registers
// from phase to phase.  The tests build it with small tiles and either
// radix (-DZK_NTT_RADIX2_WORK, -DZK_NTT_LOG_TILE, -DZK_NTT_LOG_COLS,
// -DZK_NTT_ONE_PASS, -DZK_NTT_LOG_MIN_THREADS for Fr;
// -DZK_NTT_GL_LOG_TILE, -DZK_NTT_GL_LOG_COLS, -DZK_NTT_GL_ONE_PASS,
// -DZK_NTT_GL_RADIX for Goldilocks) so that several passes and partial
// radix steps run at small n, and once with the library's own.  Also the
// Fr butterfly's lazy operations and products and the Goldilocks product
// against the canonical ones, and the FRI fold, element by element.  Not
// part of the port.
#include <vector>

#include "../zktpu_torch/csrc/fri_fold.cuh"
#include "../zktpu_torch/csrc/ntt.cuh"
#include "../zktpu_torch/csrc/ntt_gl.cuh"

template <int K>
static int run_fr_k(const FrConsts& f, const uint32_t* in, uint32_t* out, int64_t batch, int log_n,
                    const uint32_t* tw, const uint32_t* in_f, int64_t in_fs, const uint32_t* out_f, int64_t out_fs) {
  constexpr int E = (1 << K) * NTT_L;  // a thread's registers
  NttPass passes[NTT_MAX_PASSES];
  const int np = ntt_plan(log_n, K, passes);
  for (int k = 0; k < np; ++k) {
    NttArgs a{in, out, tw, in_f, out_f, (uint32_t)in_fs, (uint32_t)out_fs, log_n, passes[k], k == 0, k == np - 1};
    const uint32_t threads = ntt_threads(a.pass);
    std::vector<uint32_t> smem(ntt_smem_bytes(a.pass) / sizeof(uint32_t));
    std::vector<uint32_t> regs((size_t)threads * E);
    for (int64_t row = 0; row < batch; ++row) {
      for (uint32_t tile = 0; tile < ntt_tiles(a); ++tile) {
        for (uint32_t t = 0; t < threads; ++t)
          ntt_load_thread<K>(a, tile, (uint32_t)row, t, regs.data() + (size_t)t * E, smem.data(), f);
        for (int j = 0; j < ntt_steps(a.pass); ++j)
          for (uint32_t t = 0; t < threads; ++t)
            ntt_step_thread<K>(a, tile, (uint32_t)row, j, t, regs.data() + (size_t)t * E, smem.data(), f);
      }
    }
  }
  return np;
}

// Fr in the radix the plan takes for the call (ntt_radix_log).
static int run_fr(const uint32_t* p, uint32_t pinv, const uint32_t* in, uint32_t* out, int64_t batch, int log_n,
                  const uint32_t* tw, const uint32_t* in_f, int64_t in_fs, const uint32_t* out_f, int64_t out_fs) {
  const FrConsts f = make_consts<NTT_L>(p, pinv);
  if (ntt_radix_log(log_n, batch) == 1)
    return run_fr_k<1>(f, in, out, batch, log_n, tw, in_f, in_fs, out_f, out_fs);
  return run_fr_k<2>(f, in, out, batch, log_n, tw, in_f, in_fs, out_f, out_fs);
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
  if (limbs == 8) return run_fr(p, pinv, in, out, batch, log_n, tw, in_f, in_fs, out_f, out_fs);
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

// Fr's lazy operations, for n pairs of 8-word elements: op 0 field.cuh's
// product mont_mul_lazy(a, b) of a canonical a and a lazy b (< 2p), op 4
// the NTT's even/odd product ntt_mul(a, b), op 1 ntt_add_2p, op 2
// sub_red against 2p, op 3 the last store's canonicalization cond_sub(a,
// p), each of a < 2p (and b < 2p).
extern "C" void host_fr_lazy(const uint32_t* p, uint32_t pinv, const uint32_t* a, const uint32_t* b, uint32_t* out,
                             int64_t n, int op) {
  const FrConsts f = make_consts<NTT_L>(p, pinv);
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t *x = a + i * NTT_L, *y = b + i * NTT_L;
    uint32_t* r = out + i * NTT_L;
    if (op == 0) mont_mul_lazy<NTT_L>(r, x, y, f);
    if (op == 1) ntt_add_2p(r, x, y, f);
    if (op == 2) sub_red<NTT_L>(r, x, y, f.p2);
    if (op == 3) cond_sub<NTT_L>(r, x, f.p);
    if (op == 4) ntt_mul(r, x, y, f);
  }
}
