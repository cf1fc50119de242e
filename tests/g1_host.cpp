// Host build of the CUDA kernels' per-element code, for the CPU tests
// (tests/test_torch_csrc_host.py): field.cuh and g1.cuh compile as C++ with
// the PTX carry chains emulated, and these loops run what each CUDA thread
// runs (the Horner combine's warps as fibers, warp_host.h).
// Not part of the port.
#include <vector>

#include "../zktpu_torch/csrc/g1.cuh"
#include "warp_host.h"

template <int N>
static Planes<N> planes_of(const int64_t* desc) {
  Planes<N> pl;
  for (int k = 0; k < N; ++k) {
    pl.p[k].ptr = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(desc[3 * k]));
    pl.p[k].so = (uint32_t)desc[3 * k + 1];
    pl.p[k].si = (uint32_t)desc[3 * k + 2];
  }
  return pl;
}

extern "C" void host_proj_add(const uint32_t* p, uint32_t pinv, const int64_t* planes, int64_t n,
                              int64_t inner) {
  const Planes<9> pl = planes_of<9>(planes);
  const FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  for (int64_t i = 0; i < n; ++i) proj_add_at(pl, (uint32_t)(i / inner), (uint32_t)(i % inner), f);
}

extern "C" void host_proj_madd(const uint32_t* p, uint32_t pinv, const int64_t* planes, int64_t n,
                               int64_t inner) {
  const Planes<8> pl = planes_of<8>(planes);
  const FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  for (int64_t i = 0; i < n; ++i) proj_madd_at(pl, (uint32_t)(i / inner), (uint32_t)(i % inner), f);
}

extern "C" void host_proj_double(const uint32_t* p, uint32_t pinv, const int64_t* planes, int64_t n,
                                 int64_t inner) {
  const Planes<6> pl = planes_of<6>(planes);
  const FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  for (int64_t i = 0; i < n; ++i) proj_double_at(pl, (uint32_t)(i / inner), (uint32_t)(i % inner), f);
}

// ptrs = X, Y of the table, the scalars, X, Y, Z of the result
// (zk_fixed_base_mul's).  Each block runs as the kernel runs it: between two
// of its barriers every thread's step in turn, in a buffer laid out as its
// shared memory (the copy of window w + 1 lands before the adds of window
// w, into the other buffer, as cp.async may).
extern "C" int host_fixed_base_mul(const uint32_t* p, uint32_t pinv, const int64_t* ptrs, int64_t n, int window) {
  if (window < 1 || window > (int)FB_MAX_WINDOW || 32 % window) return -1;
  FixedBaseArgs a;
  for (int k = 0; k < 2; ++k) a.table[k] = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(ptrs[k]));
  a.scalars = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(ptrs[2]));
  for (int k = 0; k < 3; ++k) a.out[k] = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(ptrs[3 + k]));
  a.n = (uint32_t)n;
  a.window = (uint32_t)window;
  a.windows = 256u / (uint32_t)window;
  const FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  std::vector<uint32_t> smem(fb_shared_words(a.window));
  const FbShared s = fb_shared(smem.data(), a.window);
  for (uint32_t block = 0; block * FB_THREADS < a.n; ++block) {
    for (uint32_t t = 0; t < FB_THREADS; ++t) fb_stage(a, s, 0, 0, t);
    for (uint32_t t = 0; t < FB_THREADS; ++t) fb_begin(a, s, block * FB_THREADS + t, t);
    for (uint32_t w = 0; w < a.windows; ++w) {
      if (w + 1 < a.windows)
        for (uint32_t t = 0; t < FB_THREADS; ++t) fb_stage(a, s, w + 1, (w + 1) & 1, t);
      for (uint32_t t = 0; t < FB_THREADS; ++t)
        if (block * FB_THREADS + t < a.n) fb_add(a, s, w, w & 1, t, f);
    }
    for (uint32_t t = 0; t < FB_THREADS; ++t)
      if (block * FB_THREADS + t < a.n) fb_end(a, s, block * FB_THREADS + t, t);
  }
  return 0;
}

// The canonical product (kernel 1's body, lazy = 0) or the lazy product
// (lazy = 1), row by row.
template <int L>
static void mul_rows(const uint32_t* p, uint32_t pinv, const uint32_t* a, const uint32_t* b,
                     uint32_t* out, int64_t n, int lazy) {
  const FieldConsts<L> f = make_consts<L>(p, pinv);
  for (int64_t i = 0; i < n; ++i) {
    if (lazy)
      mont_mul_lazy<L>(out + i * L, a + i * L, b + i * L, f);
    else
      fmul<L>(out + i * L, a + i * L, b + i * L, f);
  }
}

extern "C" int host_mont_mul(int limbs, const uint32_t* p, uint32_t pinv, const uint32_t* a,
                             const uint32_t* b, uint32_t* out, int64_t n, int lazy) {
  switch (limbs) {
    case 2: mul_rows<2>(p, pinv, a, b, out, n, 0); return 0;
    case 8: mul_rows<8>(p, pinv, a, b, out, n, lazy); return 0;
    case 12: mul_rows<12>(p, pinv, a, b, out, n, lazy); return 0;
    default: return -1;
  }
}

// The Horner combine as the kernel runs it: one warp a point, one after
// another.  ptrs: X, Y, Z of the (W, K, 12) parts, then X, Y, Z of the
// (K, 12) output.  Returns 0, or -1 if the lanes' shuffles differ.
extern "C" int host_horner_combine(const uint32_t* p, uint32_t pinv, const int64_t* ptrs, int64_t W, int64_t K,
                                   int64_t c) {
  HornerArgs a;
  for (int i = 0; i < 3; ++i) {
    a.parts[i] = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(ptrs[i]));
    a.out[i] = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(ptrs[3 + i]));
  }
  a.W = (uint32_t)W;
  a.K = (uint32_t)K;
  a.c = (uint32_t)c;
  const FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  for (uint32_t k = 0; k < a.K; ++k)
    if (run_warp([&](uint32_t lane) { horner_point(a, k, lane, f); })) return -1;
  return 0;
}

// zk_horner_mul_chain's warp: ptrs = a, b, out (rows of 12 words).
extern "C" int host_horner_mul_chain(const uint32_t* p, uint32_t pinv, const int64_t* ptrs, int64_t chain) {
  const uint32_t* x[3];
  for (int i = 0; i < 3; ++i) x[i] = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(ptrs[i]));
  const FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  return run_warp([&](uint32_t lane) { horner_mul_chain(x[0], x[1], const_cast<uint32_t*>(x[2]), (uint32_t)chain, lane, f); });
}
