// Host build of the CUDA kernels' per-element code, for the CPU tests
// (tests/test_torch_csrc_host.py): field.cuh and g1.cuh compile as C++ with
// the PTX carry chains emulated, and these loops run what each CUDA thread
// runs.  Not part of the port.
#include "../zktpu_torch/csrc/g1.cuh"

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

// ptrs = X, Y, Z of the table, the scalars, X, Y, Z of the result (zk_fixed_base_mul's).
extern "C" void host_fixed_base_mul(const uint32_t* p, uint32_t pinv, const int64_t* ptrs, int64_t n, int window) {
  FixedBaseArgs a;
  for (int k = 0; k < 3; ++k) {
    a.table[k] = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(ptrs[k]));
    a.out[k] = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(ptrs[4 + k]));
  }
  a.scalars = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(ptrs[3]));
  a.n = (uint32_t)n;
  a.window = (uint32_t)window;
  a.windows = 256u / (uint32_t)window;
  const FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  for (int64_t i = 0; i < n; ++i) fixed_base_at(a, (uint32_t)i, f);
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

// The Horner combine as the kernel runs it: one block of HORNER_GROUPS
// groups of HORNER_LANES lanes after another, each phase of the schedule
// run by every lane in turn (the warp barrier between phases).  ptrs: X, Y,
// Z of the (W, K, 12) parts, then X, Y, Z of the (K, 12) output.
extern "C" void host_horner_combine(const uint32_t* p, uint32_t pinv, const int64_t* ptrs, int64_t W, int64_t K,
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
  for (uint32_t block = 0; block * HORNER_GROUPS < a.K; ++block) {
    HornerGroup groups[HORNER_GROUPS];
    horner_schedule(
        [&](int phase, uint32_t w) {
          for (uint32_t t = 0; t < HORNER_THREADS; ++t) {
            const uint32_t g = t / HORNER_LANES, kk = block * HORNER_GROUPS + g;
            horner_phase(phase, groups[g], t % HORNER_LANES, a, kk < a.K ? kk : a.K - 1, kk < a.K, w, f);
          }
        },
        a.W, a.c);
  }
}
