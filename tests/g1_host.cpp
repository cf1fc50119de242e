// Host build of the CUDA kernels' per-element code, for the CPU tests
// (tests/test_torch_csrc_host.py): field.cuh and g1.cuh compile as C++ with
// the PTX carry chains emulated, and these loops run what each CUDA thread
// runs (the Horner combine's warps with their shuffles emulated, below).
// Not part of the port.
#include <ucontext.h>

#include <functional>
#include <vector>

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

// A warp as the card runs it, for the Horner combine: its 32 lanes are
// fibers (ucontext) on this thread, each run in turn from one shuffle to the
// next, so every phase between two shuffles runs for every lane before any
// lane reads what the shuffle exchanges.  warp_shfl deposits the lane's value
// in a mailbox (two, used in turns, so a fast lane's next deposit never
// overwrites a value a slow lane has still to read) and yields; on its next
// turn the lane reads lane src's deposit.  Every lane must run as many
// shuffles: run() returns -1 if they do not.
namespace {

struct Warp {
  static constexpr size_t STACK = 256 << 10;
  ucontext_t sched, ctx[32];
  std::vector<char> stacks = std::vector<char>(32 * STACK);
  uint32_t box[2][32];
  int turn[32] = {}, shuffles[32] = {}, lane = 0;
  bool done[32] = {};
  std::function<void(uint32_t)> body;

  int run() {
    for (int l = 0; l < 32; ++l) {
      getcontext(&ctx[l]);
      ctx[l].uc_stack.ss_sp = stacks.data() + l * STACK;
      ctx[l].uc_stack.ss_size = STACK;
      ctx[l].uc_link = &sched;
      makecontext(&ctx[l], lane_main, 0);
    }
    for (bool any = true; any;) {
      any = false;
      for (int l = 0; l < 32; ++l)
        if (!done[l]) {
          lane = l;
          swapcontext(&sched, &ctx[l]);
          any = true;
        }
    }
    for (int l = 1; l < 32; ++l)
      if (shuffles[l] != shuffles[0]) return -1;
    return 0;
  }

  static void lane_main();
};

thread_local Warp* the_warp = nullptr;

void Warp::lane_main() {
  Warp& w = *the_warp;
  const int l = w.lane;
  w.body((uint32_t)l);
  w.done[l] = true;
}

// Runs body(lane) for the 32 lanes of one warp.
int run_warp(std::function<void(uint32_t)> body) {
  Warp w;
  w.body = std::move(body);
  Warp* outer = the_warp;
  the_warp = &w;
  const int rc = w.run();
  the_warp = outer;
  return rc;
}

}  // namespace

uint32_t warp_shfl(uint32_t v, uint32_t src) {
  Warp& w = *the_warp;
  const int l = w.lane, t = w.turn[l];
  w.box[t][l] = v;
  ++w.shuffles[l];
  swapcontext(&w.ctx[l], &w.sched);
  w.turn[l] ^= 1;
  return w.box[t][src & 31];
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
