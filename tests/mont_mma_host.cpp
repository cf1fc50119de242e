// Host build of kernels 5m and 5f's per-warpgroup code
// (zktpu_torch/csrc/mont_mma.cuh), for the CPU tests
// (tests/test_torch_csrc_host.py).  A block's warpgroup runs as 128
// threads, each running mma_chain_wg for its thread index as the CUDA
// thread does, on a block's shared memory staged by the header's own
// mma_stage; wg_bar() is a barrier of the 128, and host_wgmma() gathers
// the 128 threads' accumulators and A fragments, rebuilds A (64 x 32), B
// (32 x N) and D (64 x N) by the PTX ISA's layouts for wgmma.mma_async
// m64nNk32 with .u8 operands and .s32 accumulators (A's and D's register
// fragments; B through the shared-memory matrix descriptor without
// swizzle: start address, leading and stride byte offsets), multiplies
// with plain loops and hands each thread its fragment of D.  So the
// kernel's operand rows, descriptors, core-matrix offsets, accumulator
// pairs and carries are held against the plain versions on the CPU.  Not
// part of the port.
#include <condition_variable>
#include <cstdlib>
#include <mutex>
#include <thread>
#include <vector>

#include "../zktpu_torch/csrc/mont_mma.cuh"

namespace {

constexpr int WG = 128;

struct Group {
  std::mutex mu;
  std::condition_variable cv;
  int waiting = 0;
  long generation = 0;
  const uint8_t* smem = nullptr;
  uint32_t d[WG][48], a[WG][4];
  uint64_t db[WG];
  int n[WG], scale[WG];
  bool fault = false;

  void barrier() {
    std::unique_lock<std::mutex> lock(mu);
    const long gen = generation;
    if (++waiting == WG) {
      waiting = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return generation != gen; });
    }
  }
};

thread_local Group* the_group = nullptr;
thread_local int the_tid = 0;
thread_local const uint8_t* the_smem = nullptr;

// The operand byte at (row r, byte k) of a descriptor's matrix, by the PTX
// ISA's canonical K-major layout without swizzle: core matrices of 8 rows x
// 16 bytes (each 128 contiguous bytes, a row 16 of them), LBO bytes apart
// along k and SBO bytes apart along the rows.
uint8_t desc_byte(const uint8_t* smem, uint64_t desc, int r, int k, bool& fault) {
  const uint64_t start = (desc & 0x3FFF) << 4, lbo = ((desc >> 16) & 0x3FFF) << 4, sbo = ((desc >> 32) & 0x3FFF) << 4;
  if ((desc >> 46) != 0 || (desc & 0xC000) || ((desc >> 30) & 3)) fault = true;  // swizzle, base offset, reserved
  return smem[start + (r / 8) * sbo + (k / 16) * lbo + (r % 8) * 16 + k % 16];
}

// D of one wgmma from the 128 threads' deposits (thread 0, between barriers).
void group_wgmma(Group& G) {
  const int n = G.n[0];
  for (int tid = 1; tid < WG; ++tid)
    if (G.n[tid] != n || G.db[tid] != G.db[0] || G.scale[tid] != G.scale[0])
      G.fault = true;  // the threads disagree on a warpgroup-wide operand
  static thread_local std::vector<int64_t> C;
  uint8_t A[64][32];
  std::vector<uint8_t> B(32 * n);
  C.assign(64 * n, 0);
  for (int tid = 0; tid < WG; ++tid) {
    const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    for (int i = 0; i < n / 8; ++i)
      for (int h = 0; h < 2; ++h)
        for (int c = 0; c < 2; ++c)
          C[(16 * w + g + 8 * h) * n + 8 * i + 2 * t + c] = G.scale[0] ? (int32_t)G.d[tid][4 * i + 2 * h + c] : 0;
    for (int j = 0; j < 4; ++j)
      for (int byte = 0; byte < 4; ++byte)
        A[16 * w + g + 8 * (j & 1)][16 * (j >> 1) + 4 * t + byte] = (G.a[tid][j] >> (8 * byte)) & 0xFF;
  }
  for (int k = 0; k < 32; ++k)
    for (int col = 0; col < n; ++col) B[k * n + col] = desc_byte(G.smem, G.db[0], col, k, G.fault);
  for (int m = 0; m < 64; ++m)
    for (int col = 0; col < n; ++col) {
      int64_t s = C[m * n + col];
      for (int k = 0; k < 32; ++k) s += (int64_t)A[m][k] * B[k * n + col];
      C[m * n + col] = s;
    }
  for (int tid = 0; tid < WG; ++tid) {
    const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    for (int i = 0; i < n / 8; ++i)
      for (int h = 0; h < 2; ++h)
        for (int c = 0; c < 2; ++c)
          G.d[tid][4 * i + 2 * h + c] = (uint32_t)C[(16 * w + g + 8 * h) * n + 8 * i + 2 * t + c];
  }
}

}  // namespace

void wg_bar() { the_group->barrier(); }

uint32_t smem_addr(const void* p) { return (uint32_t)(static_cast<const uint8_t*>(p) - the_smem); }

void host_wgmma(int n, uint32_t* d, const uint32_t* a, uint64_t db, int scale) {
  Group& G = *the_group;
  const int tid = the_tid;
  for (int i = 0; i < n / 2; ++i) G.d[tid][i] = d[i];
  for (int j = 0; j < 4; ++j) G.a[tid][j] = a[j];
  G.n[tid] = n;
  G.db[tid] = db;
  G.scale[tid] = scale;
  G.barrier();
  if (tid == 0) group_wgmma(G);
  G.barrier();
  for (int i = 0; i < n / 2; ++i) d[i] = G.d[tid][i];
  G.barrier();  // every thread has its D before the next product overwrites the deposits
}

template <int L, bool F32>
static int run_chain(const uint32_t* p, uint32_t pinv, const uint8_t* qmat, const uint8_t* pmat, const uint32_t* a,
                     const uint32_t* b, uint32_t* out, int64_t n, int chain) {
  using Sh = MmaShape<L>;
  const FieldConsts<L> f = make_consts<L>(p, pinv);
  bool fault = false;
  for (int64_t first = 0; first < n; first += WG) {
    std::vector<uint8_t> smem(Sh::BYTES, 0xDE);  // garbage, as shared memory starts
    mma_stage<L>(smem.data(), qmat, pmat, 0, 1);
    Group group;
    group.smem = smem.data();
    std::vector<std::thread> threads;
    for (int tid = 0; tid < WG; ++tid)
      threads.emplace_back([&, tid] {
        the_group = &group;
        the_tid = tid;
        the_smem = smem.data();
        mma_chain_wg<L, F32>(a, b, out, n, first + tid, tid, chain, smem.data(), f);
      });
    for (auto& t : threads) t.join();
    fault |= group.fault;
  }
  return fault ? -2 : 0;
}

// The library's entry point, over host memory: blocks one after another.
// Returns -2 if a descriptor held a swizzle mode or a base offset or the
// threads of a warpgroup passed different operands to one product.
extern "C" int host_mont_mma_chain(int limbs, const uint32_t* p, uint32_t pinv, int f32, const uint8_t* qmat,
                                   const uint8_t* pmat, const uint32_t* a, const uint32_t* b, uint32_t* out,
                                   int64_t n, int chain) {
  switch (limbs * 2 + (f32 != 0)) {
    case 16: return run_chain<8, false>(p, pinv, qmat, pmat, a, b, out, n, chain);
    case 17: return run_chain<8, true>(p, pinv, qmat, pmat, a, b, out, n, chain);
    case 24: return run_chain<12, false>(p, pinv, qmat, pmat, a, b, out, n, chain);
    case 25: return run_chain<12, true>(p, pinv, qmat, pmat, a, b, out, n, chain);
    default: return -1;
  }
}

// The variable products alone, t = x y (2L words) for n pairs of L-word
// operands (any words: the tests take all-ones words for the longest carry
// runs): kind 0 the mxu body's split chains, 1 the f32 body's FMAs.
template <int L>
static void products(int kind, const uint32_t* x, const uint32_t* y, uint32_t* t, int64_t n) {
  for (int64_t e = 0; e < n; ++e) {
    if (kind == 0) {
      conv_split<L>(t + e * 2 * L, x + e * L, y + e * L);
    } else {
      conv_f32<L>(t + e * 2 * L, x + e * L, y + e * L);
    }
  }
}

extern "C" int host_mont_mma_product(int limbs, int kind, const uint32_t* x, const uint32_t* y, uint32_t* t,
                                     int64_t n) {
  if (limbs == 8) products<8>(kind, x, y, t, n);
  else if (limbs == 12) products<12>(kind, x, y, t, n);
  else return -1;
  return 0;
}
