// Host build of kernels 5m and 5f's per-lane code (zktpu_torch/csrc/mont_mma.cuh),
// for the CPU tests (tests/test_torch_csrc_host.py).  A warp runs as 32
// threads, each running mma_chain_warp for its lane as the CUDA thread does;
// warp_sync() is a barrier of the 32, and mma_u8() gathers the 32 lanes'
// fragments, rebuilds A (16 x 32), B (32 x 8) and C (16 x 8) by the PTX ISA's
// layout tables for mma.m16n8k32 with .u8 operands and .s32 accumulators,
// multiplies with plain loops and hands each lane its fragment of D.  So the
// kernel's fragment index math, its shared-memory rows, the skipped blocks
// and the carries are held against the plain versions on the CPU.  Not part
// of the port.
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#include "../zktpu_torch/csrc/mont_mma.cuh"

namespace {

struct Warp {
  std::mutex mu;
  std::condition_variable cv;
  int waiting = 0;
  long generation = 0;
  uint32_t a[32][4], b[32][2], c[32][4];

  void barrier() {
    std::unique_lock<std::mutex> lock(mu);
    const long gen = generation;
    if (++waiting == 32) {
      waiting = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return generation != gen; });
    }
  }
};

thread_local Warp* the_warp = nullptr;
thread_local int the_lane = 0;

// The PTX ISA's fragment tables for m16n8k32 (.u8 A and B, .s32 C and D);
// lane = 4 * groupID + threadID_in_group, element i of a fragment in byte
// i % 4 of register i / 4 (A, B) or register i (C, D).
int a_row(int lane, int i) { return (lane >> 2) + ((i < 4 || (i >= 8 && i < 12)) ? 0 : 8); }
int a_col(int lane, int i) { return (lane & 3) * 4 + (i & 3) + (i >= 8 ? 16 : 0); }
int b_row(int lane, int i) { return (lane & 3) * 4 + (i & 3) + (i >= 4 ? 16 : 0); }
int b_col(int lane, int) { return lane >> 2; }
int c_row(int lane, int i) { return (lane >> 2) + (i >= 2 ? 8 : 0); }
int c_col(int lane, int i) { return (lane & 3) * 2 + (i & 1); }

void warp_mma(Warp& w) {
  uint32_t A[16][32], B[32][8];
  int64_t C[16][8];
  for (int lane = 0; lane < 32; ++lane) {
    for (int i = 0; i < 16; ++i) A[a_row(lane, i)][a_col(lane, i)] = (w.a[lane][i / 4] >> (8 * (i % 4))) & 0xFF;
    for (int i = 0; i < 8; ++i) B[b_row(lane, i)][b_col(lane, i)] = (w.b[lane][i / 4] >> (8 * (i % 4))) & 0xFF;
    for (int i = 0; i < 4; ++i) C[c_row(lane, i)][c_col(lane, i)] = (int32_t)w.c[lane][i];
  }
  for (int r = 0; r < 16; ++r)
    for (int n = 0; n < 8; ++n)
      for (int k = 0; k < 32; ++k) C[r][n] += (int64_t)A[r][k] * B[k][n];
  for (int lane = 0; lane < 32; ++lane)
    for (int i = 0; i < 4; ++i) w.c[lane][i] = (uint32_t)C[c_row(lane, i)][c_col(lane, i)];
}

}  // namespace

void warp_sync() { the_warp->barrier(); }

void mma_u8(uint32_t* c, const uint32_t* a, const uint32_t* b) {
  Warp& w = *the_warp;
  const int lane = the_lane;
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  for (int i = 0; i < 2; ++i) w.b[lane][i] = b[i];
  for (int i = 0; i < 4; ++i) w.c[lane][i] = c[i];
  w.barrier();
  if (lane == 0) warp_mma(w);
  w.barrier();
  for (int i = 0; i < 4; ++i) c[i] = w.c[lane][i];
  w.barrier();  // every lane has its D before the next product overwrites the fragments
}

template <int L, bool F32>
static void run_chain(const uint32_t* p, uint32_t pinv, const uint32_t* qmat, const uint32_t* pmat,
                      const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n, int chain) {
  const FieldConsts<L> f = make_consts<L>(p, pinv);
  for (int64_t first = 0; first < n; first += 32) {
    Warp w;
    std::vector<uint32_t> ws(MmaShape<L>::WARP_WORDS, 0xDEADBEEF);  // garbage, as shared memory starts
    std::vector<std::thread> lanes;
    for (int lane = 0; lane < 32; ++lane)
      lanes.emplace_back([&, lane] {
        the_warp = &w;
        the_lane = lane;
        mma_chain_warp<L, F32>(a, b, out, n, first + lane, lane, chain, qmat, pmat, ws.data(), f);
      });
    for (auto& t : lanes) t.join();
  }
}

// The library's entry point, over host memory: warps of 32 elements one
// after another.
extern "C" int host_mont_mma_chain(int limbs, const uint32_t* p, uint32_t pinv, int f32, const uint32_t* qmat,
                                   const uint32_t* pmat, const uint32_t* a, const uint32_t* b, uint32_t* out,
                                   int64_t n, int chain) {
  switch (limbs * 2 + (f32 != 0)) {
    case 16: run_chain<8, false>(p, pinv, qmat, pmat, a, b, out, n, chain); return 0;
    case 17: run_chain<8, true>(p, pinv, qmat, pmat, a, b, out, n, chain); return 0;
    case 24: run_chain<12, false>(p, pinv, qmat, pmat, a, b, out, n, chain); return 0;
    case 25: run_chain<12, true>(p, pinv, qmat, pmat, a, b, out, n, chain); return 0;
    default: return -1;
  }
}
