// Host build of csrc/matvec.cu's kernel, for the CPU tests
// (tests/test_torch_csrc_host.py, tests/test_torch_nova.py): csrc/matvec.cuh
// compiles as C++ with the PTX carry chains emulated, and the entry points
// below take the library's arguments (device and stream ignored, pointers
// to host memory), so the port's own wrapper (nova/matvec_kernel.py's run)
// drives them.  Each block runs as the card runs it: phases 1 and 2 for
// every thread in turn, then each warp's xor-shuffle steps, each step
// reading the lanes' values from before it, then the sum over the warps.
// The tests build it with other rows and threads a block
// (-DZK_MATVEC_ROWS, -DZK_MATVEC_THREADS) so that small inputs take several
// blocks, a last block with rows past m, and one or several warps.  Not
// part of the port.
#include <vector>

#include "../zktpu_torch/csrc/matvec.cuh"

extern "C" int zk_matvec(int, const uint32_t* p, uint32_t pinv, const uint32_t* k, const void* A, const void* z,
                         void* out, int64_t m, int64_t n, void*) {
  if (!mv_args_ok(m, n)) return -1;
  const MatvecConsts c = mv_consts(p, pinv, k);
  const uint32_t* a = static_cast<const uint32_t*>(A);
  const uint32_t* zz = static_cast<const uint32_t*>(z);
  uint32_t* o = static_cast<uint32_t*>(out);
  using Row = std::vector<uint32_t>;
  std::vector<Row> v(MV_THREADS * MV_ROWS, Row(MV_L));  // thread t, row r at t MV_ROWS + r
  std::vector<uint32_t> s(MV_WARPS * MV_ROWS * MV_L);
  for (int64_t b = 0; b < mv_blocks(m); ++b) {
    const int64_t r0 = b * MV_ROWS;
    for (uint32_t t = 0; t < MV_THREADS; ++t) {
      uint32_t acc[MV_ROWS][MV_ACC];
      mv_thread_sums(a, zz, m, n, r0, t, acc);  // 1
      for (int r = 0; r < MV_ROWS; ++r) mv_reduce(v[t * MV_ROWS + r].data(), acc[r], c);  // 2
    }
    for (int r = 0; r < MV_ROWS; ++r) {
      for (uint32_t d = 16; d > 0; d >>= 1) {  // __shfl_xor_sync reads the lanes' values before the step
        std::vector<Row> before(MV_THREADS);
        for (uint32_t t = 0; t < MV_THREADS; ++t) before[t] = v[t * MV_ROWS + r];
        for (uint32_t t = 0; t < MV_THREADS; ++t) {
          const uint32_t src = t - t % 32 + ((t % 32) ^ d);
          fadd<MV_L>(v[t * MV_ROWS + r].data(), before[t].data(), before[src].data(), c.f);
        }
      }
      for (uint32_t w = 0; w < MV_WARPS; ++w) copy_limbs<MV_L>(s.data() + (w * MV_ROWS + r) * MV_L,
                                                              v[w * 32 * MV_ROWS + r].data());
    }
    for (uint32_t t = 0; t < MV_ROWS; ++t)
      if (r0 + t < m) mv_block_total(o + (r0 + t) * MV_L, s.data(), t, c.f);
  }
  return 0;
}

// The host build has no registers or spills to report: {0, 0, shared bytes, rows, threads}.
extern "C" int zk_matvec_attrs(int* out) {
  out[0] = out[1] = 0;
  out[2] = (int)(MV_WARPS * MV_ROWS * MV_L * sizeof(uint32_t));
  out[3] = MV_ROWS;
  out[4] = (int)MV_THREADS;
  return 0;
}
