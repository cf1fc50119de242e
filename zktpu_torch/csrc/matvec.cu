// Nova's matrix-vector product in one launch (matvec_fr): out = A z over Fr
// for a dense (m, n, 8) Montgomery matrix A and an (n, 8) vector z, each
// row canonical (csrc/matvec.cuh holds the per-thread and per-block code).
//
// Replaces, on Nova's path, the product of zktpu/nova/utils.py:28-31: its
// Montgomery product of A against z[None] (zktpu/fields/pallas_mont.py:363,
// _mont_mul_call) and its axis-1 field sum (zktpu/fields/fp.py:309, a tree
// of adds).  The port ran that as two launches, kernel 1 over (m, n, 8)
// elements and kernel A's sum over the (m, n, 8) product it wrote: 25.8 GB
// of traffic at m = 2^14, n = 16,387, and an 8.59 GB temporary.
//
// What bounds it on the H100: its bytes.  It reads A once and z (524 KB,
// L2-resident) once a block, and writes m rows: 8.59 GB at Nova's shape,
// 2.56 ms at 3.35 TB/s.  A full CIOS product per element (136 word
// products) would cost 4.37 ms of 32-bit multiply-adds; the schoolbook a z
// alone (64 word products) costs 2.06 ms, so the design sums exact products
// and reduces once per partial sum: each thread keeps a 17-word accumulator
// per row in registers, reduces it once (nine Montgomery rounds, one
// conditional subtraction, one product by 2^32 R), and the block adds the
// threads' canonical values by warp shuffles and shared memory.  Each
// thread streams its A[r, j] as 16-byte loads (a warp reads 1 KB of a row
// contiguously), and the warps of the SM keep the loads in flight.  A block
// takes ZK_MATVEC_ROWS rows, and each z[j] it loads serves them all; the
// library takes one row a block and 128 threads (56 registers, so 9 blocks
// a SM): in tools/matvec_tiles.py's sweep at Nova's shape, more rows a
// block saved L2 reads of z but cost registers and occupancy, and lost.
//
// Plain C interface, loaded with ctypes; the entry point returns
// cudaGetLastError() after its launch, or -1 for arguments it refuses.
#include <cuda_runtime.h>

#include "matvec.cuh"

#ifndef ZK_MATVEC_MIN_BLOCKS
#define ZK_MATVEC_MIN_BLOCKS 6
#endif

__global__ void __launch_bounds__(MV_THREADS, ZK_MATVEC_MIN_BLOCKS)
    matvec_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ z, uint32_t* __restrict__ out,
                  int64_t m, int64_t n, MatvecConsts c) {
  __shared__ uint32_t s[MV_WARPS * MV_ROWS * MV_L];
  const uint32_t t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int64_t r0 = (int64_t)blockIdx.x * MV_ROWS;
  uint32_t acc[MV_ROWS][MV_ACC];
  mv_thread_sums(A, z, m, n, r0, t, acc);  // 1
#pragma unroll
  for (int r = 0; r < MV_ROWS; ++r) {
    uint32_t v[MV_L], o[MV_L];
    mv_reduce(v, acc[r], c);  // 2
#pragma unroll
    for (uint32_t d = 16; d > 0; d >>= 1) {  // the warp's sum, in every lane
#pragma unroll
      for (int j = 0; j < MV_L; ++j) o[j] = __shfl_xor_sync(0xffffffffu, v[j], d);
      fadd<MV_L>(v, v, o, c.f);
    }
    if (lane == 0) copy_limbs<MV_L>(s + (warp * MV_ROWS + r) * MV_L, v);
  }
  __syncthreads();
  if (t < MV_ROWS && r0 + t < m) mv_block_total(out + (r0 + t) * MV_L, s, t, c.f);
}

static bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; }

// out (m, 8) = A (m, n, 8) z (n, 8) over Fr, Montgomery words, all three
// contiguous and 16-byte aligned; p (host), pinv = -p^{-1} mod 2^32, k
// (host) = 2^32 R mod p; 1 <= m, 1 <= n < 2^31.
extern "C" int zk_matvec(int device, const uint32_t* p, uint32_t pinv, const uint32_t* k, const void* A,
                         const void* z, void* out, int64_t m, int64_t n, void* stream) {
  if (!mv_args_ok(m, n) || mv_blocks(m) > 0x7fffffff || !aligned16(A) || !aligned16(z) || !aligned16(out)) return -1;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  matvec_kernel<<<(unsigned)mv_blocks(m), MV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(A), static_cast<const uint32_t*>(z), static_cast<uint32_t*>(out), m, n,
      mv_consts(p, pinv, k));
  return (int)cudaGetLastError();
}

// out = {registers, local bytes (spills), static shared bytes, rows a block, threads a block}.
extern "C" int zk_matvec_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, matvec_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = MV_ROWS;
  out[4] = (int)MV_THREADS;
  return 0;
}
