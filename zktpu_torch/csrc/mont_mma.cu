// Kernels 5m and 5f: the chained Montgomery product with its constant
// convolutions on the tensor cores (u8 mma.sync), and the variable one on
// the integer multiply-add pipe (5m, "mxu") or as FP32 FMAs (5f, "f32").
//
// Replace the "mxu" and "f32" bodies of tools/prof_mulkernels.py::make_chain
// (RowOpsMXU, RowOpsF32; the Pallas call at :191).  Each warp runs 32
// elements, one a lane, `chain` products x = x * y * R^{-1} mod p in
// registers and shared memory, and writes x once, so the time is the
// multiply body's.  Per Fq product an element takes 288 integer
// multiply-adds (mxu: the carry-chain rows of t = x y) or 2,304 FP32 FMAs
// (f32), and 6,656 u8 multiply-accumulates on the tensor cores; the
// carries between the steps are integer adds and shifts on the ALU.  The
// per-warp code is mont_mma.cuh.  Fields of at least 16 digits only (Fr,
// Fq), zktpu's rule for the matrix path.  Plain C interface, loaded with
// ctypes.
#include <cuda_runtime.h>

#include "mont_mma.cuh"

constexpr int MMA_THREADS = 128;
// The library gives ptxas no minimum of blocks per SM.  With
// -DZK_MMA_MIN_BLOCKS=b the launch bound asks for b 128-thread blocks (a
// register cap of 65536 / (128 b)): tools/mma_budgets.py builds and times
// such copies.
#ifdef ZK_MMA_MIN_BLOCKS
#define ZK_MMA_BOUNDS __launch_bounds__(MMA_THREADS, ZK_MMA_MIN_BLOCKS)
#else
#define ZK_MMA_BOUNDS __launch_bounds__(MMA_THREADS)
#endif

template <int L, bool F32>
__global__ void ZK_MMA_BOUNDS
mont_mma_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                      int64_t n, int chain, const uint32_t* __restrict__ qmat, const uint32_t* __restrict__ pmat,
                      FieldConsts<L> f) {
  using Sh = MmaShape<L>;
  __shared__ __align__(16) uint32_t smem[MMA_THREADS / 32 * Sh::WARP_WORDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * MMA_THREADS + warp * 32;
  if (first >= n) return;  // the whole warp: a warp with any element runs all 32 lanes
  mma_chain_warp<L, F32>(a, b, out, n, first + lane, lane, chain, qmat, pmat, smem + warp * Sh::WARP_WORDS, f);
}

template <int L, bool F32>
static int launch(const uint32_t* p, uint32_t pinv, const void* qmat, const void* pmat, const void* a,
                  const void* b, void* out, int64_t n, int chain, cudaStream_t stream) {
  const int64_t blocks = (n + MMA_THREADS - 1) / MMA_THREADS;
  mont_mma_chain_kernel<L, F32><<<(unsigned)blocks, MMA_THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out), n, chain,
      static_cast<const uint32_t*>(qmat), static_cast<const uint32_t*>(pmat), make_consts<L>(p, pinv));
  return (int)cudaGetLastError();
}

// qmat, pmat: fields/mont_mats.py::kernel_mats on the device.  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported width.
extern "C" int zk_mont_mma_chain(int device, int limbs, const uint32_t* p, uint32_t pinv, int f32,
                                 const void* qmat, const void* pmat, const void* a, const void* b, void* out,
                                 int64_t n, int chain, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs * 2 + (f32 != 0)) {
    case 16:
      return launch<8, false>(p, pinv, qmat, pmat, a, b, out, n, chain, s);
    case 17:
      return launch<8, true>(p, pinv, qmat, pmat, a, b, out, n, chain, s);
    case 24:
      return launch<12, false>(p, pinv, qmat, pmat, a, b, out, n, chain, s);
    case 25:
      return launch<12, true>(p, pinv, qmat, pmat, a, b, out, n, chain, s);
    default:
      return -1;
  }
}

// out: {registers, local (spill) bytes, static shared bytes per block} of
// the instance for `limbs` and the variant.
extern "C" int zk_mont_mma_attrs(int limbs, int f32, int* out) {
  cudaFuncAttributes at;
  cudaError_t e;
  switch (limbs * 2 + (f32 != 0)) {
    case 16:
      e = cudaFuncGetAttributes(&at, mont_mma_chain_kernel<8, false>);
      break;
    case 17:
      e = cudaFuncGetAttributes(&at, mont_mma_chain_kernel<8, true>);
      break;
    case 24:
      e = cudaFuncGetAttributes(&at, mont_mma_chain_kernel<12, false>);
      break;
    case 25:
      e = cudaFuncGetAttributes(&at, mont_mma_chain_kernel<12, true>);
      break;
    default:
      return -1;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)at.sharedSizeBytes;
  return 0;
}
