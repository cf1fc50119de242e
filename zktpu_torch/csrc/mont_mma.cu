// Kernels 5m and 5f: the chained Montgomery product with its constant
// convolutions on the tensor cores (u8 wgmma, a warpgroup at a time), and
// the variable one on the integer multiply-add pipe (5m, "mxu") or as FP32
// FMAs (5f, "f32").
//
// Replace the "mxu" and "f32" bodies of tools/prof_mulkernels.py::make_chain
// (RowOpsMXU, RowOpsF32; the Pallas call at :191).  Each thread runs one
// element, `chain` products x = x * y * R^{-1} mod p in registers and
// shared memory, and writes x once, so the time is the multiply body's.
// Per Fq product an element takes 288 integer multiply-adds (mxu: t = x y)
// or 2,304 FP32 FMAs (f32), and 6,656 u8 multiply-accumulates of the band
// on the tensor cores (9,216 issued: wgmma takes whole N ranges); the
// carries between the steps are integer adds and shifts on the ALU.  The
// bound is the variable product's pipe.  A block stages the two constant
// matrices once in shared memory (cp.async), so no register holds a B
// fragment; the per-warpgroup code is mont_mma.cuh.  Fields of at least 16
// digits only (Fr, Fq), zktpu's rule for the matrix path.  Plain C
// interface, loaded with ctypes.
#include <cuda_runtime.h>

#include "mont_mma.cuh"

constexpr int MMA_THREADS = 128;  // one warpgroup
// With -DZK_MMA_MIN_BLOCKS=b the launch bound asks ptxas for b blocks per SM
// (a register cap of 65536 / (128 b)); the library sets none.
#ifdef ZK_MMA_MIN_BLOCKS
#define ZK_MMA_BOUNDS __launch_bounds__(MMA_THREADS, ZK_MMA_MIN_BLOCKS)
#else
#define ZK_MMA_BOUNDS __launch_bounds__(MMA_THREADS)
#endif

template <int L, bool F32>
__global__ void ZK_MMA_BOUNDS
mont_mma_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                      int64_t n, int chain, const uint8_t* __restrict__ qmat, const uint8_t* __restrict__ pmat,
                      FieldConsts<L> f) {
  extern __shared__ __align__(128) uint8_t smem[];
  mma_stage<L>(smem, qmat, pmat, threadIdx.x, MMA_THREADS);
  cp_async_wait_all();
  fence_async_smem();  // the staged matrices are read by wgmma, through the async proxy
  __syncthreads();
  mma_chain_wg<L, F32>(a, b, out, n, (int64_t)blockIdx.x * MMA_THREADS + threadIdx.x, threadIdx.x, chain, smem, f);
}

template <int L, bool F32>
static int launch(const uint32_t* p, uint32_t pinv, const void* qmat, const void* pmat, const void* a,
                  const void* b, void* out, int64_t n, int chain, cudaStream_t stream) {
  constexpr int bytes = MmaShape<L>::BYTES;
  static bool sized = false;  // dynamic shared memory above 48 KB is asked for once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(mont_mma_chain_kernel<L, F32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int64_t blocks = (n + MMA_THREADS - 1) / MMA_THREADS;
  mont_mma_chain_kernel<L, F32><<<(unsigned)blocks, MMA_THREADS, bytes, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out), n, chain,
      static_cast<const uint8_t*>(qmat), static_cast<const uint8_t*>(pmat), make_consts<L>(p, pinv));
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

// out: {registers, local (spill) bytes, shared bytes per block (the dynamic
// staging and tiles)} of the instance for `limbs` and the variant.
extern "C" int zk_mont_mma_attrs(int limbs, int f32, int* out) {
  cudaFuncAttributes at;
  cudaError_t e;
  int bytes;
  switch (limbs * 2 + (f32 != 0)) {
    case 16:
      e = cudaFuncGetAttributes(&at, mont_mma_chain_kernel<8, false>);
      bytes = MmaShape<8>::BYTES;
      break;
    case 17:
      e = cudaFuncGetAttributes(&at, mont_mma_chain_kernel<8, true>);
      bytes = MmaShape<8>::BYTES;
      break;
    case 24:
      e = cudaFuncGetAttributes(&at, mont_mma_chain_kernel<12, false>);
      bytes = MmaShape<12>::BYTES;
      break;
    case 25:
      e = cudaFuncGetAttributes(&at, mont_mma_chain_kernel<12, true>);
      bytes = MmaShape<12>::BYTES;
      break;
    default:
      return -1;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)at.sharedSizeBytes + bytes;
  return 0;
}

template <int L, bool F32>
static void design(int* out) {
  out[0] = MmaDesign<L, F32>::TILES;
  out[1] = MmaDesign<L, F32>::PSPLIT;
#ifdef ZK_MMA_MIN_BLOCKS
  out[2] = ZK_MMA_MIN_BLOCKS;
#else
  out[2] = 0;
#endif
}

// out: the design of the instance for `limbs` and the variant {tiles in
// flight, parts of the m p product, launch bound's minimum blocks (0:
// none)}.
extern "C" int zk_mont_mma_design(int limbs, int f32, int* out) {
  switch (limbs * 2 + (f32 != 0)) {
    case 16: design<8, false>(out); return 0;
    case 17: design<8, true>(out); return 0;
    case 24: design<12, false>(out); return 0;
    case 25: design<12, true>(out); return 0;
    default: return -1;
  }
}
