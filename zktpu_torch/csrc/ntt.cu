// The NTT over Fr (L = 8) and Goldilocks (L = 2): bit reversal, radix-2 DIT
// stages and the factors at both ends, in 1 + ceil((log n - 9) / 6) launches
// over Fr (3 at 2^17 and 2^20, 4 at 2^23) and 1 + ceil((log n - 10) / 6)
// over Goldilocks (3 at 2^20, 1 up to 2^10: the FRI layers below 2^11).
//
// Replaces the stage loop of zktpu/poly/domain.py::_transform (a jnp graph
// of log n stages, each a Montgomery product by kernel 1,
// zktpu/fields/pallas_mont.py:363, and a tensor add, sub and concatenate).
// In the port that loop cost one product launch, a copy of the strided odd
// half and about 80 small tensor ops per stage.
//
// What bounds it on the H100: 32-bit integer multiply-adds.  A transform
// does (n/2) log n products of 2 L^2 + L word products (136 for Fr, 10 for
// Goldilocks), each word product two multiply-adds (low and high halves),
// plus n products for each factor; its bytes (each element read and written
// once per pass) take a small share of that time over Fr and about half of
// it over Goldilocks.  What the design does about it:
// - the stages of a pass run in shared memory (ntt.cuh): a block loads a
//   tile (2^9 Fr elements, 16 KB, or 2^10 Goldilocks ones, 8 KB), runs up
//   to 9 (10) stages on it with a barrier between stages and writes it
//   once, so memory sees each element twice per pass instead of twice per
//   stage, and there are 3-4 launches instead of 17-23 stages of launches;
// - the first pass gathers its tile through the bit reversal and multiplies
//   by the input factor (the coset offset powers) as it loads; the last
//   pass multiplies by the output factor (n^-1, or n^-1 offset^-i) as it
//   stores: no separate pass for the permutation or the factors;
// - one thread runs a whole butterfly: the product of field.cuh (the
//   carry-chain product for Fr, fmul_wide's 64-bit sums for Goldilocks,
//   whose p > R/2 needs its extra carry word), then the add and the sub with
//   one conditional correction each; twiddles are read from the domain's
//   power table (L2-resident);
// - small blocks, many per SM: 128 threads and at least 8 blocks per SM
//   (so at most 64 registers; 128 KB of shared memory), 32 warps per SM to
//   feed the integer pipes through the dependent carry chains, and while
//   one block waits at a barrier the others run.  Larger tiles (2^10-2^12
//   elements, 256-1024 threads) save a pass at some sizes but lose more at
//   the barriers (zktpu_torch/tools/ntt_tiles.py times them).
#include <cuda_runtime.h>

#include "ntt.cuh"

#ifndef ZK_NTT_MIN_BLOCKS
#define ZK_NTT_MIN_BLOCKS 8
#endif

template <int L>
constexpr size_t ntt_smem_bytes() {
  return (size_t(1) << NttTileShape<L>::log_tile) * L * sizeof(uint32_t);
}

template <int L>
__global__ void __launch_bounds__(ZK_NTT_THREADS, ZK_NTT_MIN_BLOCKS)
ntt_pass_kernel(NttArgs a, FieldConsts<L> f) {
  extern __shared__ uint4 ntt_smem[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(ntt_smem);
  const uint32_t tile = blockIdx.x, row = blockIdx.y;
  ntt_load_thread<L>(a, tile, row, threadIdx.x, sm, f);
  __syncthreads();
  for (int r = 1; r <= a.pass.ns; ++r) {
    ntt_stage_thread<L>(a, tile, r, threadIdx.x, sm, f);
    __syncthreads();
  }
  ntt_store_thread<L>(a, tile, row, threadIdx.x, sm, f);
}

template <int L>
static int ntt_launch(const uint32_t* p, uint32_t pinv, const void* in, void* out, int64_t batch, int log_n,
                      const void* tw, const void* in_f, int64_t in_fs, const void* out_f, int64_t out_fs,
                      void* stream, int* launched) {
  cudaError_t e = cudaFuncSetAttribute(ntt_pass_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)ntt_smem_bytes<L>());
  if (e != cudaSuccess) return (int)e;
  const FieldConsts<L> f = make_consts<L>(p, pinv);
  NttPass passes[NTT_MAX_PASSES];
  const int np = ntt_plan<L>(log_n, passes);
  for (int k = 0; k < np; ++k) {
    NttArgs a;
    a.in = static_cast<const uint32_t*>(in);
    a.out = static_cast<uint32_t*>(out);
    a.tw = static_cast<const uint32_t*>(tw);
    a.in_f = static_cast<const uint32_t*>(in_f);
    a.out_f = static_cast<const uint32_t*>(out_f);
    a.in_fs = (uint32_t)in_fs;
    a.out_fs = (uint32_t)out_fs;
    a.log_n = log_n;
    a.pass = passes[k];
    a.first = k == 0;
    a.last = k == np - 1;
    const unsigned tiles = 1u << (log_n - a.pass.ns - a.pass.log_cols);
    const size_t smem = (size_t)ntt_tile_elems(a.pass) * L * sizeof(uint32_t);
    ntt_pass_kernel<L><<<dim3(tiles, (unsigned)batch), ZK_NTT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a, f);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    *launched += 1;
  }
  return 0;
}

// The transform of `batch` rows of 2^log_n elements of `limbs` words (8: Fr,
// 2: Goldilocks) from `in` into `out` (distinct, contiguous (batch, n, limbs)
// words).  tw: n/2 twiddle rows; in_f, out_f: factor rows or null, with row
// strides 1 (a table of n rows) or 0 (one value).  Returns
// cudaGetLastError() after the last launch (or -1 for an unsupported size
// or width) and the number of launches in *launched.
extern "C" int zk_ntt(int device, int limbs, const uint32_t* p, uint32_t pinv, const void* in, void* out,
                      int64_t batch, int log_n, const void* tw, const void* in_f, int64_t in_fs, const void* out_f,
                      int64_t out_fs, void* stream, int* launched) {
  *launched = 0;
  if (log_n < 0 || log_n > 30 || batch < 1 || batch > 65535) return -1;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  switch (limbs) {
    case 8:
      return ntt_launch<8>(p, pinv, in, out, batch, log_n, tw, in_f, in_fs, out_f, out_fs, stream, launched);
    case 2:
      return ntt_launch<2>(p, pinv, in, out, batch, log_n, tw, in_f, in_fs, out_f, out_fs, stream, launched);
    default:
      return -1;
  }
}

// Registers per thread, local memory (spills) and the shared memory a block
// of the largest tile takes, for the kernel of `limbs` words:
// out = {registers, local bytes, shared bytes}.
template <int L>
static int ntt_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, ntt_pass_kernel<L>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + ntt_smem_bytes<L>());
  return 0;
}

extern "C" int zk_ntt_attrs(int limbs, int* out) {
  switch (limbs) {
    case 8:
      return ntt_attrs<8>(out);
    case 2:
      return ntt_attrs<2>(out);
    default:
      return -1;
  }
}
