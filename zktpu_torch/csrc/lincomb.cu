// The field linear combination over Fr in one launch (field_lincomb):
// out[i] = sum_k (+-) a_k[i] b_k[i] + sum_j (+-) c_j[i], K + J <= 8 terms,
// each row canonical (csrc/lincomb.cuh holds the per-row code, why its
// words equal the chain's, and the accumulator's headroom).
//
// Replaces, on the paths, the chains of Montgomery products and field adds
// and subs that the reference runs as separate calls: Nova's compute_t and
// fold_witness (zktpu/nova/nifs.py:31-52) and PLONK round 5's w_ev_x and
// linearisation polynomial (zktpu/plonk/prover.py:184-191 and :493-), each
// a chain of kernel 1 (zktpu/fields/pallas_mont.py:363, _mont_mul_call) and
// the add/sub (zktpu/fields/fp.py:270).  The port launched each link: 7
// launches for compute_t, 6 for fold_witness, about 16 for w_ev_x.
//
// What bounds it on the H100: at the paths' shapes (2^14 to 2^14 + 5 rows)
// its bytes (under 5 MB) and its word products (64 a product, 217 a row
// for the reduction) each take under 2 us, so the launch is what it costs;
// one launch in place of a chain is the design.  One thread a row (128 a
// block, so that 2^14 rows spread over 128 SMs), 16-byte loads, the exact
// sum in a 17-word accumulator in registers and one reduction a row.
//
// Plain C interface, loaded with ctypes; the entry point returns
// cudaGetLastError() after its launch, or -1 for arguments it refuses.
#include <cuda_runtime.h>

#include "lincomb.cuh"

constexpr int LC_THREADS = 128;

__global__ void __launch_bounds__(LC_THREADS)
    lincomb_kernel(const __grid_constant__ LincombArgs args, uint32_t* __restrict__ out, int64_t n,
                   const __grid_constant__ MatvecConsts c) {
  const int64_t i = (int64_t)blockIdx.x * LC_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t r[MV_L];
  lc_row(r, args, i, c);
  store_elem<MV_L>(out + i * MV_L, r);
}

// out (n, 8) = the combination of `terms` terms described on the host by
// `desc` (LC_DESC_WORDS int64 a term, lincomb.cuh's lc_args), over Fr; p
// (host), pinv = -p^{-1} mod 2^32, k (host) = 2^32 R mod p.
extern "C" int zk_lincomb(int device, const uint32_t* p, uint32_t pinv, const uint32_t* k, const int64_t* desc,
                          int terms, void* out, int64_t n, void* stream) {
  LincombArgs args;
  if (!lc_args(desc, terms, n, &args) || ((uintptr_t)out & 15) || (n + LC_THREADS - 1) / LC_THREADS > 0x7fffffff)
    return -1;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  lincomb_kernel<<<(unsigned)((n + LC_THREADS - 1) / LC_THREADS), LC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<uint32_t*>(out), n, mv_consts(p, pinv, k));
  return (int)cudaGetLastError();
}

// out = {registers, local bytes (spills), static shared bytes, threads a block}.
extern "C" int zk_lincomb_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, lincomb_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = LC_THREADS;
  return 0;
}
