// The FRI fold in one launch: out[i] = c[2i] + r c[2i+1] over Goldilocks
// (fri_fold.cuh), r a Montgomery word passed by value.
//
// Replaces the jnp graph of zktpu/fri/prover.py::fold_polynomial (:44) around
// the Montgomery product kernel (zktpu/fields/pallas_mont.py:363): the
// strided even and odd halves, r * odd by kernel 1, a concatenation to pad
// an odd length, and the add.  In the port that was a copy of the odd half,
// a copy of r to the card, a product launch, a concatenation and an add
// launch per layer.
//
// What bounds it on the H100: its bytes, each coefficient read once and each
// output written once (n/2 products of four word products each take a
// small share of that time).  The design: one thread per output reads its
// even and odd coefficients as one 16-byte word (a pair starts on a 16-byte
// boundary: the wrapper passes a 16-byte aligned, contiguous tensor) and
// writes one 8-byte word; the output length, ceil(n / 2), is known on the
// host, so nothing waits for the card.
#include <cuda_runtime.h>

#include "fri_fold.cuh"

__global__ void __launch_bounds__(256) fri_fold_kernel(const uint64_t* __restrict__ c, int64_t n, uint64_t r,
                                                       uint64_t* __restrict__ out, int64_t m) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  if (2 * i + 1 < n) {
    const ulonglong2 v = reinterpret_cast<const ulonglong2*>(c)[i];
    out[i] = gl_add(v.x, gl_mul(v.y, r));
  } else {
    out[i] = fri_fold_at(c, n, r, i);
  }
}

// The fold of n >= 1 coefficients (n, 2 words, 16-byte aligned) by the
// Montgomery word r_hi 2^32 + r_lo into out (ceil(n / 2) rows).  Returns
// cudaGetLastError() after the launch, or -1 for n < 1.
extern "C" int zk_fri_fold(int device, const void* coeffs, int64_t n, uint32_t r_lo, uint32_t r_hi, void* out,
                           void* stream) {
  if (n < 1) return -1;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int64_t m = (n + 1) / 2;
  fri_fold_kernel<<<(unsigned)((m + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(coeffs), n, ((uint64_t)r_hi << 32) | r_lo, static_cast<uint64_t*>(out), m);
  return (int)cudaGetLastError();
}

// out = {registers, local bytes (spills), static shared bytes}.
extern "C" int zk_fri_fold_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fri_fold_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}
