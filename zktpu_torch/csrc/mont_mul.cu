// Kernel 1: the batched Montgomery product a * b * R^{-1} mod p.
//
// Replaces zktpu/fields/pallas_mont.py::_mont_mul_call (the Pallas kernel
// behind mont_mul_pallas).  One thread per element runs CIOS over L u32 limbs
// in registers (field.cuh::fmul), instantiated for L = 12 (Fq), 8 (Fr) and
// 2 (Goldilocks).  An operand of na < n rows broadcasts by its row index
// modulo na, which covers the shapes the port uses (a full batch times one
// constant, or a (K, m) batch times an (m,) table): one row is read at index
// 0, a power-of-two period by a mask, any other by the 64-bit modulo (each
// a branch that every thread takes alike).  Fr and Fq rows are read and written as
// 16-byte words (2 and 3 a row) when every pointer is 16-byte aligned, which
// the wrapper's contiguous operands are.  Plain C interface, loaded with
// ctypes.
//
// Kernel 5, the chained product, replaces the base variant of
// tools/prof_mulkernels.py::make_chain: each thread loads a and b once, runs
// a = a * b * R^{-1} `chain` times in registers and writes a once, so its
// time measures the CIOS multiply body and not memory or launches.  It is
// bound by 32-bit integer multiply-adds (about 2 L^2 + L per product).
#include <cuda_runtime.h>

#include "field.cuh"

// Row i of an operand of `rows` rows, broadcast over n >= rows rows.
__device__ __forceinline__ int64_t bcast_row(int64_t i, int64_t rows, int64_t n) {
  if (rows == n) return i;
  if (rows == 1) return 0;
  if ((rows & (rows - 1)) == 0) return i & (rows - 1);
  return i % rows;
}

// VEC: rows as 16-byte words (L = 8 or 12 and every pointer 16-byte aligned).
template <int L, bool VEC>
__global__ void __launch_bounds__(256)
mont_mul_kernel(const uint32_t* __restrict__ a, int64_t na, const uint32_t* __restrict__ b,
                int64_t nb, uint32_t* __restrict__ out, int64_t n, FieldConsts<L> f) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t ia = bcast_row(i, na, n);
  const int64_t ib = bcast_row(i, nb, n);
  uint32_t x[L], y[L], r[L];
  if constexpr (VEC) {
    load_elem<L>(x, a + ia * L);
    load_elem<L>(y, b + ib * L);
  } else {
    copy_limbs<L>(x, a + ia * L);
    copy_limbs<L>(y, b + ib * L);
  }
  fmul<L>(r, x, y, f);
  if constexpr (VEC) {
    store_elem<L>(out + i * L, r);
  } else {
    copy_limbs<L>(out + i * L, r);
  }
}

template <int L>
static int launch_mont_mul(const uint32_t* p, uint32_t pinv, const void* a, int64_t na,
                           const void* b, int64_t nb, void* out, int64_t n, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  const uint32_t *x = static_cast<const uint32_t*>(a), *y = static_cast<const uint32_t*>(b);
  uint32_t* o = static_cast<uint32_t*>(out);
  const FieldConsts<L> f = make_consts<L>(p, pinv);
  const bool vec = L % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                                   reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    mont_mul_kernel<L, L % 4 == 0><<<(unsigned)blocks, threads, 0, stream>>>(x, na, y, nb, o, n, f);
  } else {
    mont_mul_kernel<L, false><<<(unsigned)blocks, threads, 0, stream>>>(x, na, y, nb, o, n, f);
  }
  return (int)cudaGetLastError();
}

template <int L>
__global__ void __launch_bounds__(256)
mont_mul_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, int64_t n, int chain, FieldConsts<L> f) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L], y[L], r[L];
  copy_limbs<L>(x, a + i * L);
  copy_limbs<L>(y, b + i * L);
#pragma unroll 1
  for (int k = 0; k < chain; ++k) {
    fmul<L>(r, x, y, f);
    copy_limbs<L>(x, r);
  }
  copy_limbs<L>(out + i * L, x);
}

template <int L>
static int launch_mont_mul_chain(const uint32_t* p, uint32_t pinv, const void* a, const void* b,
                                 void* out, int64_t n, int chain, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  mont_mul_chain_kernel<L><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n, chain, make_consts<L>(p, pinv));
  return (int)cudaGetLastError();
}

// Each entry point returns cudaGetLastError() after the launch, or -1 for an
// unsupported width.
extern "C" int zk_mont_mul(int device, int limbs, const uint32_t* p, uint32_t pinv,
                           const void* a, int64_t na, const void* b, int64_t nb, void* out,
                           int64_t n, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs) {
    case 2:
      return launch_mont_mul<2>(p, pinv, a, na, b, nb, out, n, s);
    case 8:
      return launch_mont_mul<8>(p, pinv, a, na, b, nb, out, n, s);
    case 12:
      return launch_mont_mul<12>(p, pinv, a, na, b, nb, out, n, s);
    default:
      return -1;
  }
}

extern "C" int zk_mont_mul_chain(int device, int limbs, const uint32_t* p, uint32_t pinv,
                                 const void* a, const void* b, void* out, int64_t n, int chain,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs) {
    case 2:
      return launch_mont_mul_chain<2>(p, pinv, a, b, out, n, chain, s);
    case 8:
      return launch_mont_mul_chain<8>(p, pinv, a, b, out, n, chain, s);
    case 12:
      return launch_mont_mul_chain<12>(p, pinv, a, b, out, n, chain, s);
    default:
      return -1;
  }
}
