// Kernels 2, 3 and 4: the fused complete projective G1 add, double and
// mixed add.
//
// Replace zktpu/curves/pallas_g1.py::_proj_add_call, _proj_double_call and
// _proj_madd_call.  One thread per point runs the whole RCB formula (g1.cuh)
// with every intermediate in registers: one launch and 9 (add), 6 (double) or
// 8 (mixed add) x 48 bytes of device memory per point, against 12 or 11
// separate product launches.  About
// 15 live Fq values of 12 limbs sit near the 255-register ceiling, so few
// warps fit on an SM: occupancy, not arithmetic, bounds these kernels.  The
// launch bound of 128 threads lets each thread keep up to 255 registers, so
// the compiler need not spill (build with -Xptxas -v to see the counts).
// Inputs and outputs are (n, 12) int32 planes, one per coordinate.
#include <cuda_runtime.h>

#include "g1.cuh"

__global__ void __launch_bounds__(128)
proj_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                uint32_t* __restrict__ x3, uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
                int64_t n, FqConsts f) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t o = i * FQ_LIMBS;
  uint32_t X1[FQ_LIMBS], Y1[FQ_LIMBS], Z1[FQ_LIMBS], X2[FQ_LIMBS], Y2[FQ_LIMBS], Z2[FQ_LIMBS];
  copy_limbs<FQ_LIMBS>(X1, x1 + o);
  copy_limbs<FQ_LIMBS>(Y1, y1 + o);
  copy_limbs<FQ_LIMBS>(Z1, z1 + o);
  copy_limbs<FQ_LIMBS>(X2, x2 + o);
  copy_limbs<FQ_LIMBS>(Y2, y2 + o);
  copy_limbs<FQ_LIMBS>(Z2, z2 + o);
  uint32_t X3[FQ_LIMBS], Y3[FQ_LIMBS], Z3[FQ_LIMBS];
  proj_add_point(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, f);
  copy_limbs<FQ_LIMBS>(x3 + o, X3);
  copy_limbs<FQ_LIMBS>(y3 + o, Y3);
  copy_limbs<FQ_LIMBS>(z3 + o, Z3);
}

__global__ void __launch_bounds__(128)
proj_double_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                   const uint32_t* __restrict__ z1, uint32_t* __restrict__ x3,
                   uint32_t* __restrict__ y3, uint32_t* __restrict__ z3, int64_t n, FqConsts f) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t o = i * FQ_LIMBS;
  uint32_t X[FQ_LIMBS], Y[FQ_LIMBS], Z[FQ_LIMBS];
  copy_limbs<FQ_LIMBS>(X, x1 + o);
  copy_limbs<FQ_LIMBS>(Y, y1 + o);
  copy_limbs<FQ_LIMBS>(Z, z1 + o);
  uint32_t X3[FQ_LIMBS], Y3[FQ_LIMBS], Z3[FQ_LIMBS];
  proj_double_point(X3, Y3, Z3, X, Y, Z, f);
  copy_limbs<FQ_LIMBS>(x3 + o, X3);
  copy_limbs<FQ_LIMBS>(y3 + o, Y3);
  copy_limbs<FQ_LIMBS>(z3 + o, Z3);
}

// P1 projective, (x2, y2) affine with (0, 0) the identity.
__global__ void __launch_bounds__(128)
proj_madd_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                 const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                 const uint32_t* __restrict__ y2, uint32_t* __restrict__ x3,
                 uint32_t* __restrict__ y3, uint32_t* __restrict__ z3, int64_t n, FqConsts f) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t o = i * FQ_LIMBS;
  uint32_t X1[FQ_LIMBS], Y1[FQ_LIMBS], Z1[FQ_LIMBS], X2[FQ_LIMBS], Y2[FQ_LIMBS];
  copy_limbs<FQ_LIMBS>(X1, x1 + o);
  copy_limbs<FQ_LIMBS>(Y1, y1 + o);
  copy_limbs<FQ_LIMBS>(Z1, z1 + o);
  copy_limbs<FQ_LIMBS>(X2, x2 + o);
  copy_limbs<FQ_LIMBS>(Y2, y2 + o);
  uint32_t X3[FQ_LIMBS], Y3[FQ_LIMBS], Z3[FQ_LIMBS];
  proj_madd_point(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, f);
  copy_limbs<FQ_LIMBS>(x3 + o, X3);
  copy_limbs<FQ_LIMBS>(y3 + o, Y3);
  copy_limbs<FQ_LIMBS>(z3 + o, Z3);
}

static unsigned grid_for(int64_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

// Each entry point returns cudaGetLastError() after the launch.
extern "C" int zk_proj_add(int device, const uint32_t* p, uint32_t pinv, const void* x1,
                           const void* y1, const void* z1, const void* x2, const void* y2,
                           const void* z2, void* x3, void* y3, void* z3, int64_t n,
                           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 128;
  proj_add_kernel<<<grid_for(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x1), static_cast<const uint32_t*>(y1),
      static_cast<const uint32_t*>(z1), static_cast<const uint32_t*>(x2),
      static_cast<const uint32_t*>(y2), static_cast<const uint32_t*>(z2),
      static_cast<uint32_t*>(x3), static_cast<uint32_t*>(y3), static_cast<uint32_t*>(z3), n,
      make_consts<FQ_LIMBS>(p, pinv));
  return (int)cudaGetLastError();
}

extern "C" int zk_proj_double(int device, const uint32_t* p, uint32_t pinv, const void* x1,
                              const void* y1, const void* z1, void* x3, void* y3, void* z3,
                              int64_t n, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 128;
  proj_double_kernel<<<grid_for(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x1), static_cast<const uint32_t*>(y1),
      static_cast<const uint32_t*>(z1), static_cast<uint32_t*>(x3), static_cast<uint32_t*>(y3),
      static_cast<uint32_t*>(z3), n, make_consts<FQ_LIMBS>(p, pinv));
  return (int)cudaGetLastError();
}

extern "C" int zk_proj_madd(int device, const uint32_t* p, uint32_t pinv, const void* x1,
                            const void* y1, const void* z1, const void* x2, const void* y2,
                            void* x3, void* y3, void* z3, int64_t n, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 128;
  proj_madd_kernel<<<grid_for(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x1), static_cast<const uint32_t*>(y1),
      static_cast<const uint32_t*>(z1), static_cast<const uint32_t*>(x2),
      static_cast<const uint32_t*>(y2), static_cast<uint32_t*>(x3), static_cast<uint32_t*>(y3),
      static_cast<uint32_t*>(z3), n, make_consts<FQ_LIMBS>(p, pinv));
  return (int)cudaGetLastError();
}
