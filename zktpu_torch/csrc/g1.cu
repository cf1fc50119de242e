// Kernels 2, 3 and 4: the fused complete projective G1 add, double and
// mixed add.
//
// Replace zktpu/curves/pallas_g1.py::_proj_add_call, _proj_double_call and
// _proj_madd_call.  One thread per point runs the whole RCB formula (g1.cuh)
// with every intermediate in registers: one launch and 9 (add), 6 (double) or
// 8 (mixed add) x 48 bytes of device memory per point.
//
// What bounds them on the H100: 32-bit integer multiply-adds (12 or 11
// Montgomery products of 2 x 300 word products), issued as one long chain
// of dependent carries per product, so the integer pipe is fed only when
// enough warps wait on each scheduler.  The add and the mixed add are
// designed for that:
// - the Montgomery product (field.cuh mont_mul_lazy) is PTX carry chains:
//   two chains of 12 multiply-adds per row, the carries in the condition
//   code;
// - reduction is lazy: intermediates stay below 2p, products skip their
//   final subtraction, sums of inputs feed products unreduced, and only the
//   three outputs are canonicalized (bounds in g1.cuh);
// - operands are re-read from memory where they are used, so fewer values
//   are live, and the launch bound asks for at least ZK_ADD_MIN_BLOCKS = 3
//   blocks of 128 threads per SM, which caps them at 168 registers with no
//   spills: 12 warps per SM instead of 8.  tools/g1_budgets.py builds
//   copies of this file at other budgets to time them;
// - every operand and output is a strided plane (g1.cuh Plane): slices and
//   broadcasts of (B, N, 12) planes are read in place, with no copy, and the
//   outputs can be any caller-given planes that do not overlap the inputs.
// The double (kernel 3) keeps canonical helpers and one block per SM.
// The Horner combine runs the MSM's chain of doubles and adds in one launch,
// one warp a point with lane-parallel products, and the fixed-base kernel an
// SRS's scalar multiplications, complete adds from a table staged in shared
// memory.
#include <cuda_runtime.h>

#include "g1.cuh"

#ifndef ZK_ADD_MIN_BLOCKS
#define ZK_ADD_MIN_BLOCKS 3
#endif

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS, ZK_ADD_MIN_BLOCKS)
proj_add_kernel(Planes<9> pl, uint32_t n, uint32_t inner, FqConsts f) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t o = i / inner;
  proj_add_at(pl, o, i - o * inner, f);
}

__global__ void __launch_bounds__(THREADS, ZK_ADD_MIN_BLOCKS)
proj_madd_kernel(Planes<8> pl, uint32_t n, uint32_t inner, FqConsts f) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t o = i / inner;
  proj_madd_at(pl, o, i - o * inner, f);
}

// One block said explicitly: with no minimum, ptxas held the double to 128
// registers and spilled.
__global__ void __launch_bounds__(THREADS, 1)
proj_double_kernel(Planes<6> pl, uint32_t n, uint32_t inner, FqConsts f) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t o = i / inner;
  proj_double_at(pl, o, i - o * inner, f);
}

// planes: N x (pointer, outer stride, inner stride), strides in rows (the
// wrapper keeps every row index below 2^31).
template <int N>
static Planes<N> make_planes(const int64_t* desc) {
  Planes<N> pl;
  for (int k = 0; k < N; ++k) {
    pl.p[k].ptr = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(desc[3 * k]));
    pl.p[k].so = (uint32_t)desc[3 * k + 1];
    pl.p[k].si = (uint32_t)desc[3 * k + 2];
  }
  return pl;
}

// The Horner combine of the MSM's window sums in one launch.
//
// Replaces the loop of zktpu/curves/msm.py:139-148 (a fori_loop of c
// proj_double calls, pallas_g1.py:211 _proj_double_call, and one proj_add,
// pallas_g1.py:125, per window), which the port ran as (W - 1)(c + 1)
// launches of a (K, 12) batch: 255 at c = 16, each about 25 us of device
// time behind 70-80 us of host time.
//
// What bounds it: the serial depth of the chain, (W - 1)(2c + 2) dependent
// steps of Montgomery products for each of K <= 8 points, so the latency of
// one product and of the sums between them, not throughput.  What the design
// does about it (g1.cuh): one warp a point; a formula step's products run
// at once, one a group of HORNER_P lanes, and each product is spread over
// its group's lanes by digits of 12 / HORNER_P words (horner_mul), so a
// lane's carry chains are HORNER_P times shorter; values stay below 2p or
// 4p (lazy reduction) and move between lanes by shuffles only, never
// through shared memory.  A block is one warp, so K points run on K SMs and
// no two share a scheduler.  tools/horner_lanes.py times the designs.
__global__ void __launch_bounds__(HORNER_THREADS, 1)
horner_combine_kernel(HornerArgs a, FqConsts f) {
  horner_point(a, blockIdx.x, threadIdx.x, f);
}

// One warp's chain of dependent lane-parallel products (tools/horner_lanes.py
// times it for the latency of one product).
__global__ void __launch_bounds__(HORNER_THREADS, 1)
horner_mul_chain_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out, uint32_t chain, FqConsts f) {
  horner_mul_chain(a, b, out, chain, threadIdx.x, f);
}

// The fixed-base window multiply in one launch.
//
// Replaces the fori_loop of zktpu/curves/g1.py:300-320 (fixed_base_mul_u32:
// per window a gather of the table rows and one proj_add, pallas_g1.py:125),
// which the port ran as 32 gathers and 32 proj_add launches over (N, 12)
// planes.  What bounds it: the 32-bit multiply-adds of its 32 complete adds
// a point.  What the design does about it (g1.cuh, "The fixed-base window
// multiply"): each window's X and Y rows are staged in shared memory by
// cp.async while the block adds the window before, so an add waits on no
// load from device memory; the accumulators live in shared memory too, so
// an add keeps only its temporaries in registers and the launch bound fits
// ZK_FB_MIN_BLOCKS = 2 blocks of ZK_FB_THREADS = 192 threads a SM, 12 warps
// (168 registers, 81 KB of shared memory a block at window 8; the carveout
// is set to its largest so that both fit); every digit runs the same
// straight-line add, Z2 chosen by a select and Z1 Z2 taken by one (11
// products).  tools/fixed_base_tiles.py
// builds copies of this file at other block sizes and budgets to time them.
#ifndef ZK_FB_MIN_BLOCKS
#define ZK_FB_MIN_BLOCKS 2
#endif

ZK_FN void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
ZK_FN void cp_async_wait_all_but_one() { asm volatile("cp.async.wait_group 1;"); }

__global__ void __launch_bounds__(FB_THREADS, ZK_FB_MIN_BLOCKS)
fixed_base_kernel(FixedBaseArgs a, FqConsts f) {
  extern __shared__ __align__(16) uint32_t smem[];
  const FbShared s = fb_shared(smem, a.window);
  const uint32_t t = threadIdx.x, i = blockIdx.x * FB_THREADS + t;
  fb_stage(a, s, 0, 0, t);
  cp_async_commit();
  fb_begin(a, s, i, t);
#pragma unroll 1
  for (uint32_t w = 0; w < a.windows; ++w) {
    if (w + 1 < a.windows) fb_stage(a, s, w + 1, (w + 1) & 1, t);
    cp_async_commit();  // empty after the last window: the wait below stays the same
    cp_async_wait_all_but_one();  // this thread's copies of window w have landed
    __syncthreads();              // and every thread's
    if (i < a.n) fb_add(a, s, w, w & 1, t, f);
    __syncthreads();  // buffer w & 1 is free for window w + 2
  }
  if (i < a.n) fb_end(a, s, i, t);
}

static const void* const KERNELS[] = {
    (const void*)proj_add_kernel, (const void*)proj_madd_kernel, (const void*)proj_double_kernel,
    (const void*)horner_combine_kernel, (const void*)fixed_base_kernel};

template <int N>
static int launch_kind(int kind, int device, const uint32_t* p, uint32_t pinv, const int64_t* planes,
                       int64_t n, int64_t inner, void* stream) {
  if (n >= (int64_t(1) << 31) || inner < 1) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Planes<N> pl = make_planes<N>(planes);
  FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  uint32_t n32 = (uint32_t)n, inner32 = (uint32_t)inner;
  void* args[] = {&pl, &n32, &inner32, &f};
  e = cudaLaunchKernel(KERNELS[kind], dim3((unsigned)((n + THREADS - 1) / THREADS)), dim3(THREADS), args, 0,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Each entry point computes its group operation for the n = outer x inner
// points of its planes (inputs, then x3, y3, z3) and returns
// cudaGetLastError() after the launch, or -1 for n >= 2^31.
extern "C" int zk_proj_add(int device, const uint32_t* p, uint32_t pinv, const int64_t* planes,
                           int64_t n, int64_t inner, void* stream) {
  return launch_kind<9>(0, device, p, pinv, planes, n, inner, stream);
}

extern "C" int zk_proj_madd(int device, const uint32_t* p, uint32_t pinv, const int64_t* planes,
                            int64_t n, int64_t inner, void* stream) {
  return launch_kind<8>(1, device, p, pinv, planes, n, inner, stream);
}

extern "C" int zk_proj_double(int device, const uint32_t* p, uint32_t pinv, const int64_t* planes,
                              int64_t n, int64_t inner, void* stream) {
  return launch_kind<6>(2, device, p, pinv, planes, n, inner, stream);
}

// sum_w 2^(c w) part_w for K points: parts = X, Y, Z of the (W, K, 12)
// window sums, out = X, Y, Z of the (K, 12) result, all contiguous.
// Returns cudaGetLastError() after the launch, or -1 for a bad size.
extern "C" int zk_horner_combine(int device, const uint32_t* p, uint32_t pinv, const int64_t* ptrs, int64_t W,
                                 int64_t K, int64_t c, void* stream) {
  if (W < 1 || K < 1 || c < 0 || W * K >= (int64_t(1) << 31)) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  HornerArgs a;
  for (int i = 0; i < 3; ++i) {
    a.parts[i] = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(ptrs[i]));
    a.out[i] = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(ptrs[3 + i]));
  }
  a.W = (uint32_t)W;
  a.K = (uint32_t)K;
  a.c = (uint32_t)c;
  FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  horner_combine_kernel<<<(unsigned)K, HORNER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, f);
  return (int)cudaGetLastError();
}

// x = a, then x = x b R^-1 `chain` times, by the combine's lane-parallel
// product: ptrs = a, b (canonical rows of 12 words), out, 16-byte aligned.
// Returns cudaGetLastError() after the launch, or -1 for a bad size.
extern "C" int zk_horner_mul_chain(int device, const uint32_t* p, uint32_t pinv, const int64_t* ptrs, int64_t chain,
                                   void* stream) {
  if (chain < 0 || chain >= (int64_t(1) << 31)) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const uint32_t* x[3];
  for (int i = 0; i < 3; ++i) x[i] = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(ptrs[i]));
  FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  horner_mul_chain_kernel<<<1, HORNER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x[0], x[1], const_cast<uint32_t*>(x[2]), (uint32_t)chain, f);
  return (int)cudaGetLastError();
}

// The Horner combine's design as built: out = {lanes a product, products at once}.
extern "C" int zk_horner_design(int* out) {
  out[0] = HORNER_P;
  out[1] = HORNER_G;
  return 0;
}

// [s_i] B for n scalars: ptrs = X, Y of the (windows, 2^window, 12) table
// (row 0 of each window O, the others affine), the (n, 8) scalars, then X,
// Y, Z of the (n, 12) result, all contiguous and 16-byte aligned; window
// divides 32 and is at most 8.  Returns cudaGetLastError() after the
// launch, or -1 for a bad size.
extern "C" int zk_fixed_base_mul(int device, const uint32_t* p, uint32_t pinv, const int64_t* ptrs, int64_t n,
                                 int window, void* stream) {
  if (n < 1 || n >= (int64_t(1) << 31) || window < 1 || window > (int)FB_MAX_WINDOW || 32 % window) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  FixedBaseArgs a;
  for (int k = 0; k < 2; ++k) a.table[k] = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(ptrs[k]));
  a.scalars = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(ptrs[2]));
  for (int k = 0; k < 3; ++k) a.out[k] = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(ptrs[3 + k]));
  a.n = (uint32_t)n;
  a.window = (uint32_t)window;
  a.windows = 256u / (uint32_t)window;
  const int smem = (int)(fb_shared_words(a.window) * sizeof(uint32_t));
  e = cudaFuncSetAttribute(fixed_base_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fixed_base_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  FqConsts f = make_consts<FQ_LIMBS>(p, pinv);
  fixed_base_kernel<<<(unsigned)((n + FB_THREADS - 1) / FB_THREADS), FB_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(a, f);
  return (int)cudaGetLastError();
}

// The fixed-base kernel's design as built: out = {threads a block, minimum
// blocks a SM of its launch bound}.
extern "C" int zk_fixed_base_design(int* out) {
  out[0] = (int)FB_THREADS;
  out[1] = ZK_FB_MIN_BLOCKS;
  return 0;
}

// Registers per thread, local memory (spills) and shared memory of one
// kernel: kind 0 add, 1 mixed add, 2 double, 3 Horner combine, 4 the
// fixed-base multiply (its dynamic shared memory at window 8 included).
// out = {registers, local bytes, shared bytes}.
extern "C" int zk_g1_kernel_attrs(int kind, int* out) {
  if (kind < 0 || kind > 4) return -1;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, KERNELS[kind]);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes + (kind == 4 ? (int)(fb_shared_words(8) * sizeof(uint32_t)) : 0);
  return 0;
}
