// The NTT over Fr (L = 8) and Goldilocks (L = 2): bit reversal, radix-2 DIT
// stages and the factors at both ends.  Over Fr it takes
// 1 + ceil((log n - 9) / 6) launches (3 at 2^17 and 2^20, 4 at 2^23); over
// Goldilocks one launch up to 2^11 points, two from 2^12 to 2^20 and three
// from 2^21 to 2^30 (ntt_gl.cuh's plan).
//
// Replaces the stage loop of zktpu/poly/domain.py::_transform (a jnp graph
// of log n stages, each a Montgomery product by kernel 1,
// zktpu/fields/pallas_mont.py:363, and a tensor add, sub and concatenate).
// In the port that loop cost one product launch, a copy of the strided odd
// half and about 80 small tensor ops per stage.
//
// Fr.  What bounds it on the H100: 32-bit integer multiply-adds.  A
// transform does (n/2) log n products of 2 L^2 + L = 136 word products,
// each two multiply-adds (low and high halves), plus n products for each
// factor; its bytes (each element read and written once per pass) take a
// small share of that time.  What the design does about it:
// - the stages of a pass run in shared memory (ntt.cuh): a block loads a
//   tile of 2^9 elements (16 KB), runs up to 9 stages on it with a barrier
//   between stages and writes it once, so memory sees each element twice
//   per pass instead of twice per stage, and there are 3-4 launches
//   instead of 17-23 stages of launches;
// - the first pass gathers its tile through the bit reversal and multiplies
//   by the input factor (the coset offset powers) as it loads; the last
//   pass multiplies by the output factor (n^-1, or n^-1 offset^-i) as it
//   stores: no separate pass for the permutation or the factors;
// - one thread runs a whole butterfly: field.cuh's carry-chain product,
//   then the add and the sub with one conditional correction each;
//   twiddles are read from the domain's power table (L2-resident);
// - small blocks, many per SM: 128 threads and at least 8 blocks per SM
//   (so at most 64 registers; 128 KB of shared memory), 32 warps per SM to
//   feed the integer pipes through the dependent carry chains, and while
//   one block waits at a barrier the others run (zktpu_torch/tools/
//   ntt_tiles.py times other tiles).
//
// Goldilocks.  A product is four 32 x 32-bit word products (field.cuh's
// gl_mul: the reduction is carry chains of adds), so the transform's
// multiply-adds take less time than its bytes: two reads and two writes of
// every word at 2^20, 32 MB, against the (n/2) log n products' 84 M
// multiply-adds.  What held the L = 2 instance of the Fr design back was
// everything around the product: a barrier and a shared-memory round trip
// per stage, a strided device-memory twiddle load per butterfly, the
// two-limb CIOS product, and three passes at 2^20.  The design
// (ntt_gl.cuh):
// - a thread holds 8 elements in registers and runs 3 stages on them
//   (radix-8 steps), so a pass of 10 stages has 4 barriers, not 11, and
//   the tile goes through shared memory once per 3 stages; 16 elements a
//   thread (radix 16) took 102 registers or spilled at 64, and ran 1.3x
//   slower at 2^20 (zktpu_torch/tools/ntt_tiles.py);
// - tiles of up to 2^13 words (64 KB) of 2^10 rows x 8 columns, two
//   passes from 2^12 to 2^20 points; a later pass multiplies each word by
//   one column twiddle as it loads, so that its stages are plain
//   2^ns-point transforms whose twiddles every block stages once into
//   shared memory (2^ns - 1 words);
// - the first pass reads rows of 8 consecutive input words (64 bytes)
//   through the bit reversal, and each pass writes runs of at least 8
//   words; the factors are fused into the first load and the last store as
//   for Fr (the raw 1 as the output factor makes FRI's from_mont);
// - up to 1024 threads a block (at most 64 registers; 60 used).
#include <cuda_runtime.h>

#include "ntt.cuh"
#include "ntt_gl.cuh"

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

#ifndef ZK_NTT_GL_MIN_BLOCKS
#define ZK_NTT_GL_MIN_BLOCKS 1
#endif

__global__ void __launch_bounds__(GL_MAX_THREADS, ZK_NTT_GL_MIN_BLOCKS) ntt_gl_kernel(GlArgs a) {
  extern __shared__ uint64_t ntt_gl_smem[];
  uint64_t x[GL_E];
  const uint32_t tile = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  gl_load_thread(a, tile, row, tid, x, ntt_gl_smem);
  __syncthreads();
  const int steps = gl_steps(a.pass);
  for (int j = 0; j < steps; ++j) {
    gl_step_thread(a, tile, row, j, tid, x, ntt_gl_smem);
    if (j + 1 < steps) __syncthreads();
  }
}

// The most shared memory a Goldilocks pass takes, in bytes.
static size_t ntt_gl_max_smem() {
  size_t most = 0;
  GlPass passes[GL_MAX_PASSES];
  for (int log_n = 0; log_n <= 30; ++log_n) {
    const int np = gl_ntt_plan(log_n, passes);
    for (int k = 0; k < np; ++k) {
      const size_t b = (size_t)gl_smem_words(passes[k]) * sizeof(uint64_t);
      most = b > most ? b : most;
    }
  }
  return most;
}

static int ntt_gl_launch(const void* in, void* out, int64_t batch, int log_n, const void* tw, const void* in_f,
                         int64_t in_fs, const void* out_f, int64_t out_fs, void* stream, int* launched) {
  GlPass passes[GL_MAX_PASSES];
  const int np = gl_ntt_plan(log_n, passes);
  if (np < 0) return -1;
  cudaError_t e = cudaFuncSetAttribute(ntt_gl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)ntt_gl_max_smem());
  if (e != cudaSuccess) return (int)e;
  for (int k = 0; k < np; ++k) {
    GlArgs a;
    a.in = static_cast<const uint64_t*>(in);
    a.out = static_cast<uint64_t*>(out);
    a.tw = static_cast<const uint64_t*>(tw);
    a.in_f = static_cast<const uint64_t*>(in_f);
    a.out_f = static_cast<const uint64_t*>(out_f);
    a.in_fs = (uint32_t)in_fs;
    a.out_fs = (uint32_t)out_fs;
    a.log_n = log_n;
    a.pass = passes[k];
    a.first = k == 0;
    a.last = k == np - 1;
    const size_t smem = (size_t)gl_smem_words(a.pass) * sizeof(uint64_t);
    ntt_gl_kernel<<<dim3(gl_tiles(a), (unsigned)batch), gl_threads(a.pass), smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
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
    case 2:  // Goldilocks: p is the constant of field.cuh
      return ntt_gl_launch(in, out, batch, log_n, tw, in_f, in_fs, out_f, out_fs, stream, launched);
    default:
      return -1;
  }
}

// The Goldilocks plan of a 2^log_n transform: returns its passes (or -1)
// and writes {s0, ns, cols, threads, shared bytes, radix steps} of each to
// out (6 ints a pass, at most 32 passes).
extern "C" int zk_ntt_gl_plan(int log_n, int* out) {
  if (log_n < 0 || log_n > 30) return -1;
  GlPass passes[GL_MAX_PASSES];
  const int np = gl_ntt_plan(log_n, passes);
  for (int k = 0; k < np; ++k) {
    const GlPass& p = passes[k];
    int* o = out + 6 * k;
    o[0] = p.s0;
    o[1] = p.ns;
    o[2] = p.cols;
    o[3] = (int)gl_threads(p);
    o[4] = (int)(gl_smem_words(p) * sizeof(uint64_t));
    o[5] = gl_steps(p);
  }
  return np;
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
    case 2: {
      cudaFuncAttributes a;
      const cudaError_t e = cudaFuncGetAttributes(&a, ntt_gl_kernel);
      if (e != cudaSuccess) return (int)e;
      out[0] = a.numRegs;
      out[1] = (int)a.localSizeBytes;
      out[2] = (int)(a.sharedSizeBytes + ntt_gl_max_smem());
      return 0;
    }
    default:
      return -1;
  }
}
