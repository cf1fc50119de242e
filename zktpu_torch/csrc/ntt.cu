// The NTT over Fr (L = 8) and Goldilocks (L = 2): bit reversal, radix-2 DIT
// stages and the factors at both ends.  Over Fr one launch up to 2^10
// points, two from 2^11 to 2^18, three from 2^19 to 2^27 and four above
// (ntt.cuh's plan); over Goldilocks one launch up to 2^11 points, two from
// 2^12 to 2^20 and three from 2^21 to 2^30 (ntt_gl.cuh's plan).
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
// small share of that time.  The first design (a stage per barrier, one
// butterfly a thread, a twiddle load from device memory per butterfly,
// canonical values after every operation, field.cuh's product) reached
// 44% of that bound; its SASS showed why: field.cuh's product issues an
// IMAD, an IMAD.HI and about 1.7 IADD3.X a word product (568 instructions
// a product), the carries riding separate adds.  What the design does
// about it (ntt.cuh):
// - its own product, ntt_mul: the chains split by the parity of the
//   words so that the two halves of each word product sit side by side in
//   one carry chain, which the card issues as one IMAD.WIDE.U32.X (200
//   instructions a product, the same words out);
// - a thread holds 4 elements in registers and runs 2 stages on them
//   (radix-4 steps), so a pass of 9 stages has 5 barriers, not 10, and the
//   tile goes through shared memory once per 2 stages; a call of at most
//   2^16 elements in all, which fills a fraction of the card, takes radix-2
//   steps instead (twice the threads, each with a shorter chain of
//   products);
// - every block stages its pass's twiddles into shared memory once, 16
//   bytes a thread at a time, before its first step: the first pass's
//   2^ns - 1, a later pass's 2^ns - 1 for each of its columns (strided in
//   the table of gen^i); no butterfly reads a twiddle from device memory;
// - the first pass's first step skips the products by 1 (3 of its 4);
// - values stay lazy, in [0, 2p), inside and between passes (Harvey's
//   butterfly: the product's output < 1.91 p, one conditional subtraction
//   of 2p for the sum and the difference each); the last store
//   canonicalizes once, with the output factor;
// - the first pass gathers through the bit reversal and multiplies by the
//   input factor (the coset offset powers) as it loads; the last pass
//   multiplies by the output factor (n^-1, or n^-1 offset^-i) as it
//   stores: no separate pass for the permutation or the factors;
// - tiles of up to 2^10 elements (256 threads at radix 4, 2 blocks a SM:
//   at most 128 registers; 104 used), at least two warps a block (a
//   half-warp block at 2^11 x 2048 ran 1.5x slower);
//   zktpu_torch/tools/ntt_tiles.py sweeps the tile, its columns, the blocks
//   per SM, the thread floor and the radix-2 cut.
//
// Goldilocks.  A product is four 32 x 32-bit word products (field.cuh's
// gl_mul: the reduction is carry chains of adds), so the transform's
// multiply-adds take less time than its bytes: two reads and two writes of
// every word at 2^20, 32 MB, against the (n/2) log n products' 84 M
// multiply-adds.  What held the L = 2 instance of the first Fr design back
// was everything around the product: a barrier and a shared-memory round
// trip per stage, a strided device-memory twiddle load per butterfly, the
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
#define ZK_NTT_MIN_BLOCKS 2  // 256 threads x 2 blocks at radix 4: at most 128 registers
#endif

// A pass in radix-2^K steps: 2^K elements a thread.
template <int K>
__global__ void __launch_bounds__(ntt_max_threads(K), ZK_NTT_MIN_BLOCKS) ntt_pass_kernel(NttArgs a, FrConsts f) {
  extern __shared__ uint4 ntt_smem[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(ntt_smem);
  uint32_t x[(1 << K) * NTT_L];
  const uint32_t tile = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  ntt_load_thread<K>(a, tile, row, tid, x, smem, f);
  __syncthreads();
  const int steps = ntt_steps(a.pass);
  for (int j = 0; j < steps; ++j) {
    ntt_step_thread<K>(a, tile, row, j, tid, x, smem, f);
    if (j + 1 < steps) __syncthreads();
  }
}

// The most shared memory a Fr pass in radix-2^k steps takes, in bytes.
static size_t ntt_max_smem(int k) {
  size_t most = 0;
  NttPass passes[NTT_MAX_PASSES];
  for (int log_n = 0; log_n <= 30; ++log_n) {
    const int np = ntt_plan(log_n, k, passes);
    for (int i = 0; i < np; ++i) most = ntt_smem_bytes(passes[i]) > most ? ntt_smem_bytes(passes[i]) : most;
  }
  return most;
}

template <int K>
static int ntt_launch_k(const FrConsts& f, const NttArgs& args, const NttPass* passes, int np, int64_t batch,
                        cudaStream_t stream, int* launched) {
  cudaError_t e = cudaFuncSetAttribute(ntt_pass_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)ntt_max_smem(K));
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < np; ++i) {
    NttArgs a = args;
    a.pass = passes[i];
    a.first = i == 0;
    a.last = i == np - 1;
    ntt_pass_kernel<K><<<dim3(ntt_tiles(a), (unsigned)batch), ntt_threads(a.pass), ntt_smem_bytes(a.pass), stream>>>(
        a, f);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    *launched += 1;
  }
  return 0;
}

static int ntt_launch(const uint32_t* p, uint32_t pinv, const void* in, void* out, int64_t batch, int log_n,
                      const void* tw, const void* in_f, int64_t in_fs, const void* out_f, int64_t out_fs,
                      void* stream, int* launched) {
  const int k = ntt_radix_log(log_n, batch);
  NttPass passes[NTT_MAX_PASSES];
  const int np = ntt_plan(log_n, k, passes);
  if (np < 0) return -1;
  NttArgs a{};
  a.in = static_cast<const uint32_t*>(in);
  a.out = static_cast<uint32_t*>(out);
  a.tw = static_cast<const uint32_t*>(tw);
  a.in_f = static_cast<const uint32_t*>(in_f);
  a.out_f = static_cast<const uint32_t*>(out_f);
  a.in_fs = (uint32_t)in_fs;
  a.out_fs = (uint32_t)out_fs;
  a.log_n = log_n;
  const FrConsts f = make_consts<NTT_L>(p, pinv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k == 1 ? ntt_launch_k<1>(f, a, passes, np, batch, s, launched)
                : ntt_launch_k<2>(f, a, passes, np, batch, s, launched);
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
      return ntt_launch(p, pinv, in, out, batch, log_n, tw, in_f, in_fs, out_f, out_fs, stream, launched);
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

// The Fr plan of `batch` transforms of 2^log_n, as zk_ntt_gl_plan: returns
// its passes (or -1) and writes {s0, ns, cols, threads, shared bytes, radix
// steps, log2 radix} of each to out (7 ints a pass, at most 32 passes).
extern "C" int zk_ntt_fr_plan(int log_n, int64_t batch, int* out) {
  if (log_n < 0 || log_n > 30 || batch < 1 || batch > 65535) return -1;
  NttPass passes[NTT_MAX_PASSES];
  const int np = ntt_plan(log_n, ntt_radix_log(log_n, batch), passes);
  for (int k = 0; k < np; ++k) {
    const NttPass& p = passes[k];
    int* o = out + 7 * k;
    o[0] = p.s0;
    o[1] = p.ns;
    o[2] = p.cols;
    o[3] = (int)ntt_threads(p);
    o[4] = (int)ntt_smem_bytes(p);
    o[5] = ntt_steps(p);
    o[6] = p.k;
  }
  return np;
}

// The Fr design the library was built with: out = {log2 of the largest call
// (batch x n elements) in radix-2 steps, log2 largest tile, log2 columns of
// a multi-pass tile, largest log n in one pass, minimum blocks per SM, log2
// of a multi-pass block's fewest threads}.
extern "C" int zk_ntt_fr_design(int* out) {
  out[0] = ZK_NTT_RADIX2_WORK;
  out[1] = ZK_NTT_LOG_TILE;
  out[2] = ZK_NTT_LOG_COLS;
  out[3] = ZK_NTT_ONE_PASS;
  out[4] = ZK_NTT_MIN_BLOCKS;
  out[5] = ZK_NTT_LOG_MIN_THREADS;
  return 0;
}

// Registers per thread, local memory (spills) and the shared memory a block
// of the largest tile takes, for the kernel of `limbs` words (Fr: the one of
// radix 2^radix_log, 1 or 2): out = {registers, local bytes, shared bytes}.
extern "C" int zk_ntt_attrs(int limbs, int radix_log, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  size_t smem;
  switch (limbs) {
    case 8:
      if (radix_log != 1 && radix_log != 2) return -1;
      e = radix_log == 1 ? cudaFuncGetAttributes(&a, ntt_pass_kernel<1>) : cudaFuncGetAttributes(&a, ntt_pass_kernel<2>);
      smem = ntt_max_smem(radix_log);
      break;
    case 2:
      e = cudaFuncGetAttributes(&a, ntt_gl_kernel);
      smem = ntt_gl_max_smem();
      break;
    default:
      return -1;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + smem);
  return 0;
}
