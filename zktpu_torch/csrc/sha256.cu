// The field hash of FRI's Merkle trees: SHA-256 of decimal strings, mapped
// into Goldilocks, one thread per hash (per-thread code in sha256.cuh).
//
// Replaces zktpu/hash/sha256_vec.py: the numpy block building
// (_decimal_digits, _place_decimal, _finalize_blocks, _blocks_single and
// _blocks_pairs, :81-144), the jitted compression sha256_single_block (:53)
// and the digest fold _digest_to_field_traced (:159-179), run in chunks of
// 4,096 blocks with a host round trip each.  Here a level of the tree goes
// from canonical values on the card to canonical values on the card in
// one launch: mode 0 hashes each value, mode 1 each consecutive pair (a
// trailing singleton alone, in a second launch: the reference's hash_slice
// of one element).
//
// What bounds it on the H100: 32-bit integer operations.  A hash compiles
// to about 1,780 of them (single) or 2,125 (pair; sm_90a SASS, counted by
// tools/prof_fri.py --sass): the decimal conversion (20 steps of a 64-bit
// multiply-high by the reciprocal of 10 per value), the message schedule
// (48 words) and the 64 rounds (their rotates are funnel shifts, their
// three-input logic one LOP3), the digest fold (8 byte swaps and 10
// additions mod p); its bytes are 8 or 16 in and 8 out.  About 60% of the
// operations are shifts and logic, which only the integer ALU pipe runs.
// What the design does about it:
// - one thread per hash, everything in registers: the message, the
//   schedule's ring of 16 words and the state; the round constants are
//   immediates of the unrolled rounds; no shared memory and no
//   synchronisation, so many warps per SM hide the dependent chains;
// - the variable-length layout (the digits of a at byte 0, b's after
//   them, then 0x80) is built by barrel shifts with compile-time word
//   indices, never an array indexed at run time (no local memory);
// - the fold reduces 2^(32 i) by the shape of p = 2^64 - 2^32 + 1 (no
//   Montgomery products): its result is canonical, the same integer as the
//   reference's Montgomery fold.
#include <cuda_runtime.h>

#include "sha256.cuh"

#ifndef ZK_SHA_THREADS
#define ZK_SHA_THREADS 128
#endif

// PAIRS = 0: out[i] = hash(in[i]) for i < n_out; PAIRS = 1: out[i] =
// hash_slice(in[2i], in[2i + 1]).  Values are rows of two u32 words,
// little-endian, 16-byte aligned.  Each mode is its own straight-line
// kernel (no branch on the mode), so its SASS is one hash's instructions.
template <int PAIRS>
__global__ void __launch_bounds__(ZK_SHA_THREADS)
sha256_field_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t n_out) {
  const int64_t i = (int64_t)blockIdx.x * ZK_SHA_THREADS + threadIdx.x;
  if (i >= n_out) return;
  uint64_t a, b = 0;
  if (PAIRS) {
    const uint4 v = reinterpret_cast<const uint4*>(in)[i];
    a = v.x | (uint64_t)v.y << 32;
    b = v.z | (uint64_t)v.w << 32;
  } else {
    const uint2 v = reinterpret_cast<const uint2*>(in)[i];
    a = v.x | (uint64_t)v.y << 32;
  }
  const uint64_t h = sha256_field_hash(a, b, PAIRS != 0);
  reinterpret_cast<uint2*>(out)[i] = make_uint2((uint32_t)h, (uint32_t)(h >> 32));
}

template <int PAIRS>
static cudaError_t sha256_launch(const void* in, void* out, int64_t n_out, cudaStream_t stream) {
  const int64_t blocks = (n_out + ZK_SHA_THREADS - 1) / ZK_SHA_THREADS;
  sha256_field_kernel<PAIRS><<<(unsigned)blocks, ZK_SHA_THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n_out);
  return cudaGetLastError();
}

// The hashes of n_in canonical Goldilocks values at `in` into `out`: n_in
// rows (pairs = 0), or ceil(n_in / 2) (pairs = 1; for an odd n_in a second
// launch hashes the last value alone into the last row, the reference's
// hash_slice of one element).  Returns cudaGetLastError() after the last
// launch (or -1 for bad arguments) and the number of launches in *launched.
extern "C" int zk_sha256_field(int device, const void* in, void* out, int64_t n_in, int pairs, void* stream,
                               int* launched) {
  *launched = 0;
  if (n_in < 1 || (pairs != 0 && pairs != 1)) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!pairs) {
    e = sha256_launch<0>(in, out, n_in, st);
    *launched += e == cudaSuccess;
    return (int)e;
  }
  const int64_t n_pairs = n_in / 2;
  if (n_pairs > 0) {
    e = sha256_launch<1>(in, out, n_pairs, st);
    if (e != cudaSuccess) return (int)e;
    *launched += 1;
  }
  if (n_in % 2) {
    e = sha256_launch<0>(static_cast<const uint32_t*>(in) + 2 * (n_in - 1),
                         static_cast<uint32_t*>(out) + 2 * n_pairs, 1, st);
    *launched += e == cudaSuccess;
  }
  return (int)e;
}

// out = {registers, local bytes, shared bytes per block}, the larger of the
// two modes' kernels.
extern "C" int zk_sha256_attrs(int* out) {
  out[0] = out[1] = out[2] = 0;
  for (int mode = 0; mode < 2; ++mode) {
    cudaFuncAttributes a;
    const cudaError_t e = mode ? cudaFuncGetAttributes(&a, sha256_field_kernel<1>)
                               : cudaFuncGetAttributes(&a, sha256_field_kernel<0>);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs > out[0] ? a.numRegs : out[0];
    out[1] = (int)a.localSizeBytes > out[1] ? (int)a.localSizeBytes : out[1];
    out[2] = (int)a.sharedSizeBytes > out[2] ? (int)a.sharedSizeBytes : out[2];
  }
  return 0;
}
