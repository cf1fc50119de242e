// The field hash of zktpu_torch/hash/sha256_kernel.py as per-thread code
// (csrc/sha256.cu runs one thread per hash on the card; tests/sha256_host.cpp
// runs the same function on the CPU).
//
// FRI's Merkle trees hash field elements as the reference does
// (fri/src/hasher.rs, zktpu/hash/host_hash.py):
//     hash(x)          = SHA256(decimal(x))              mod p
//     hash_slice(a, b) = SHA256(decimal(a) || decimal(b)) mod p
// where decimal() is the canonical value's decimal string (1 to 20 ASCII
// digits for Goldilocks, p = 2^64 - 2^32 + 1) and the digest maps into the
// field by from_le_bytes_mod_order.  A pair's message is at most 40 bytes,
// so it and its padding (the 0x80 byte, zeros, the bit length in the last
// 8 bytes) fit one 64-byte block: one compression per hash.
//
// Everything stays in registers: the digits are placed at compile-time
// byte positions of a right-aligned buffer, and the run-time lengths move
// the strings into place by barrel shifts (whole words under a condition,
// then a funnel shift by 0-3 bytes), so no array is indexed at run time.
#pragma once

#include <cstdint>
#include <cstring>

#ifndef ZK_FN
#if defined(__CUDACC__)
#define ZK_FN __device__ __forceinline__
#else
#define ZK_FN inline
#endif
#endif

namespace sha {

constexpr uint64_t GL_P = 0xFFFFFFFF00000001ull;  // Goldilocks: 2^64 - 2^32 + 1

ZK_FN uint32_t rotr(uint32_t x, int n) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32 - n));
#endif
}

ZK_FN uint32_t bswap(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0, 0x0123);
#else
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
#endif
}

// The high word of (hi:lo) << s, and the low word of (hi:lo) >> s, s < 32.
ZK_FN uint32_t fshl(uint32_t lo, uint32_t hi, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(lo, hi, s);
#else
  return s == 0 ? hi : (hi << s) | (lo >> (32 - s));
#endif
}

ZK_FN uint32_t fshr(uint32_t lo, uint32_t hi, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, s);
#else
  return s == 0 ? lo : (lo >> s) | (hi << (32 - s));
#endif
}

// x / 10 for any 64-bit x: the high half of x times ceil(2^67 / 10), >> 3
// (no emulated 64-bit divide).
ZK_FN uint64_t div10(uint64_t x) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(x, 0xCCCCCCCCCCCCCCCDull) >> 3;
#else
  return (uint64_t)(((unsigned __int128)x * 0xCCCCCCCCCCCCCCCDull) >> 64) >> 3;
#endif
}

// A big-endian byte string in N words (word 0 holds bytes 0-3, byte 0 on
// top) moved toward byte 0 by s bytes (s < 32), zeros shifted in.
template <int N>
ZK_FN void shl_bytes(uint32_t* w, uint32_t s) {
#pragma unroll
  for (int k = 4; k >= 1; k >>= 1) {
    if (s & (4u * k)) {
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = i + k < N ? w[i + k] : 0u;
    }
  }
  const uint32_t bits = 8 * (s & 3);
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = fshl(i + 1 < N ? w[i + 1] : 0u, w[i], bits);
}

// The same string moved away from byte 0 by s bytes (s < 32).
template <int N>
ZK_FN void shr_bytes(uint32_t* w, uint32_t s) {
#pragma unroll
  for (int k = 4; k >= 1; k >>= 1) {
    if (s & (4u * k)) {
#pragma unroll
      for (int i = N - 1; i >= 0; --i) w[i] = i >= k ? w[i - k] : 0u;
    }
  }
  const uint32_t bits = 8 * (s & 3);
#pragma unroll
  for (int i = N - 1; i >= 0; --i) w[i] = fshr(w[i], i >= 1 ? w[i - 1] : 0u, bits);
}

// The decimal string of x right-aligned in the 20 bytes w[0..4] (its last
// digit is the low byte of w[4]; the bytes before it hold '0'); returns its
// length, 1 to 20.
ZK_FN int decimal_right(uint64_t x, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = 0;
  int len = 1;
#pragma unroll
  for (int j = 0; j < 20; ++j) {
    if (j > 0 && x != 0) len = j + 1;
    const uint64_t q = div10(x);
    const uint32_t d = (uint32_t)(x - q * 10);
    w[4 - j / 4] |= (0x30u + d) << (8 * (j % 4));
    x = q;
  }
  return len;
}

// The padded block of decimal(a) || decimal(b) (pair) or decimal(a):
// m[0..15], big-endian words.
ZK_FN void message(uint64_t a, uint64_t b, bool pair, uint32_t* m) {
  uint32_t A[5];
  const int la = decimal_right(a, A);
  shl_bytes<5>(A, 20 - la);  // decimal(a) at bytes 0 .. la - 1
  // B: decimal(b) then the 0x80 byte, at bytes 0 .. lb (just 0x80 alone)
  uint32_t B[11];
  int lb = 0;
#pragma unroll
  for (int i = 0; i < 11; ++i) B[i] = 0;
  if (pair) {
    lb = decimal_right(b, B);
    B[5] = 0x80000000u;
    shl_bytes<6>(B, 20 - lb);
  } else {
    B[0] = 0x80000000u;
  }
  shr_bytes<11>(B, la);  // after decimal(a): the message reaches byte la + lb <= 40
#pragma unroll
  for (int i = 0; i < 11; ++i) m[i] = i < 5 ? A[i] | B[i] : B[i];
  m[11] = m[12] = m[13] = m[14] = 0;
  m[15] = 8u * (la + lb);  // the bit length, < 2^32
}

// One SHA-256 compression of the block m from the initial state: h[0..7].
ZK_FN void compress(const uint32_t* m, uint32_t* h) {
  const uint32_t K[64] = {
      0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
      0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
      0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
      0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
      0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
      0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
      0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
      0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
  };
  const uint32_t H0[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19};
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  uint32_t a = H0[0], b = H0[1], c = H0[2], d = H0[3], e = H0[4], f = H0[5], g = H0[6], hh = H0[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {  // the schedule in a ring of 16 words
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = hh + S1 + ch + K[t] + w[t & 15];
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  h[0] = a + H0[0];
  h[1] = b + H0[1];
  h[2] = c + H0[2];
  h[3] = d + H0[3];
  h[4] = e + H0[4];
  h[5] = f + H0[5];
  h[6] = g + H0[6];
  h[7] = hh + H0[7];
}

// Canonical Goldilocks add and sub of canonical values.
ZK_FN uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) {
    s += 0xFFFFFFFFull;  // a + b - 2^64 + (2^64 - p)
  } else if (s >= GL_P) {
    s -= GL_P;
  }
  return s;
}

ZK_FN uint64_t gl_sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d - 0xFFFFFFFFull : d;  // a - b + 2^64 - (2^64 - p)
}

// from_le_bytes_mod_order of the digest: the little-endian 256-bit value
// sum_i v_i 2^(32 i), v_i = bswap(h_i), mod p.  With 2^64 = 2^32 - 1,
// 2^96 = -1, 2^128 = -2^32, 2^160 = 1 - 2^32, 2^192 = 1 and 2^224 = 2^32
// (mod p), it is v0 + v1 2^32 + v2 (2^32 - 1) - v3 - v4 2^32
// + v5 (1 - 2^32) + v6 + v7 2^32, and each v 2^32 <= p - 1 is canonical.
ZK_FN uint64_t digest_to_field(const uint32_t* h) {
  uint64_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = bswap(h[i]);
  uint64_t acc = v[0];
  acc = gl_add(acc, v[1] << 32);
  acc = gl_add(acc, v[2] << 32);
  acc = gl_sub(acc, v[2]);
  acc = gl_sub(acc, v[3]);
  acc = gl_sub(acc, v[4] << 32);
  acc = gl_add(acc, v[5]);
  acc = gl_sub(acc, v[5] << 32);
  acc = gl_add(acc, v[6]);
  acc = gl_add(acc, v[7] << 32);
  return acc;
}

}  // namespace sha

// One thread's hash: hash_slice([a, b]) when `pair`, else hash(a), for
// canonical Goldilocks values; returns the canonical field element.
ZK_FN uint64_t sha256_field_hash(uint64_t a, uint64_t b, bool pair) {
  uint32_t m[16], h[8];
  sha::message(a, b, pair, m);
  sha::compress(m, h);
  return sha::digest_to_field(h);
}
