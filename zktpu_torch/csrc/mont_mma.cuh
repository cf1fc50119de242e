// The chained Montgomery product with its two constant convolutions on the
// tensor cores: the per-warpgroup code of kernels 5m and 5f (mont_mma.cu).
//
// Replaces the "mxu" and "f32" bodies of tools/prof_mulkernels.py::make_chain
// (RowOpsMXU.mul and RowOpsF32.conv_full), the structure of the reference's
// production product for D >= 16 (zktpu/fields/pallas_mont.py RowOps.mul
// with _const_mxu).  One product x * y * R^{-1} mod p is
//
//   1. t = x y, 2L words: the variable convolution.  "mxu": on the integer
//      multiply-add pipe, as chains split by the parity of i + j
//      (conv_split: each word product one 64-bit multiply-add with carry);
//      "f32": FP32 FMAs over 8-bit digits into two sums per column (A:
//      lo*lo at offset i + j, hi*hi at i + j + 1; B: lo*hi + hi*lo at
//      i + j, weight 256), exact because every sum stays below 2^24;
//   2. m_cols = (t mod R) * (-p^{-1}) as D base-2^16 column sums, on the
//      tensor cores; m = their value mod R;
//   3. mp_cols = m * p as 2D column sums, on the tensor cores;
//   4. (t + m p) / R from t and mp_cols.  The chain keeps x below 2p and
//      subtracts p once at its end.
//
// Steps 2 and 3 are u8 matrix products on Hopper's warpgroup tensor-core
// instruction, wgmma.mma_async m64nNk32 .s32.u8.u8: 64 elements (rows of
// A: the 2D bytes of the operand, in natural order, k = byte) against a
// constant matrix B of fields/mont_mats.py::kernel_mats (N = 2S rows
// n = 2 s + w: the weight-1 and weight-256 digit products of column s side
// by side, so that an accumulator pair d[4i], d[4i + 1] is one column:
// d[4i] + (d[4i + 1] << 8)).  Each sum is at most 2D * 255^2 < 2^22 and the
// combined column below 2^31.  K is 2D bytes in k-steps of 32 (Fq 2, the
// second half zero in B; Fr 1).  wgmma takes a whole N range, so the band's
// zero blocks inside it are multiplied too: Fq issues 9,216 u8
// multiply-accumulates an element and product against the band's 6,656,
// Fr 3,072 (its band fills every block).
//
// Layout: a block is one warpgroup of 128 threads, each thread one element,
// the warpgroup two 64-row tiles.  Shared memory holds
//   - the two constant matrices, staged once a block by cp.async in the
//     layout the wgmma B descriptor reads: K-major core matrices of 8 rows
//     x 16 bytes without swizzle, 128 bytes apart along k (LBO) and
//     KP / 16 * 128 bytes apart along n (SBO).  No B fragment lives in a
//     register;
//   - the operand rows: each element's thread writes its bytes once a
//     product (16-byte stores, the 8 words of a k-step in the order
//     0 4 1 5 2 6 3 7, rows RS bytes apart), and each thread loads its A
//     fragments from them with two 8-byte loads a tile and k-step: wgmma
//     takes A from registers, so no store needs the async proxy's fence;
//   - one row of CS words an element for the column sums, which each thread
//     stores from its accumulators and the element's thread reads back as
//     16-byte loads.  CS = 2D + 4 (4 times an odd number) keeps the stores
//     and the loads free of bank conflicts, as RS (32 bytes past a multiple
//     of 64) does the fragment loads.
// With two tiles in flight (MmaDesign) both tiles' products are issued
// before the first is waited for (wgmma.wait_group 1), so the stores of one
// tile's columns overlap the tensor cores' work on the other's.
//
// As host C++ the test shim (tests/mont_mma_host.cpp) runs a warpgroup as
// 128 threads: wg_bar() is a barrier of the 128, and wgmma_u8 rebuilds A,
// B and D from the register fragments and the shared-memory descriptor by
// the PTX ISA's layouts and multiplies with plain loops.
#pragma once

#include "field.cuh"

// The design of each instance (the sweep of tools/mma_budgets.py, PERF.md):
// the tiles a warpgroup has in flight on the tensor cores at once (mxu 1;
// f32 2, whose stores of one tile's columns overlap the tensor cores' work
// on the other's) and the parts of the m p product's N range (Fq 2, which
// halves its accumulators; Fr 1).  -DZK_MMA_TILES=t and -DZK_MMA_PSPLIT=h
// set them for every instance.
template <int L, bool F32>
struct MmaDesign {
#ifdef ZK_MMA_TILES
  static constexpr int TILES = ZK_MMA_TILES;
#else
  static constexpr int TILES = F32 ? 2 : 1;
#endif
#ifdef ZK_MMA_PSPLIT
  static constexpr int PSPLIT = ZK_MMA_PSPLIT;
#else
  static constexpr int PSPLIT = L == 12 ? 2 : 1;
#endif
};

template <int L>
struct MmaShape {
  static constexpr int D = 2 * L;                         // 16-bit digits of an element
  static constexpr int K8 = 2 * D;                        // its bytes: the k of the products
  static constexpr int KS = (K8 + 31) / 32;               // k-steps of 32 bytes (Fq 2, Fr 1)
  static constexpr int KP = 32 * KS;                      // bytes of a row of B
  static constexpr int RS = KP % 64 == 32 ? KP : KP + 32;  // bytes between operand rows
  static constexpr int LBO = 128;                         // bytes between B's core matrices along k
  static constexpr int SBO = 128 * (KP / 16);             // and along n
  static constexpr int CS = 2 * D + 4;                    // words of a column row
  static constexpr int QB = 2 * D * KP;                   // bytes of the pinv matrix (S = D, N = 2D rows)
  static constexpr int PB = 4 * D * KP;                   // bytes of the p matrix (S = 2D, N = 4D rows)
  static constexpr int AB = 128 * RS;                     // bytes of the operand rows
  static constexpr int BYTES = QB + PB + AB + 128 * CS * 4;  // a block's dynamic shared memory
};

// wgmma's 64-bit shared-memory matrix descriptor without swizzle: the start
// address, the leading (k) and stride (n) byte offsets, each >> 4.  A
// descriptor plus offset >> 4 describes the matrix at that offset.
ZK_FN uint64_t mma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

#if defined(__CUDA_ARCH__)
ZK_FN void wg_bar() { __syncthreads(); }  // a block is one warpgroup
ZK_FN void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }
ZK_FN void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
ZK_FN void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int K>
ZK_FN void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(K) : "memory");
}
ZK_FN uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
ZK_FN void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
ZK_FN void cp_async_wait_all() { asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory"); }
// the accumulators are read only after the wait that ends their product
template <int R>
ZK_FN void pin(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

ZK_FN float f32_of_bits(uint32_t u) { return __uint_as_float(u); }
ZK_FN uint32_t bits_of_f32(float f) { return __float_as_uint(f); }
ZK_FN uint32_t byte_perm(uint32_t a, uint32_t b, uint32_t s) { return __byte_perm(a, b, s); }
#else
#include <cmath>

void wg_bar();
// no-ops here, and for nvcc's host pass over the kernel in mont_mma.cu
inline void fence_async_smem() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int K>
inline void wgmma_wait() {}
uint32_t smem_addr(const void* p);  // the shim: the offset in the block's shared memory
inline void cp_async16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_async_wait_all() {}
template <int R>
inline void pin(uint32_t (&)[R]) {}
// the shim's warpgroup product: d (n / 2 words a thread) = A B (+ d if
// scale), A from register fragments, B from the descriptor db
void host_wgmma(int n, uint32_t* d, const uint32_t* a, uint64_t db, int scale);

inline float f32_of_bits(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t bits_of_f32(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
// PTX prmt (default mode): byte k of the result is byte (s >> 4k) & 7 of {b, a}
inline uint32_t byte_perm(uint32_t a, uint32_t b, uint32_t s) {
  const uint64_t v = (uint64_t)b << 32 | a;
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) r |= (uint32_t)((v >> (8 * ((s >> (4 * k)) & 7))) & 0xFF) << (8 * k);
  return r;
}
#endif

// d (64 x N, s32; thread 32 w + 4 g + t holds d[4i + 2h + c] = row 16 w + g
// + 8 h, column 8 i + 2 t + c) = A (64 x 32 u8) B (32 x N u8) (+ d if
// scale); A from the fragment a: a[2 c + h] = row 16 w + g + 8 h, bytes
// 16 c + 4 t .. + 3; B from the descriptor db.
template <int N>
ZK_FN void wgmma_u8(uint32_t (&d)[N / 2], const uint32_t* a, uint64_t db, int scale) {
#if defined(__CUDA_ARCH__)
  if constexpr (N == 32) {
    asm volatile("{.reg .pred p; setp.ne.b32 p, %21, 0; "
                 "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;}"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
                 "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
                 "+r"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
  } else if constexpr (N == 48) {
    asm volatile("{.reg .pred p; setp.ne.b32 p, %29, 0; "
                 "wgmma.mma_async.sync.aligned.m64n48k32.s32.u8.u8 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
                 "%20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p;}"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
                 "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
                 "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
                 "+r"(d[22]), "+r"(d[23])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
  } else if constexpr (N == 64) {
    asm volatile("{.reg .pred p; setp.ne.b32 p, %37, 0; "
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
                 "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;}"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
                 "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
                 "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
                 "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
                 "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
  } else if constexpr (N == 96) {
    asm volatile("{.reg .pred p; setp.ne.b32 p, %53, 0; "
                 "wgmma.mma_async.sync.aligned.m64n96k32.s32.u8.u8 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
                 "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
                 "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p;}"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
                 "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
                 "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
                 "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
                 "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
                 "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
                 "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
  }
#else
  host_wgmma(N, d, a, db, scale);
#endif
}

// The constant matrices into the block's shared memory (kernel_mats' bytes
// are already in the descriptor's layout): 16 bytes a copy, thread `tid` of
// `threads`.  The caller waits (cp_async_wait_all), fences for the async
// proxy and synchronises the block.
template <int L>
ZK_FN void mma_stage(uint8_t* smem, const uint8_t* qmat, const uint8_t* pmat, int tid, int threads) {
  using Sh = MmaShape<L>;
  for (int i = tid; i < (Sh::QB + Sh::PB) / 16; i += threads) {
    const int byte = 16 * i;
    cp_async16(smem + byte, byte < Sh::QB ? qmat + byte : pmat + (byte - Sh::QB));
  }
}

// One element's L words into its operand row: k-step ks's 8 words in the
// order 0 4 1 5 2 6 3 7 (zero past word L), two 16-byte stores, so that a
// thread's fragment words t and t + 4 of a row are one 8-byte load.
template <int L>
ZK_FN void store_a(uint8_t* row, const uint32_t* w) {
  using Sh = MmaShape<L>;
#pragma unroll
  for (int ks = 0; ks < Sh::KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int word = 8 * ks + 2 * h + (j >> 1) + 4 * (j & 1);
        v[j] = word < L ? w[word] : 0;
      }
      store_elem<4>(reinterpret_cast<uint32_t*>(row + 32 * ks + 16 * h), v);
    }
}

// Warpgroup-collective: the column sums cols[e][s] = sum_r x8[e][r] (A[s][r]
// + 256 B[s][r]), s < S, of the warpgroup's 128 elements (the operand rows
// at), against the constant matrix of descriptor db (N = 2S rows), into the
// rows of cs, in H parts of the N range (a part's accumulators: N / H / 2
// registers), with TILES tiles in flight.  Thread tid = 32 w + 4 g + t
// stores columns 4i + t of each part and rows 16 w + g and 16 w + g + 8 of
// each tile.
template <int L, int S, int H, int TILES>
ZK_FN void const_conv(uint32_t* cs, const uint8_t* at, uint64_t db, int tid) {
  using Sh = MmaShape<L>;
  constexpr int N = 2 * S / H, R = N / 2;
  const int w = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  uint32_t af[2][Sh::KS][4];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int ks = 0; ks < Sh::KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // words t and t + 4 of the k-step: bytes 4t.. and 16 + 4t..
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(at + (64 * T + 16 * w + g + 8 * h) * Sh::RS + 32 * ks + 8 * t);
        af[T][ks][h] = src[0];
        af[T][ks][2 + h] = src[1];
      }
  auto issue = [&](uint32_t(&d)[R], int T, int h) {
#pragma unroll
    for (int ks = 0; ks < Sh::KS; ++ks)
      wgmma_u8<N>(d, af[T][ks], db + ((h * (N / 8) * Sh::SBO + ks * 2 * Sh::LBO) >> 4), ks > 0);
  };
  auto store = [&](const uint32_t(&d)[R], int T, int h) {
    uint32_t* o = cs + (64 * T + 16 * w + g) * Sh::CS + h * (N / 2) + t;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      o[4 * i] = d[4 * i] + (d[4 * i + 1] << 8);
      o[8 * Sh::CS + 4 * i] = d[4 * i + 2] + (d[4 * i + 3] << 8);
    }
  };
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if constexpr (TILES == 2) {
      uint32_t d0[R], d1[R];
      wgmma_fence();
      issue(d0, 0, h);
      wgmma_commit();
      issue(d1, 1, h);
      wgmma_commit();
      wgmma_wait<1>();
      pin(d0);
      store(d0, 0, h);
      wgmma_wait<0>();
      pin(d1);
      store(d1, 1, h);
    } else {
      uint32_t d[R];
#pragma unroll
      for (int T = 0; T < 2; ++T) {
        wgmma_fence();
        issue(d, T, h);
        wgmma_commit();
        wgmma_wait<0>();
        pin(d);
        store(d, T, h);
      }
    }
  }
}

// t = x y (2L words) from chains split by the parity of i + j, the idea of
// ntt.cuh's ntt_mul: the products x[j] y[i] with i + j even go to P (word
// i + j, its high half at i + j + 1), the others to Q one word down (Q[k] is
// word k + 1), so that every product's two halves sit side by side at an
// even register offset in one chain (mad.lo.cc, madc.hi.cc: one 64-bit
// multiply-add with carry, and no register moves between rows); each row
// adds one chain to P and one to Q and puts each chain's carry in the word
// above it.  Then t = P + Q.  Each array is part of the sum x y < 2^(64 L),
// so a chain whose carry would leave the array carries 0.
template <int L>
ZK_FN void conv_split(uint32_t* t, const uint32_t* x, const uint32_t* y) {
  uint32_t P[2 * L], Q[2 * L - 1];
#pragma unroll
  for (int j = 0; j < L; j += 2) {  // row 0: plain products
    const uint64_t pe = (uint64_t)x[j] * y[0], po = (uint64_t)x[j + 1] * y[0];
    P[j] = (uint32_t)pe;
    P[j + 1] = (uint32_t)(pe >> 32);
    Q[j] = (uint32_t)po;
    Q[j + 1] = (uint32_t)(po >> 32);
  }
#pragma unroll
  for (int k = L; k < 2 * L; ++k) P[k] = 0;
#pragma unroll
  for (int k = L; k < 2 * L - 1; ++k) Q[k] = 0;
#pragma unroll
  for (int i = 1; i < L; ++i) {
    const int jp = i & 1, jq = 1 - jp;  // the first j of P's chain (i + j even) and of Q's
    // P: words i + jp .. i + jp + L - 1, its carry into the word above
    P[i + jp] = cc::mad_lo_cc(x[jp], y[i], P[i + jp]);
    P[i + jp + 1] = cc::madc_hi_cc(x[jp], y[i], P[i + jp + 1]);
#pragma unroll
    for (int j = jp + 2; j < L; j += 2) {
      P[i + j] = cc::madc_lo_cc(x[j], y[i], P[i + j]);
      P[i + j + 1] = cc::madc_hi_cc(x[j], y[i], P[i + j + 1]);
    }
    if (i + jp + L < 2 * L) P[i + jp + L] = cc::addc(P[i + jp + L], 0);
    // Q: words i + jq .. i + jq + L - 1 at Q[i + jq - 1 ..]
    Q[i + jq - 1] = cc::mad_lo_cc(x[jq], y[i], Q[i + jq - 1]);
    Q[i + jq] = cc::madc_hi_cc(x[jq], y[i], Q[i + jq]);
#pragma unroll
    for (int j = jq + 2; j < L; j += 2) {
      Q[i + j - 1] = cc::madc_lo_cc(x[j], y[i], Q[i + j - 1]);
      Q[i + j] = cc::madc_hi_cc(x[j], y[i], Q[i + j]);
    }
    if (i + jq + L - 1 < 2 * L - 1) Q[i + jq + L - 1] = cc::addc(Q[i + jq + L - 1], 0);
  }
  t[0] = P[0];
  t[1] = cc::add_cc(P[1], Q[0]);
#pragma unroll
  for (int k = 2; k < 2 * L - 1; ++k) t[k] = cc::addc_cc(P[k], Q[k - 1]);
  t[2 * L - 1] = cc::addc(P[2 * L - 1], Q[2 * L - 2]);
}

// The 8-bit digits of an element as floats: 2^23 + v has v in its mantissa
// bits, so a digit converts with a byte permute (the byte under the
// exponent byte of 2^23) and a subtraction (the conversion pipe issues 16 a
// clock per SM, FMA 128).
constexpr uint32_t F32_EXP23 = 0x4B000000u;  // the bits of 2^23
constexpr float F32_BIAS = 8388608.0f;

template <int L>
ZK_FN void f32_digits(float* lo, float* hi, const uint32_t* x) {
#pragma unroll
  for (int i = 0; i < 2 * L; ++i) {  // bytes 2i and 2i + 1 of x under the exponent byte of 2^23
    lo[i] = f32_of_bits(byte_perm(x[i / 2], F32_EXP23, 0x7540 + 2 * (i & 1))) - F32_BIAS;
    hi[i] = f32_of_bits(byte_perm(x[i / 2], F32_EXP23, 0x7541 + 2 * (i & 1))) - F32_BIAS;
  }
}

// Two sums of one column (started at 2^23: they read back with a mask
// instead of a conversion) as the column's 32-bit value A + 256 B.
ZK_FN uint32_t f32_column(float a, float b) {
  return (bits_of_f32(a) & 0x7FFFFF) + ((bits_of_f32(b) & 0x7FFFFF) << 8);
}

// t = x y (2L words) from FP32 FMAs over 8-bit digits, row by row into 4D
// accumulators, the order of RowOpsF32.conv_full.
template <int L>
ZK_FN void conv_f32(uint32_t* t, const uint32_t* x, const uint32_t* y) {
  constexpr int D = 2 * L;
  float al[D], ah[D], bl[D], bh[D];
  f32_digits<L>(al, ah, x);
  f32_digits<L>(bl, bh, y);
  float acc_a[2 * D], acc_b[2 * D];
#pragma unroll
  for (int k = 0; k < 2 * D; ++k) acc_a[k] = acc_b[k] = F32_BIAS;
#pragma unroll
  for (int j = 0; j < D; ++j) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      acc_a[i + j] = fmaf(al[i], bl[j], acc_a[i + j]);
      acc_a[i + j + 1] = fmaf(ah[i], bh[j], acc_a[i + j + 1]);
      acc_b[i + j] = fmaf(al[i], bh[j], acc_b[i + j]);
      acc_b[i + j] = fmaf(ah[i], bl[j], acc_b[i + j]);
    }
  }
  uint64_t c = 0;
#pragma unroll
  for (int l = 0; l < 2 * L; ++l) {
    c += (uint64_t)f32_column(acc_a[2 * l], acc_b[2 * l]) +
         ((uint64_t)f32_column(acc_a[2 * l + 1], acc_b[2 * l + 1]) << 16);
    t[l] = (uint32_t)c;
    c >>= 32;
  }
}

// m = sum_{s < D} cols[s] 2^(16 s) mod R in one carry chain: word l takes
// cols[2l] and the high bits of cols[2l - 1] (below 2^32 together), then
// cols[2l + 1] << 16 with the carry.
template <int L>
ZK_FN void cols_mod_r(uint32_t* m, const uint32_t* cols) {
  uint32_t u[L];
#pragma unroll
  for (int l = 0; l < L; ++l) u[l] = cols[2 * l] + (l ? cols[2 * l - 1] >> 16 : 0);
  m[0] = cc::add_cc(u[0], cols[1] << 16);
#pragma unroll
  for (int l = 1; l < L - 1; ++l) m[l] = cc::addc_cc(u[l], cols[2 * l + 1] << 16);
  m[L - 1] = cc::addc(u[L - 1], cols[2 * L - 1] << 16);
}

// x = (t + sum_s cols[s] 2^(16 s)) / R, left lazy: the division is exact
// (the low L words are 0), and for x < 2p, y < p the quotient is below
// p (1 + 2p / R) < 2p (p < R / 2), its sum below R^2.  Two carry chains: t
// plus the words cols[2l] + (cols[2l - 1] >> 16), then the words
// cols[2l + 1] << 16.
template <int L>
ZK_FN void finish(uint32_t* x, const uint32_t* t, const uint32_t* cols) {
  uint32_t w[2 * L];
  w[0] = cc::add_cc(t[0], cols[0]);
#pragma unroll
  for (int l = 1; l < 2 * L - 1; ++l) w[l] = cc::addc_cc(t[l], cols[2 * l] + (cols[2 * l - 1] >> 16));
  w[2 * L - 1] = cc::addc(t[2 * L - 1], cols[4 * L - 2] + (cols[4 * L - 3] >> 16));
  w[0] = cc::add_cc(w[0], cols[1] << 16);
#pragma unroll
  for (int l = 1; l < 2 * L - 1; ++l) w[l] = cc::addc_cc(w[l], cols[2 * l + 1] << 16);
  w[2 * L - 1] = cc::addc(w[2 * L - 1], cols[4 * L - 1] << 16);
#pragma unroll
  for (int l = 0; l < L; ++l) x[l] = w[L + l];
}

// One warpgroup's chain: thread tid (0..127) owns element e (e >= n: it
// computes on zeros for the warpgroup's products and stores nothing),
// x = x y R^{-1} mod p `chain` times, below 2p between products and
// reduced once at the end.  smem: the block's shared memory, the matrices
// staged.
template <int L, bool F32>
ZK_FN void mma_chain_wg(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n, int64_t e, int tid,
                        int chain, uint8_t* smem, const FieldConsts<L>& f) {
  using Sh = MmaShape<L>;
  using Design = MmaDesign<L, F32>;
  constexpr int D = Sh::D;
  uint8_t* at = smem + Sh::QB + Sh::PB;
  uint8_t* arow = at + tid * Sh::RS;
  uint32_t* cs = reinterpret_cast<uint32_t*>(at + Sh::AB);
  const uint32_t* crow = cs + tid * Sh::CS;
  const uint64_t dq = mma_desc(smem_addr(smem), Sh::LBO, Sh::SBO), dp = dq + (Sh::QB >> 4);
  uint32_t x[L], y[L];
  if (e < n) {
    copy_limbs<L>(x, a + e * L);
    copy_limbs<L>(y, b + e * L);
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) x[j] = y[j] = 0;
  }
#pragma unroll 1
  for (int k = 0; k < chain; ++k) {
    uint32_t t[2 * L];
    if constexpr (F32) {
      conv_f32<L>(t, x, y);
    } else {
      conv_split<L>(t, x, y);
    }
    store_a<L>(arow, t);  // t mod R
    wg_bar();
    const_conv<L, D, 1, Design::TILES>(cs, at, dq, tid);  // m_cols
    wg_bar();
    uint32_t cols[2 * D];
    load_elem<D>(cols, crow);
    uint32_t m[L];
    cols_mod_r<L>(m, cols);
    store_a<L>(arow, m);
    wg_bar();
    const_conv<L, 2 * D, Design::PSPLIT, Design::TILES>(cs, at, dp, tid);  // mp_cols
    wg_bar();
    load_elem<2 * D>(cols, crow);
    finish<L>(x, t, cols);
  }
  if (e < n) {
    uint32_t r[L];
    reduce_once<L>(r, x, 0, f);
    copy_limbs<L>(out + e * L, r);
  }
}
