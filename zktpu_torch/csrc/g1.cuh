// The complete projective group law of BLS12-381 G1 (y^2 = x^3 + 4) over Fq
// limbs, as straight-line device code: Renes-Costello-Batina 2015/1060,
// Alg. 7 (add, 12M), Alg. 8 (mixed add, 11M) and Alg. 9 (double, 6M + 2S),
// for a = 0 and 3b = 12.  The same field operations as
// zktpu/curves/g1.py::_proj_add_jnp, _proj_madd_jnp and _proj_double_jnp
// (the add and the mixed add in another order); the outputs are canonical,
// so the output words are equal.  The identity is
// (0 : 1 : 0); all-zero inputs map to all-zero outputs.  The mixed add's
// affine operand encodes its identity as (0, 0) (off the curve, so
// unambiguous), which a final select on both coordinates handles.
//
// The add and the mixed add reduce lazily (field.cuh).  Inputs are
// canonical (< p).  Every intermediate is < 2p unless its comment says
// otherwise; the product takes inputs whose product is < 9 p^2 (each < 4p
// here), and gives < 2p (p < 0.102 R, R = 2^384, so a b / R + p < 2p).  Sums
// of two canonical inputs (< 2p) feed products unreduced; every other add
// or sub reduces once by 2p; the three outputs are canonicalized from < 2p
// by one conditional subtraction of p.
//
// Operands are read from device memory where they are used rather than held
// in registers across the formula, so fewer values are live at once.
#pragma once

#include "field.cuh"

constexpr int FQ_LIMBS = 12;

// Host and device: the launcher sizes its shared memory with these.
#if defined(__CUDACC__)
#define ZK_HD __host__ __device__ __forceinline__
#else
#define ZK_HD inline
#endif
using FqConsts = FieldConsts<FQ_LIMBS>;

// One coordinate plane of a batch of points: row (o, j) of the flattened
// (outer, inner) batch is at ptr + (o so + j si) * 12 words.  Strides are in
// rows, 32-bit (the wrapper checks that every row index fits), so that an
// address costs one multiply-add from the plane's constant-bank pointer and
// few registers stay live for addressing; a broadcast dim has stride 0.
struct Plane {
  uint32_t* ptr;
  uint32_t so, si;
};

template <int N>
struct Planes {
  Plane p[N];
};

ZK_FN uint32_t* row_ptr(const Plane& pl, uint32_t o, uint32_t j) {
  return pl.ptr + (uint64_t)(o * pl.so + j * pl.si) * FQ_LIMBS;
}

// Rows are 48 bytes at 16-byte aligned addresses (the wrapper checks it):
// three 16-byte accesses.  The loads are volatile so that each use reads
// memory again (L1) instead of keeping the value live in registers.
ZK_FN void load_row(uint32_t* dst, const uint32_t* src) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; k += 4)
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(dst[k]), "=r"(dst[k + 1]), "=r"(dst[k + 2]), "=r"(dst[k + 3])
                 : "l"(src + k));
#else
  std::memcpy(dst, src, FQ_LIMBS * sizeof(uint32_t));
#endif
}

ZK_FN void store_row(uint32_t* dst, const uint32_t* src) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; k += 4)
    *reinterpret_cast<uint4*>(dst + k) = make_uint4(src[k], src[k + 1], src[k + 2], src[k + 3]);
#else
  std::memcpy(dst, src, FQ_LIMBS * sizeof(uint32_t));
#endif
}

// 12 a = 3b a as the double/add chain of pallas_g1.py::_mul12; a < 2p, out < 2p.
ZK_FN void fq_mul12_lazy(uint32_t* out, const uint32_t* a, const FqConsts& f) {
  uint32_t a4[FQ_LIMBS], a8[FQ_LIMBS];
  add_red<FQ_LIMBS>(a4, a, a, f.p2);
  add_red<FQ_LIMBS>(a4, a4, a4, f.p2);
  add_red<FQ_LIMBS>(a8, a4, a4, f.p2);
  add_red<FQ_LIMBS>(out, a8, a4, f.p2);
}

// The lazy Fq product of the adds (the carry chains of mont_mul_lazy).
ZK_FN void fq_mul(uint32_t* out, const uint32_t* a, const uint32_t* b, const FqConsts& f) {
  mont_mul_lazy<FQ_LIMBS>(out, a, b, f);
}

// Where an operand or a result of an add lives.  MemRows: rows of device
// memory, read again at each use (the group-law kernels).  SharedRows:
// rows of shared memory, the fixed-base multiply's staged table and its
// accumulators.  The result may overwrite P1: the add reads P1 only before
// its first store.
struct MemRows {
  ZK_FN static void load(uint32_t* dst, const uint32_t* src) { load_row(dst, src); }
  ZK_FN static void store(uint32_t* dst, const uint32_t* src) { store_row(dst, src); }
};

struct SharedRows {
  ZK_FN static void load(uint32_t* dst, const uint32_t* src) { load_elem<FQ_LIMBS>(dst, src); }
  ZK_FN static void store(uint32_t* dst, const uint32_t* src) { store_elem<FQ_LIMBS>(dst, src); }
};

// The three outputs of both adds,
//     X3 = t3 t1 - t4 t5,  Y3 = t1 Zc + t5 t0,  Z3 = Zc t4 + t0 t3,
// from six values < 2p (t4 < 3p in the mixed add).  Each value is a factor
// of two products; taking the products around that cycle (t3 t1, t1 Zc,
// Zc t4, t4 t5, t5 t0, t0 t3) frees a factor after its second use, so at
// most seven values are live.  The products overwrite their dead factors.
// Where inf2 is set (the mixed add's affine identity) the outputs are P1,
// read again from where P1 lives.  Every output is canonicalized from < 2p.
template <class Rows = MemRows>
ZK_FN void finish_adds(uint32_t* x3, uint32_t* y3, uint32_t* z3, uint32_t* t0, uint32_t* t1,
                       uint32_t* t3, uint32_t* t4, uint32_t* t5, uint32_t* zc, bool inf2,
                       const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                       const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  uint32_t a[L], b[L];
  fq_mul(a, t3, t1, f);   // a = t3 t1
  fq_mul(b, t1, zc, f);   // b = t1 Zc (t1 dead)
  fq_mul(zc, zc, t4, f);  // zc = Zc t4
  fq_mul(t4, t4, t5, f);  // t4 = t4 t5
  sub_red<L>(a, a, t4, f.p2);
  cond_sub<L>(a, a, f.p);
  if (inf2) Rows::load(a, x1);
  Rows::store(x3, a);
  fq_mul(t5, t5, t0, f);  // t5 = t5 t0
  add_red<L>(b, b, t5, f.p2);
  cond_sub<L>(b, b, f.p);
  if (inf2) Rows::load(b, y1);
  Rows::store(y3, b);
  fq_mul(t0, t0, t3, f);  // t0 = t0 t3
  add_red<L>(zc, zc, t0, f.p2);
  cond_sub<L>(zc, zc, f.p);
  if (inf2) Rows::load(zc, z1);
  Rows::store(z3, zc);
}

// RCB Alg. 7: (x3, y3, z3) = (x1, y1, z1) + (x2, y2, z2); P1 and the
// result where Rows1 says, P2 where Rows2 says.
// The order (t0, t2, t5, t1, t4, t3) lets each sum of inputs be formed
// from fresh loads and each t be finished as soon as its two products
// exist.  UNIT_Z2: z2 is 0 or the Montgomery one, so Z1 Z2 (Z1 or 0) is a
// select and the add takes 11 products, the same field values.
template <class Rows1 = MemRows, class Rows2 = MemRows, bool UNIT_Z2 = false>
ZK_FN void proj_add_point(uint32_t* x3, uint32_t* y3, uint32_t* z3, const uint32_t* x1,
                          const uint32_t* y1, const uint32_t* z1, const uint32_t* x2,
                          const uint32_t* y2, const uint32_t* z2, const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  const uint32_t* p2 = f.p2;
  uint32_t t0[L], t1[L], t2[L], t3[L], t4[L], t5[L], a[L], b[L], c[L];
  Rows1::load(a, x1);
  Rows2::load(b, x2);
  fq_mul(t0, a, b, f);            // t0 = X1 X2
  Rows1::load(c, z1);
  add_nr<L>(a, a, c);             // X1 + Z1 < 2p
  Rows2::load(t2, z2);
  add_nr<L>(b, b, t2);            // X2 + Z2 < 2p
  if constexpr (UNIT_Z2) {        // Z2 is 0 or the Montgomery one: t2 = Z1 Z2 = 0 or Z1, a select
    const uint32_t keep = is_zero<L>(t2) ? 0u : 0xffffffffu;
#pragma unroll
    for (int k = 0; k < L; ++k) t2[k] = c[k] & keep;
  } else {
    fq_mul(t2, c, t2, f);         // t2 = Z1 Z2
  }
  fq_mul(t5, a, b, f);
  add_red<L>(a, t0, t2, p2);      // t5 = X1 Z2 + X2 Z1
  sub_red<L>(t5, t5, a, p2);
  Rows1::load(a, y1);
  Rows2::load(b, y2);
  fq_mul(t1, a, b, f);            // t1 = Y1 Y2
  add_nr<L>(a, a, c);             // Y1 + Z1 < 2p
  Rows2::load(c, z2);
  add_nr<L>(b, b, c);             // Y2 + Z2 < 2p
  fq_mul(t4, a, b, f);
  add_red<L>(a, t1, t2, p2);      // t4 = Y1 Z2 + Y2 Z1
  sub_red<L>(t4, t4, a, p2);
  Rows1::load(a, x1);
  Rows1::load(c, y1);
  add_nr<L>(a, a, c);             // X1 + Y1 < 2p
  Rows2::load(b, x2);
  Rows2::load(c, y2);
  add_nr<L>(b, b, c);             // X2 + Y2 < 2p
  fq_mul(t3, a, b, f);
  add_red<L>(a, t0, t1, p2);      // t3 = X1 Y2 + X2 Y1
  sub_red<L>(t3, t3, a, p2);
  add_red<L>(a, t0, t0, p2);      // t0 = 3 X1 X2
  add_red<L>(t0, a, t0, p2);
  fq_mul12_lazy(t2, t2, f);       // t2 = 3b Z1 Z2
  add_red<L>(c, t1, t2, p2);      // c = Zc = Y1 Y2 + 3b Z1 Z2
  sub_red<L>(t1, t1, t2, p2);     // t1 = Y1 Y2 - 3b Z1 Z2
  fq_mul12_lazy(t5, t5, f);       // t5 = 3b (X1 Z2 + X2 Z1)
  finish_adds<Rows1>(x3, y3, z3, t0, t1, t3, t4, t5, c, false, x1, y1, z1, f);
}

// RCB Alg. 8 on rows of device memory: projective P1 plus affine (x2, y2)
// with Z2 = 1.  Where (x2, y2) is (0, 0) the output is P1, read again from
// memory; so zero-padded rows (all inputs zero) come out all zero.
ZK_FN void proj_madd_point(uint32_t* x3, uint32_t* y3, uint32_t* z3, const uint32_t* x1,
                           const uint32_t* y1, const uint32_t* z1, const uint32_t* x2,
                           const uint32_t* y2, const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  const uint32_t* p2 = f.p2;
  uint32_t t0[L], t1[L], t2[L], t3[L], t4[L], t5[L], a[L], b[L], c[L];
  load_row(b, x2);
  load_row(c, y2);
  const bool inf2 = is_zero<L>(b) && is_zero<L>(c);  // the affine identity (0, 0)
  load_row(a, x1);
  fq_mul(t0, a, b, f);            // t0 = X1 X2
  add_nr<L>(b, b, c);             // X2 + Y2 < 2p
  load_row(c, y1);
  add_nr<L>(a, a, c);             // X1 + Y1 < 2p
  fq_mul(t3, a, b, f);
  load_row(b, y2);
  fq_mul(t1, c, b, f);            // t1 = Y1 Y2
  add_red<L>(a, t0, t1, p2);      // t3 = X1 Y2 + X2 Y1
  sub_red<L>(t3, t3, a, p2);
  load_row(c, z1);
  fq_mul(a, b, c, f);             // t4 = Y1 + Y2 Z1 < 3p (a product factor only)
  load_row(b, y1);
  add_nr<L>(t4, b, a);
  load_row(b, x2);
  fq_mul(a, b, c, f);             // t5 = X1 + X2 Z1: < 3p, reduced to < 2p
  load_row(b, x1);
  add_red<L>(t5, b, a, p2);
  add_red<L>(a, t0, t0, p2);      // t0 = 3 X1 X2
  add_red<L>(t0, a, t0, p2);
  fq_mul12_lazy(t2, c, f);        // t2 = 3b Z1
  add_red<L>(c, t1, t2, p2);      // c = Zc = Y1 Y2 + 3b Z1
  sub_red<L>(t1, t1, t2, p2);     // t1 = Y1 Y2 - 3b Z1
  fq_mul12_lazy(t5, t5, f);       // t5 = 3b (X1 + X2 Z1)
  finish_adds(x3, y3, z3, t0, t1, t3, t4, t5, c, inf2, x1, y1, z1, f);
}

// 12 a = 3b a with canonical helpers (the double).
ZK_FN void fq_mul12(uint32_t* out, const uint32_t* a, const FqConsts& f) {
  uint32_t a4[FQ_LIMBS], a8[FQ_LIMBS];
  fdbl<FQ_LIMBS>(a4, a, f);
  fdbl<FQ_LIMBS>(a4, a4, f);
  fdbl<FQ_LIMBS>(a8, a4, f);
  fadd<FQ_LIMBS>(out, a8, a4, f);
}

// RCB Alg. 9, canonical at every step.
ZK_FN void proj_double_point(uint32_t* X3, uint32_t* Y3, uint32_t* Z3, const uint32_t* X,
                             const uint32_t* Y, const uint32_t* Z, const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  uint32_t t0[L], t1[L], t2[L], x3[L], y3[L], z3[L], u[L];
  fmul<L>(t0, Y, Y, f);
  fdbl<L>(z3, t0, f);  // z3 = 8 Y^2
  fdbl<L>(z3, z3, f);
  fdbl<L>(z3, z3, f);
  fmul<L>(t1, Y, Z, f);
  fmul<L>(u, Z, Z, f);  // t2 = 3b Z^2
  fq_mul12(t2, u, f);
  fmul<L>(x3, t2, z3, f);
  fadd<L>(y3, t0, t2, f);
  fmul<L>(z3, t1, z3, f);
  fdbl<L>(u, t2, f);  // t2 = 9b Z^2
  fadd<L>(t2, u, t2, f);
  fsub<L>(t0, t0, t2, f);  // t0 = Y^2 - 9b Z^2
  fmul<L>(u, t0, y3, f);
  fadd<L>(y3, u, x3, f);
  fmul<L>(u, X, Y, f);
  fmul<L>(u, t0, u, f);
  fdbl<L>(x3, u, f);
  copy_limbs<L>(X3, x3);
  copy_limbs<L>(Y3, y3);
  copy_limbs<L>(Z3, z3);
}

// Point i of a launch over the flattened (outer, inner) batch: planes are
// (inputs..., x3, y3, z3).
ZK_FN void proj_add_at(const Planes<9>& pl, uint32_t o, uint32_t j, const FqConsts& f) {
  const Plane* q = pl.p;
  proj_add_point(row_ptr(q[6], o, j), row_ptr(q[7], o, j), row_ptr(q[8], o, j),
                 row_ptr(q[0], o, j), row_ptr(q[1], o, j), row_ptr(q[2], o, j),
                 row_ptr(q[3], o, j), row_ptr(q[4], o, j), row_ptr(q[5], o, j), f);
}

ZK_FN void proj_madd_at(const Planes<8>& pl, uint32_t o, uint32_t j, const FqConsts& f) {
  const Plane* q = pl.p;
  proj_madd_point(row_ptr(q[5], o, j), row_ptr(q[6], o, j), row_ptr(q[7], o, j),
                  row_ptr(q[0], o, j), row_ptr(q[1], o, j), row_ptr(q[2], o, j),
                  row_ptr(q[3], o, j), row_ptr(q[4], o, j), f);
}

ZK_FN void proj_double_at(const Planes<6>& pl, uint32_t o, uint32_t j, const FqConsts& f) {
  const Plane* q = pl.p;
  uint32_t X[FQ_LIMBS], Y[FQ_LIMBS], Z[FQ_LIMBS], X3[FQ_LIMBS], Y3[FQ_LIMBS], Z3[FQ_LIMBS];
  load_row(X, row_ptr(q[0], o, j));
  load_row(Y, row_ptr(q[1], o, j));
  load_row(Z, row_ptr(q[2], o, j));
  proj_double_point(X3, Y3, Z3, X, Y, Z, f);
  store_row(row_ptr(q[3], o, j), X3);
  store_row(row_ptr(q[4], o, j), Y3);
  store_row(row_ptr(q[5], o, j), Z3);
}

// ---------------------------------------------------------------------------
// The fixed-base window multiply: [s] B for each 256-bit scalar s over
// `windows` windows of `window` bits (window divides 32, at most 8), with
// the table T[w][j] = j 2^(window w) B precomputed:
//     acc = O;  acc += T[w][digit_w(s)]  for w = 0 .. windows - 1,
// complete adds (Alg. 7) in the order of zktpu/curves/g1.py's fori_loop, so
// the output words are the plain loop's.  Row 0 of each window is O = (0 :
// 1 : 0) and every other row is affine (Z = 1: the table is built from
// affine points), so the add takes the row's X and Y and, in place of its
// Z, the Montgomery one or 0 by a select on the digit: the same operands,
// and no read of the table's Z plane.  With Z2 one or 0, Z1 Z2 is Z1 or 0,
// a select, so the add is 11 products.  Every digit takes the same
// straight-line add: a branch for a digit of 0 (O added as (X Y, Y^2, Y Z),
// 3 products, beside mixed adds of 11 for the others) made the loop slower
// on the H100 than the parent's complete adds (PERF.md, row 7).
//
// A block of FB_THREADS threads walks the windows in step, one scalar a
// thread.  Its dynamic shared memory (fb_shared_words) holds two staged
// windows, each the 2^window rows of T's X plane then of its Y plane, each
// thread's accumulator (X, Y, Z planes of FB_THREADS rows) and its scalar
// (8 planes of FB_THREADS words).  While the block adds window w from one
// buffer, cp.async copies window w + 1 into the other, so no add waits on
// device memory, and an add keeps only its own temporaries in registers.
// The per-thread steps below are what the kernel (csrc/g1.cu) runs between
// its barriers, and what tests/g1_host.cpp runs thread by thread.
// ---------------------------------------------------------------------------
#ifndef ZK_FB_THREADS
#define ZK_FB_THREADS 192
#endif
constexpr uint32_t FB_THREADS = ZK_FB_THREADS;
constexpr uint32_t FB_MAX_WINDOW = 8;
static_assert(FB_THREADS % 32 == 0, "whole warps a block");

struct FixedBaseArgs {
  const uint32_t* table[2];  // X, Y of T: contiguous (windows, 2^window, 12)
  const uint32_t* scalars;   // (n, 8) little-endian 32-bit limbs, contiguous
  uint32_t* out[3];          // X, Y, Z of the result: contiguous (n, 12)
  uint32_t n, window, windows;
};

// Words of a block's dynamic shared memory at `window`.
ZK_HD uint32_t fb_shared_words(uint32_t window) {
  return 2 * 2 * (1u << window) * FQ_LIMBS + 3 * FB_THREADS * FQ_LIMBS + 8 * FB_THREADS;
}

struct FbShared {
  uint32_t* stage;       // buffer b at stage + b stage_words: X rows, then Y rows
  uint32_t stage_words;
  uint32_t* acc;         // coordinate k of thread t's accumulator at (k FB_THREADS + t) 12
  uint32_t* scalar;      // word k of thread t's scalar at k FB_THREADS + t
};

ZK_FN FbShared fb_shared(uint32_t* smem, uint32_t window) {
  const uint32_t stage = 2 * (1u << window) * FQ_LIMBS;
  return FbShared{smem, stage, smem + 2 * stage, smem + 2 * stage + 3 * FB_THREADS * FQ_LIMBS};
}

ZK_FN uint32_t* fb_acc(const FbShared& s, uint32_t k, uint32_t t) { return s.acc + (k * FB_THREADS + t) * FQ_LIMBS; }

// 16 bytes from device memory into shared memory, asynchronously (cp.async
// on the card; the host test copies at once).
ZK_FN void fb_copy16(uint32_t* dst, const uint32_t* src) {
#if defined(__CUDA_ARCH__)
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
#else
  std::memcpy(dst, src, 16);
#endif
}

// Thread t's share of the copy of window w into buffer buf: 16-byte words
// t, t + FB_THREADS, ... of the window's X rows, then of its Y rows.
ZK_FN void fb_stage(const FixedBaseArgs& a, const FbShared& s, uint32_t w, uint32_t buf, uint32_t t) {
  const uint32_t words = (1u << a.window) * FQ_LIMBS / 4;  // of one plane
  const uint64_t base = (uint64_t)w * (1u << a.window) * FQ_LIMBS;
  uint32_t* dst = s.stage + buf * s.stage_words;
#pragma unroll 1
  for (uint32_t k = t; k < 2 * words; k += FB_THREADS) {
    const uint32_t plane = k >= words, q = k - plane * words;
    fb_copy16(dst + k * 4, (plane ? a.table[1] : a.table[0]) + base + q * 4);
  }
}

// Thread t (scalar i) starts: its scalar into shared memory, acc = O.
ZK_FN void fb_begin(const FixedBaseArgs& a, const FbShared& s, uint32_t i, uint32_t t) {
  uint32_t row[FQ_LIMBS];
#pragma unroll
  for (int k = 0; k < 8; ++k) s.scalar[k * FB_THREADS + t] = i < a.n ? a.scalars[(uint64_t)i * 8 + k] : 0;
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) row[k] = 0;
  SharedRows::store(fb_acc(s, 0, t), row);
  SharedRows::store(fb_acc(s, 2, t), row);
  load_row(row, a.table[1]);  // T[0][0] = O: its Y is the Montgomery one
  SharedRows::store(fb_acc(s, 1, t), row);
}

// Thread t adds window w's row of its digit, staged in buffer buf: X and Y
// from the stage, Z the Montgomery one (row 0's Y) or, for row 0, zero
// (row 0's X), also from the stage.
ZK_FN void fb_add(const FixedBaseArgs& a, const FbShared& s, uint32_t w, uint32_t buf, uint32_t t, const FqConsts& f) {
  const uint32_t bit = w * a.window, rows = 1u << a.window;
  const uint32_t digit = (s.scalar[(bit >> 5) * FB_THREADS + t] >> (bit & 31)) & (rows - 1);
  const uint32_t* stage = s.stage + buf * s.stage_words;
  const uint32_t* x2 = stage + digit * FQ_LIMBS;
  uint32_t *x = fb_acc(s, 0, t), *y = fb_acc(s, 1, t), *z = fb_acc(s, 2, t);
  proj_add_point<SharedRows, SharedRows, true>(x, y, z, x, y, z, x2, x2 + rows * FQ_LIMBS,
                                               stage + (digit ? rows * FQ_LIMBS : 0), f);
}

// Thread t writes scalar i's point.
ZK_FN void fb_end(const FixedBaseArgs& a, const FbShared& s, uint32_t i, uint32_t t) {
  uint32_t row[FQ_LIMBS];
#pragma unroll
  for (uint32_t k = 0; k < 3; ++k) {
    SharedRows::load(row, fb_acc(s, k, t));
    store_row(a.out[k] + (uint64_t)i * FQ_LIMBS, row);
  }
}

// ---------------------------------------------------------------------------
// The Horner combine of the MSM's window sums: acc = part[W-1], then for
// w = W-2 .. 0, c doubles (Alg. 9) and one add of part[w] (Alg. 7), the
// same field operations as proj_double_point and proj_add_point, so the same
// words once canonical.  The chain is serial: its time is the latency of
// (W - 1)(2c + 2) steps of dependent Montgomery products (two a double, two
// an add) and of the sums between them.
//
// One warp runs one point (a block is one warp; K points, K blocks).  Its
// lanes form HORNER_G product groups of HORNER_P lanes; lanes past
// HORNER_G HORNER_P run along and nothing reads their results.  A formula
// step's independent products run at once, one a group: the double's four
// in one round, the add's six in ceil(6 / HORNER_G) rounds.  Each product is
// spread over its group's lanes (horner_mul): lane d holds digit d, the
// HORNER_N = 12 / HORNER_P words d N .. d N + N - 1, of the first factor,
// of p and of the running sum, and all of the second factor.  Every lane
// holds the accumulator and a step's operands whole, in registers: after a
// step, each lane gathers the products it needs from their groups by
// shuffles (horner_gather) and forms the sums of the next step's operands.
// No value goes through shared memory; the only exchange is __shfl_sync,
// which the host tests emulate (tests/g1_host.cpp runs the 32 lanes of a
// warp in turn from one shuffle to the next).
//
// Reduction is lazy.  A product (a b + M p) / R, for the M < R that makes
// it exact, is mont_mul_lazy's result word for word and is below
// a b / R + p < 2p wherever a b < p R (p < 0.102 R, so a b < 9.8 p^2): so
// one factor may be below 4p if the other is below 2p (a b < 8p^2).  The
// accumulator's Y and Z are below 2p from step to step and X below 4p (the
// add reduces it first); the parts are canonical (< p).  The add's first
// step multiplies a sum of two coordinates, < 4p unreduced, by a sum of two
// parts, < 2p.  Every other value is below 2p unless its comment says 4p:
// add_red and sub_red by 2p of values below 2p, or add_nr of two where the
// sum feeds only products whose other factor is below 2p.  The accumulator
// leaves the last add below 2p and is canonicalized once, by one
// conditional subtraction of p, where it is stored.
// ---------------------------------------------------------------------------
#ifndef ZK_HORNER_P
#define ZK_HORNER_P 3
#endif
#ifndef ZK_HORNER_G
#define ZK_HORNER_G 6
#endif
constexpr int HORNER_P = ZK_HORNER_P;  // lanes a product
constexpr int HORNER_G = ZK_HORNER_G;  // products at once
constexpr int HORNER_N = FQ_LIMBS / HORNER_P;
constexpr uint32_t HORNER_THREADS = 32;
static_assert(FQ_LIMBS % HORNER_P == 0 && HORNER_P <= 6 && HORNER_G >= 4 && HORNER_G * HORNER_P <= 32,
              "a product's lanes split its 12 words, at least 2 a lane; the double's 4 products fit one warp");

struct HornerArgs {
  const uint32_t* parts[3];  // X, Y, Z of the window sums: contiguous (W, K, 12)
  uint32_t* out[3];          // X, Y, Z of the result: contiguous (K, 12)
  uint32_t W, K, c;
};

// Row k of window w of coordinate `coord`; selects rather than an index
// into the argument's array, which would put the array in local memory.
ZK_FN const uint32_t* horner_part(const HornerArgs& a, uint32_t coord, uint32_t w, uint32_t k) {
  const uint32_t* plane = coord == 0 ? a.parts[0] : (coord == 1 ? a.parts[1] : a.parts[2]);
  return plane + ((uint64_t)w * a.K + k) * FQ_LIMBS;
}

// t[0 .. 2N] += pr (2N words), one carry chain; the caller keeps the sum
// below 2^(32 (2N + 1)).
template <int N>
ZK_FN void add_wide(uint32_t* t, const uint32_t* pr) {
  t[0] = cc::add_cc(t[0], pr[0]);
#pragma unroll
  for (int j = 1; j < 2 * N; ++j) t[j] = cc::addc_cc(t[j], pr[j]);
  t[2 * N] = cc::addc(t[2 * N], 0);
}

// t[0 .. 2N] += x y for N-word x and y: the product by rows of carry chains
// (mad_row), then add_wide.
template <int N>
ZK_FN void mul_add_wide(uint32_t* t, const uint32_t* x, const uint32_t* y) {
  uint32_t pr[2 * N];
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) pr[j] = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) mad_row<N>(pr + k, x, y[k]);  // the product so far < 2^(32 (N + k + 1))
  add_wide<N>(t, pr);
}

// pr = x y (2N words) by 64-bit column sums and one pass of 64-bit carries:
// no carry chain, so the compiler schedules it beside the chains of the
// sum it feeds (a column is below 2N 2^32, so no sum overflows).
template <int N>
ZK_FN void mul_wide_u64(uint32_t* pr, const uint32_t* x, const uint32_t* y) {
  uint64_t col[2 * N];
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) col[j] = 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint64_t w = (uint64_t)x[j] * y[k];
      col[j + k] += (uint32_t)w;
      col[j + k + 1] += w >> 32;
    }
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) {
    c += col[j];
    pr[j] = (uint32_t)c;
    c >>= 32;
  }
}

// m = x y mod 2^(32 N).
template <int N>
ZK_FN void mul_lo(uint32_t* m, const uint32_t* x, const uint32_t* y) {
#pragma unroll
  for (int j = 0; j < N; ++j) m[j] = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; k + j < N; ++j) {
      const uint64_t s = (uint64_t)x[j] * y[k] + m[k + j] + c;  // <= 2^64 - 1
      m[k + j] = (uint32_t)s;
      c = s >> 32;
    }
  }
}

// q = -p^-1 mod 2^(32 N), word by word: word k of q is the one that clears
// word k of p q + 1, i.e. that word times pinv = -p^-1 mod 2^32.
template <int N>
ZK_FN void neg_pinv(uint32_t* q, const FqConsts& f) {
#pragma unroll
  for (int j = 0; j < N; ++j) q[j] = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint32_t r[N];
    mul_lo<N>(r, f.p, q);
    uint64_t c = 1;
#pragma unroll
    for (int j = 0; j <= k; ++j) {
      const uint64_t s = (uint64_t)r[j] + c;
      r[j] = (uint32_t)s;
      c = s >> 32;
    }
    q[k] = r[k] * f.pinv;
  }
}

// Digit d of a 12-word value, by selects rather than an index into
// registers (which would put the value in local memory).
ZK_FN void horner_digit(uint32_t* out, const uint32_t* v, uint32_t d) {
#pragma unroll
  for (int k = 0; k < HORNER_N; ++k) {
    uint32_t x = v[k];
#pragma unroll
    for (int e = 1; e < HORNER_P; ++e) x = d == (uint32_t)e ? v[e * HORNER_N + k] : x;
    out[k] = x;
  }
}

// out = v_i, the last value for larger i, by selects.
ZK_FN void pick4(uint32_t* out, uint32_t i, const uint32_t* v0, const uint32_t* v1, const uint32_t* v2,
                 const uint32_t* v3) {
#pragma unroll
  for (int j = 0; j < FQ_LIMBS; ++j) out[j] = i == 0 ? v0[j] : i == 1 ? v1[j] : i == 2 ? v2[j] : v3[j];
}

ZK_FN void pick6(uint32_t* out, uint32_t i, const uint32_t* v0, const uint32_t* v1, const uint32_t* v2,
                 const uint32_t* v3, const uint32_t* v4, const uint32_t* v5) {
#pragma unroll
  for (int j = 0; j < FQ_LIMBS; ++j)
    out[j] = i == 0 ? v0[j] : i == 1 ? v1[j] : i == 2 ? v2[j] : i == 3 ? v3[j] : i == 4 ? v4[j] : v5[j];
}

// A lane's place: product group g, digit d, the group's first lane, and
// the constants of its digit.
struct HornerLane {
  uint32_t g, d, base;
  uint32_t pd[HORNER_N];  // digit d of p
  uint32_t q[HORNER_N];   // -p^-1 mod 2^(32 N)
};

ZK_FN HornerLane horner_lane(uint32_t lane, const FqConsts& f) {
  HornerLane h;
  h.g = lane / HORNER_P;
  h.d = lane % HORNER_P;
  h.base = h.g * HORNER_P;
  horner_digit(h.pd, f.p, h.d);
  neg_pinv<HORNER_N>(h.q, f);
  return h;
}

// The product a b R^-1 of the group's lanes, lane-parallel CIOS by digits
// of N words: for i = 0 .. P - 1,
//     s += a b_i;  M_i = (s mod 2^(32 N)) q mod 2^(32 N);  s += M_i p;  s /= 2^(32 N),
// where each lane adds its digit's share, a_d b_i and M_i p_d, at its own
// window of the sum: 2N + 1 words from word d N.  M_i comes from digit 0's
// lane by shuffle (its low N words are the sum's); the division hands each
// lane's low N words to the lane below, with a shuffle (digit 0's are zero,
// and the last digit takes none).  A window is below 5 2^(32 N) after the
// division and below 3 2^(64 N) after the adds, so 2N + 1 words hold it
// (the last one below 4).  This is CIOS with M = sum M_i 2^(32 N i) < R, so
// the product is (a b + M p) / R, mont_mul_lazy's.  out is the lane's
// window, N + 1 words: the product is sum_d out_d 2^(32 N d), each last
// word a carry into the next digit, which horner_gather adds.
ZK_FN void horner_mul(uint32_t* out, const uint32_t* ad, const uint32_t* b, const HornerLane& h) {
  constexpr int N = HORNER_N;
  uint32_t s[2 * N + 1];
#pragma unroll
  for (int j = 0; j < 2 * N + 1; ++j) s[j] = 0;
  const uint32_t keep = h.d + 1 < (uint32_t)HORNER_P ? 0xffffffffu : 0u;
#pragma unroll
  for (int i = 0; i < HORNER_P; ++i) {
    uint32_t pr[2 * N], m[N], up[N];
    mul_wide_u64<N>(pr, ad, b + i * N);  // a_d b_i does not wait for s
    add_wide<N>(s, pr);
    mul_lo<N>(m, s, h.q);
#pragma unroll
    for (int k = 0; k < N; ++k) m[k] = warp_shfl(m[k], h.base);
    mul_add_wide<N>(s, h.pd, m);
#pragma unroll
    for (int k = 0; k < N; ++k) up[k] = warp_shfl(s[k], h.base + h.d + 1);
    s[0] = cc::add_cc(s[N], up[0] & keep);
#pragma unroll
    for (int k = 1; k < N; ++k) s[k] = cc::addc_cc(s[N + k], up[k] & keep);
    s[N] = cc::addc(s[2 * N], 0);
#pragma unroll
    for (int k = N + 1; k < 2 * N + 1; ++k) s[k] = 0;
  }
#pragma unroll
  for (int j = 0; j < N + 1; ++j) out[j] = s[j];
}

// out = this lane's share of the product a b R^-1 of its group.
ZK_FN void horner_product(uint32_t* out, const uint32_t* a, const uint32_t* b, const HornerLane& h) {
  uint32_t ad[HORNER_N];
  horner_digit(ad, a, h.d);
  horner_mul(out, ad, b, h);
}

// v = the whole product that group g's lanes hold (g may differ from lane
// to lane): the digits' windows by shuffles, then their carry words added
// in one 12-word chain.  The product is < 2p < R, so the last digit's carry
// word is 0 and no carry leaves word 11.
ZK_FN void horner_gather(uint32_t* v, const uint32_t* out, uint32_t g) {
  constexpr int N = HORNER_N;
  uint32_t top[HORNER_P];
#pragma unroll
  for (int e = 0; e < HORNER_P; ++e) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[e * N + k] = warp_shfl(out[k], g * HORNER_P + e);
    top[e] = e + 1 < HORNER_P ? warp_shfl(out[N], g * HORNER_P + e) : 0;
  }
  if constexpr (HORNER_P > 1) {
    v[N] = cc::add_cc(v[N], top[0]);
#pragma unroll
    for (int j = N + 1; j < FQ_LIMBS - 1; ++j) v[j] = cc::addc_cc(v[j], j % N == 0 ? top[j / N - 1] : 0);
    v[FQ_LIMBS - 1] = cc::addc(v[FQ_LIMBS - 1], 0);
  }
}

// RCB Alg. 9 on the lane's copy of the accumulator, in place: the first
// step's products (Y Y, Y Z, Z Z, X Y), then (t2 z3, t1 z3, t0' y3, t0' X Y).
// Takes X < 4p, Y, Z < 2p and gives the same.  z3 and y3 stay below 4p,
// since their other factors are below 2p.
ZK_FN void horner_double(uint32_t* X, uint32_t* Y, uint32_t* Z, const HornerLane& h, const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  const uint32_t* p2 = f.p2;
  uint32_t a[L], b[L], o[HORNER_N + 1], t0[L], u[L], e[L], z3[L], t2[L], y3[L];
  pick4(a, h.g, Y, Y, Z, X);
  pick4(b, h.g, Y, Z, Z, Y);
  horner_product(o, a, b, h);
  horner_gather(u, o, 2);                 // Z^2, first: the longest chain of sums starts from it
  horner_gather(t0, o, 0);                // t0 = Y^2
  horner_gather(e, o, h.g == 1 ? 1 : 3);  // t1 = Y Z for group 1, X Y for the others
  fq_mul12_lazy(t2, u, f);                // t2 = 3b Z^2
  add_red<L>(z3, t0, t0, p2);             // z3 = 8 Y^2 < 4p
  add_red<L>(z3, z3, z3, p2);
  add_nr<L>(z3, z3, z3);
  add_nr<L>(y3, t0, t2);                  // y3 = Y^2 + 3b Z^2 < 4p
  sub_red<L>(t0, t0, t2, p2);             // t0' = (Y^2 - 3b Z^2) - 6b Z^2 = Y^2 - 9b Z^2
  add_red<L>(u, t2, t2, p2);
  sub_red<L>(t0, t0, u, p2);
  pick4(a, h.g, t2, e, t0, t0);
  pick4(b, h.g, z3, z3, y3, e);
  horner_product(o, a, b, h);
  horner_gather(a, o, 2);                 // Y3 = t0' y3 + t2 z3
  horner_gather(b, o, 0);
  add_red<L>(Y, a, b, p2);
  horner_gather(Z, o, 1);                 // Z3 = t1 z3
  horner_gather(a, o, 3);                 // X3 = 2 t0' X Y < 4p
  add_nr<L>(X, a, a);
}

// RCB Alg. 7 in place: (X, Y, Z) += part[w] (row k, canonical).  Product j
// of a step runs in round j / G on group j % G: first X1 X2, Y1 Y2, Z1 Z2,
// (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2), then
// (t3 t1, t4 t5, t1 Zc, t5 t0, Zc t4, t0 t3).  Takes X < 4p (reduced to
// < 2p first, for the sums X1 + Y1 and X1 + Z1), Y, Z < 2p, and gives
// values < 2p.  t0 and Zc stay below 4p: each is a factor of two products
// whose other factor is below 2p.
ZK_FN void horner_add(uint32_t* X, uint32_t* Y, uint32_t* Z, const HornerArgs& args, uint32_t w, uint32_t k,
                      const HornerLane& h, const FqConsts& f) {
  constexpr int L = FQ_LIMBS, G = HORNER_G, ROUNDS = (6 + G - 1) / G;
  const uint32_t* p2 = f.p2;
  uint32_t o[ROUNDS][HORNER_N + 1], a[L], b[L], c[L];
  cond_sub<L>(X, X, p2);  // < 2p
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const uint32_t j = r * G + h.g;  // past 5: the last product again, unread
    const uint32_t i0 = j == 1 || j == 4 ? 1 : (j == 2 ? 2 : 0), i1 = j == 3 ? 1 : 2;
    const uint32_t both = j >= 3 ? 0xffffffffu : 0u;
    pick6(a, j, X, Y, Z, X, Y, X);
    pick6(c, j, Y, Z, Z, Y, Z, Z);
#pragma unroll
    for (int m = 0; m < L; ++m) c[m] &= both;
    add_nr<L>(a, a, c);  // < 4p
    load_row(b, horner_part(args, i0, w, k));
    load_row(c, horner_part(args, i1, w, k));
#pragma unroll
    for (int m = 0; m < L; ++m) c[m] &= both;
    add_nr<L>(b, b, c);  // < 2p
    horner_product(o[r], a, b, h);
  }
  uint32_t t0[L], t1[L], t3[L], t4[L], t5[L], zc[L];
  horner_gather(t0, o[0], 0);
  horner_gather(t1, o[0], 1);
  horner_gather(zc, o[0], 2);              // Z1 Z2 until Zc is formed
  add_red<L>(a, t0, t1, p2);   // t3 = X1 Y2 + X2 Y1
  horner_gather(t3, o[0], 3);
  sub_red<L>(t3, t3, a, p2);
  add_red<L>(a, t1, zc, p2);   // t4 = Y1 Z2 + Y2 Z1
  horner_gather(t4, o[4 / G], 4 % G);
  sub_red<L>(t4, t4, a, p2);
  add_red<L>(a, t0, zc, p2);   // t5 = X1 Z2 + X2 Z1
  horner_gather(t5, o[5 / G], 5 % G);
  sub_red<L>(t5, t5, a, p2);
  add_red<L>(a, t0, t0, p2);   // t0 = 3 X1 X2 < 4p
  add_nr<L>(t0, a, t0);
  fq_mul12_lazy(a, zc, f);     // 3b Z1 Z2
  add_nr<L>(zc, t1, a);        // Zc = Y1 Y2 + 3b Z1 Z2 < 4p
  sub_red<L>(t1, t1, a, p2);   // t1 = Y1 Y2 - 3b Z1 Z2
  fq_mul12_lazy(t5, t5, f);    // t5 = 3b (X1 Z2 + X2 Z1)
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const uint32_t j = r * G + h.g;
    pick6(a, j, t3, t4, t1, t5, zc, t0);
    pick6(b, j, t1, t5, zc, t0, t4, t3);
    horner_product(o[r], a, b, h);
  }
  horner_gather(a, o[0], 0);  // X3 = t3 t1 - t4 t5
  horner_gather(b, o[0], 1);
  sub_red<L>(X, a, b, p2);
  horner_gather(a, o[0], 2);  // Y3 = t1 Zc + t5 t0
  horner_gather(b, o[0], 3);
  add_red<L>(Y, a, b, p2);
  horner_gather(a, o[4 / G], 4 % G);  // Z3 = Zc t4 + t0 t3
  horner_gather(b, o[5 / G], 5 % G);
  add_red<L>(Z, a, b, p2);
}

// Window w's part rows into L1 while the doubles run, so that the add does
// not wait on device memory: the first and last byte of each 48-byte row.
ZK_FN void horner_prefetch(const HornerArgs& a, uint32_t w, uint32_t k) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (uint32_t i = 0; i < 3; ++i) {
    const uint32_t* row = horner_part(a, i, w, k);
    asm volatile("prefetch.global.L1 [%0];" ::"l"(row));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(row + FQ_LIMBS - 1));
  }
#else
  (void)a, (void)w, (void)k;
#endif
}

// Point k's whole chain, run by each lane of its warp; lane 0 stores it.
ZK_FN void horner_point(const HornerArgs& a, uint32_t k, uint32_t lane, const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  const HornerLane h = horner_lane(lane, f);
  uint32_t X[L], Y[L], Z[L];
  load_row(X, horner_part(a, 0, a.W - 1, k));
  load_row(Y, horner_part(a, 1, a.W - 1, k));
  load_row(Z, horner_part(a, 2, a.W - 1, k));
#pragma unroll 1
  for (uint32_t w = a.W - 1; w-- > 0;) {
    horner_prefetch(a, w, k);
#pragma unroll 1
    for (uint32_t i = 0; i < a.c; ++i) horner_double(X, Y, Z, h, f);
    horner_add(X, Y, Z, a, w, k, h, f);
  }
  if (lane == 0) {
    cond_sub<L>(X, X, f.p);
    cond_sub<L>(Y, Y, f.p);
    cond_sub<L>(Z, Z, f.p);
    store_row(a.out[0] + (uint64_t)k * L, X);
    store_row(a.out[1] + (uint64_t)k * L, Y);
    store_row(a.out[2] + (uint64_t)k * L, Z);
  }
}

// The latency of one product: x = a, then x = x b R^-1 `chain` times, each
// product lane-parallel in every group as the combine runs it and gathered
// whole before the next; lane 0 stores x canonical.  a, b canonical rows.
ZK_FN void horner_mul_chain(const uint32_t* a, const uint32_t* b, uint32_t* out, uint32_t chain, uint32_t lane,
                            const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  const HornerLane h = horner_lane(lane, f);
  uint32_t x[L], y[L], o[HORNER_N + 1];
  load_row(x, a);
  load_row(y, b);
#pragma unroll 1
  for (uint32_t i = 0; i < chain; ++i) {
    horner_product(o, x, y, h);
    horner_gather(x, o, h.g);
  }
  if (lane == 0) {
    cond_sub<L>(x, x, f.p);
    store_row(out, x);
  }
}
