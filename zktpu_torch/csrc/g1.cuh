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

// Where the first operand and the result of an add live.  MemRows: rows of
// device memory, read again at each use (the group-law kernels).  RegRows:
// registers, the fixed-base multiply's accumulator; there the result may
// overwrite P1, since the add reads P1 only before its first store.
struct MemRows {
  ZK_FN static void load(uint32_t* dst, const uint32_t* src) { load_row(dst, src); }
  ZK_FN static void store(uint32_t* dst, const uint32_t* src) { store_row(dst, src); }
};

struct RegRows {
  ZK_FN static void load(uint32_t* dst, const uint32_t* src) { copy_limbs<FQ_LIMBS>(dst, src); }
  ZK_FN static void store(uint32_t* dst, const uint32_t* src) { copy_limbs<FQ_LIMBS>(dst, src); }
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

// RCB Alg. 7: (x3, y3, z3) = (x1, y1, z1) + (x2, y2, z2), P2 in device
// memory, P1 and the result where Rows says.  The order (t0, t2, t5, t1, t4,
// t3) lets each sum of inputs be formed from fresh loads and each t be
// finished as soon as its two products exist.
template <class Rows = MemRows>
ZK_FN void proj_add_point(uint32_t* x3, uint32_t* y3, uint32_t* z3, const uint32_t* x1,
                          const uint32_t* y1, const uint32_t* z1, const uint32_t* x2,
                          const uint32_t* y2, const uint32_t* z2, const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  const uint32_t* p2 = f.p2;
  uint32_t t0[L], t1[L], t2[L], t3[L], t4[L], t5[L], a[L], b[L], c[L];
  Rows::load(a, x1);
  load_row(b, x2);
  fq_mul(t0, a, b, f);            // t0 = X1 X2
  Rows::load(c, z1);
  add_nr<L>(a, a, c);             // X1 + Z1 < 2p
  load_row(t2, z2);
  add_nr<L>(b, b, t2);            // X2 + Z2 < 2p
  fq_mul(t2, c, t2, f);           // t2 = Z1 Z2
  fq_mul(t5, a, b, f);
  add_red<L>(a, t0, t2, p2);      // t5 = X1 Z2 + X2 Z1
  sub_red<L>(t5, t5, a, p2);
  Rows::load(a, y1);
  load_row(b, y2);
  fq_mul(t1, a, b, f);            // t1 = Y1 Y2
  add_nr<L>(a, a, c);             // Y1 + Z1 < 2p
  load_row(c, z2);
  add_nr<L>(b, b, c);             // Y2 + Z2 < 2p
  fq_mul(t4, a, b, f);
  add_red<L>(a, t1, t2, p2);      // t4 = Y1 Z2 + Y2 Z1
  sub_red<L>(t4, t4, a, p2);
  Rows::load(a, x1);
  Rows::load(c, y1);
  add_nr<L>(a, a, c);             // X1 + Y1 < 2p
  load_row(b, x2);
  load_row(c, y2);
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
  finish_adds<Rows>(x3, y3, z3, t0, t1, t3, t4, t5, c, false, x1, y1, z1, f);
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
// `windows` windows of `window` bits (window divides 32), with the table
// T[w][j] = j 2^(window w) B precomputed (T[w][0] = O):
//     acc = O;  acc += T[w][digit_w(s)]  for w = 0 .. windows - 1,
// complete adds (Alg. 7) in the order of zktpu/curves/g1.py's fori_loop, so
// the output words are the plain loop's.  One thread per scalar: the
// accumulator stays in registers (RegRows), the table rows are read from
// device memory (L2: the table is 1.2 MB at window 8) and the result is
// written once.
// ---------------------------------------------------------------------------
struct FixedBaseArgs {
  const uint32_t* table[3];  // X, Y, Z of T: contiguous (windows, 2^window, 12)
  const uint32_t* scalars;   // (n, 8) little-endian 32-bit limbs, contiguous
  uint32_t* out[3];          // X, Y, Z of the result: contiguous (n, 12)
  uint32_t n, window, windows;
};

ZK_FN void fixed_base_at(const FixedBaseArgs& a, uint32_t i, const FqConsts& f) {
  uint32_t x[FQ_LIMBS], y[FQ_LIMBS], z[FQ_LIMBS];
  load_row(x, a.table[0]);  // T[0][0] = O = (0 : 1 : 0)
  load_row(y, a.table[1]);
  load_row(z, a.table[2]);
  const uint32_t* s = a.scalars + (uint64_t)i * 8;
  const uint32_t mask = (1u << a.window) - 1, row0 = 1u << a.window;
#pragma unroll 1
  for (uint32_t w = 0; w < a.windows; ++w) {
    const uint32_t bit = w * a.window;
    // the limb is read again each window rather than indexed in registers,
    // which would put the scalar in local memory
    const uint32_t digit = (s[bit >> 5] >> (bit & 31)) & mask;
    const uint64_t row = ((uint64_t)w * row0 + digit) * FQ_LIMBS;
    proj_add_point<RegRows>(x, y, z, x, y, z, a.table[0] + row, a.table[1] + row, a.table[2] + row, f);
  }
  store_row(a.out[0] + (uint64_t)i * FQ_LIMBS, x);
  store_row(a.out[1] + (uint64_t)i * FQ_LIMBS, y);
  store_row(a.out[2] + (uint64_t)i * FQ_LIMBS, z);
}

// ---------------------------------------------------------------------------
// The Horner combine of the MSM's window sums: acc = part[W-1], then for
// w = W-2 .. 0, c doublings (Alg. 9) and one add of part[w] (Alg. 7), the
// same canonical formulas as proj_double_point and proj_add_formula, so the
// same words.  The chain is serial, so its time is the latency of one
// double times (W - 1) c.  A group of HORNER_LANES lanes runs one point:
// the independent Montgomery products of each formula step go to separate
// lanes, which exchange them through the group's shared memory.  The double
// is two steps of four independent products (Y Y, Y Z, Z Z, X Y, then
// t2 z3, t1 z3, t0' y3, t0' (X Y)), the add two steps of six; between them
// every lane computes the few sums the next step needs, and lane 0 the
// formula's outputs.  With one lane per point the same schedule runs every
// product on that lane.  The schedule is a list of phases with a warp
// barrier after each (horner_schedule); the host tests run each phase for
// every lane in turn.
// ---------------------------------------------------------------------------
#ifndef ZK_HORNER_LANES
#define ZK_HORNER_LANES 4
#endif
constexpr uint32_t HORNER_LANES = ZK_HORNER_LANES;
constexpr uint32_t HORNER_THREADS = 32;  // one warp per block
constexpr uint32_t HORNER_GROUPS = HORNER_THREADS / HORNER_LANES;

struct HornerGroup {
  uint32_t P[3][FQ_LIMBS];  // the accumulator X, Y, Z
  uint32_t T[6][FQ_LIMBS];  // the products of a formula's first step
  uint32_t V[6][FQ_LIMBS];  // the products of its second step
};

struct HornerArgs {
  const uint32_t* parts[3];  // X, Y, Z of the window sums: contiguous (W, K, 12)
  uint32_t* out[3];          // X, Y, Z of the result: contiguous (K, 12)
  uint32_t W, K, c;
};

enum HornerPhase { H_LOAD, H_DBL1, H_DBL2, H_DBL3, H_ADD1, H_ADD2, H_ADD3, H_STORE };

// run(phase, w) runs one phase for the lanes and then synchronises them.
template <class Run>
ZK_FN void horner_schedule(Run&& run, uint32_t W, uint32_t c) {
  run(H_LOAD, W - 1);
  for (uint32_t w = W - 1; w-- > 0;) {
    for (uint32_t d = 0; d < c; ++d) {
      run(H_DBL1, w);
      run(H_DBL2, w);
      run(H_DBL3, w);
    }
    run(H_ADD1, w);
    run(H_ADD2, w);
    run(H_ADD3, w);
  }
  run(H_STORE, 0);
}

// Row k of window w of coordinate `coord`; selects rather than an index
// into the argument's array, which would put the array in local memory.
ZK_FN const uint32_t* horner_part(const HornerArgs& a, uint32_t coord, uint32_t w, uint32_t k) {
  const uint32_t* plane = coord == 0 ? a.parts[0] : (coord == 1 ? a.parts[1] : a.parts[2]);
  return plane + ((uint64_t)w * a.K + k) * FQ_LIMBS;
}

// One phase of point k's chain for lane `lane` of its group G.  `live` is
// false for the lanes of a group past the last point, which run along on
// point K - 1 and store nothing.
ZK_FN void horner_phase(int phase, HornerGroup& G, uint32_t lane, const HornerArgs& a, uint32_t k, bool live,
                        uint32_t w, const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  switch (phase) {
    case H_LOAD:
      if (lane == 0) {
        uint32_t x[L];
        for (uint32_t i = 0; i < 3; ++i) {
          load_row(x, horner_part(a, i, w, k));
          copy_limbs<L>(G.P[i], x);
        }
      }
      break;
    case H_DBL1:  // T = (Y Y, Y Z, Z Z, X Y)
#pragma unroll 1
      for (uint32_t q = lane; q < 4; q += HORNER_LANES) {
        uint32_t x[L], y[L];
        copy_limbs<L>(x, G.P[q == 3 ? 0 : (q == 2 ? 2 : 1)]);
        copy_limbs<L>(y, G.P[q == 0 || q == 3 ? 1 : 2]);
        fmul<L>(x, x, y, f);
        copy_limbs<L>(G.T[q], x);
      }
      break;
    case H_DBL2: {  // V = (t2 z3, t1 z3, t0' y3, t0' xy)
      uint32_t t0[L], t2[L], z3[L], y3[L], u[L];
      copy_limbs<L>(t0, G.T[0]);
      fdbl<L>(z3, t0, f);  // z3 = 8 Y^2
      fdbl<L>(z3, z3, f);
      fdbl<L>(z3, z3, f);
      copy_limbs<L>(u, G.T[2]);
      fq_mul12(t2, u, f);  // t2 = 3b Z^2
      fadd<L>(y3, t0, t2, f);
      fdbl<L>(u, t2, f);  // 9b Z^2
      fadd<L>(u, u, t2, f);
      fsub<L>(t0, t0, u, f);  // t0' = Y^2 - 9b Z^2
#pragma unroll 1
      for (uint32_t q = lane; q < 4; q += HORNER_LANES) {
        uint32_t x[L], y[L];
#pragma unroll
        for (int j = 0; j < L; ++j) {
          x[j] = q == 0 ? t2[j] : (q == 1 ? G.T[1][j] : t0[j]);
          y[j] = q <= 1 ? z3[j] : (q == 2 ? y3[j] : G.T[3][j]);
        }
        fmul<L>(x, x, y, f);
        copy_limbs<L>(G.V[q], x);
      }
      break;
    }
    case H_DBL3:  // (X3, Y3, Z3) = (2 t0' xy, t0' y3 + t2 z3, t1 z3)
      if (lane == 0) {
        uint32_t x[L], y[L];
        copy_limbs<L>(x, G.V[3]);
        fdbl<L>(G.P[0], x, f);
        copy_limbs<L>(x, G.V[2]);
        copy_limbs<L>(y, G.V[0]);
        fadd<L>(G.P[1], x, y, f);
        copy_limbs<L>(G.P[2], G.V[1]);
      }
      break;
    case H_ADD1:  // T = (X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2))
#pragma unroll 1
      for (uint32_t q = lane; q < 6; q += HORNER_LANES) {
        const uint32_t i0 = q < 3 ? q : (q == 4 ? 1 : 0), i1 = q == 3 ? 1 : 2;
        uint32_t x[L], y[L];
        copy_limbs<L>(x, G.P[i0]);
        load_row(y, horner_part(a, i0, w, k));
        if (q >= 3) {
          uint32_t t[L];
          copy_limbs<L>(t, G.P[i1]);
          fadd<L>(x, x, t, f);
          load_row(t, horner_part(a, i1, w, k));
          fadd<L>(y, y, t, f);
        }
        fmul<L>(x, x, y, f);
        copy_limbs<L>(G.T[q], x);
      }
      break;
    case H_ADD2: {  // V = (t3 t1, t4 t5, t1 Zc, t5 t0, Zc t4, t0 t3)
      uint32_t t0[L], t1[L], t3[L], t4[L], t5[L], zc[L], s[L];
      copy_limbs<L>(t0, G.T[0]);
      copy_limbs<L>(t1, G.T[1]);
      copy_limbs<L>(zc, G.T[2]);  // Z1 Z2 until Zc is formed
      fadd<L>(s, t0, t1, f);      // t3 = X1 Y2 + X2 Y1
      copy_limbs<L>(t3, G.T[3]);
      fsub<L>(t3, t3, s, f);
      fadd<L>(s, t1, zc, f);  // t4 = Y1 Z2 + Y2 Z1
      copy_limbs<L>(t4, G.T[4]);
      fsub<L>(t4, t4, s, f);
      fadd<L>(s, t0, zc, f);  // t5 = X1 Z2 + X2 Z1
      copy_limbs<L>(t5, G.T[5]);
      fsub<L>(t5, t5, s, f);
      fdbl<L>(s, t0, f);  // t0 = 3 X1 X2
      fadd<L>(t0, s, t0, f);
      fq_mul12(s, zc, f);  // 3b Z1 Z2
      fadd<L>(zc, t1, s, f);  // Zc = Y1 Y2 + 3b Z1 Z2
      fsub<L>(t1, t1, s, f);  // t1 = Y1 Y2 - 3b Z1 Z2
      fq_mul12(t5, t5, f);    // t5 = 3b (X1 Z2 + X2 Z1)
#pragma unroll 1
      for (uint32_t q = lane; q < 6; q += HORNER_LANES) {
        uint32_t x[L], y[L];
#pragma unroll
        for (int j = 0; j < L; ++j) {
          x[j] = q == 0 ? t3[j] : q == 1 ? t4[j] : q == 2 ? t1[j] : q == 3 ? t5[j] : q == 4 ? zc[j] : t0[j];
          y[j] = q == 0 ? t1[j] : q == 1 ? t5[j] : q == 2 ? zc[j] : q == 3 ? t0[j] : q == 4 ? t4[j] : t3[j];
        }
        fmul<L>(x, x, y, f);
        copy_limbs<L>(G.V[q], x);
      }
      break;
    }
    case H_ADD3:  // (X3, Y3, Z3) = (t3 t1 - t4 t5, t1 Zc + t5 t0, Zc t4 + t0 t3)
      if (lane == 0) {
        uint32_t x[L], y[L];
        for (uint32_t i = 0; i < 3; ++i) {
          copy_limbs<L>(x, G.V[2 * i]);
          copy_limbs<L>(y, G.V[2 * i + 1]);
          if (i == 0)
            fsub<L>(G.P[0], x, y, f);
          else
            fadd<L>(G.P[i], x, y, f);
        }
      }
      break;
    case H_STORE:
      if (lane == 0 && live) {
        uint32_t x[L];
        for (uint32_t i = 0; i < 3; ++i) {
          copy_limbs<L>(x, G.P[i]);
          store_row((i == 0 ? a.out[0] : (i == 1 ? a.out[1] : a.out[2])) + (uint64_t)k * L, x);
        }
      }
      break;
  }
}
