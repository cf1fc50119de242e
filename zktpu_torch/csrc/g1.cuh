// The complete projective group law of BLS12-381 G1 (y^2 = x^3 + 4) over Fq
// limbs, as straight-line device code: Renes-Costello-Batina 2015/1060,
// Alg. 7 (add, 12M), Alg. 8 (mixed add, 11M) and Alg. 9 (double, 6M + 2S),
// for a = 0 and 3b = 12.  The same operation sequence as
// zktpu/curves/g1.py::_proj_add_jnp, _proj_madd_jnp and _proj_double_jnp;
// each helper is canonical, so the output words are equal.  The identity is
// (0 : 1 : 0); all-zero inputs map to all-zero outputs.  The mixed add's
// affine operand encodes its identity as (0, 0) (off the curve, so
// unambiguous), which a final select on both coordinates handles.
#pragma once

#include "field.cuh"

constexpr int FQ_LIMBS = 12;
using FqConsts = FieldConsts<FQ_LIMBS>;

// 12 a = 3b a as the double/add chain of pallas_g1.py::_mul12.
__device__ __forceinline__ void fq_mul12(uint32_t* out, const uint32_t* a, const FqConsts& f) {
  uint32_t a4[FQ_LIMBS], a8[FQ_LIMBS];
  fdbl<FQ_LIMBS>(a4, a, f);
  fdbl<FQ_LIMBS>(a4, a4, f);
  fdbl<FQ_LIMBS>(a8, a4, f);
  fadd<FQ_LIMBS>(out, a8, a4, f);
}

__device__ __forceinline__ void proj_add_point(uint32_t* X3, uint32_t* Y3, uint32_t* Z3,
                                               const uint32_t* X1, const uint32_t* Y1,
                                               const uint32_t* Z1, const uint32_t* X2,
                                               const uint32_t* Y2, const uint32_t* Z2,
                                               const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  uint32_t t0[L], t1[L], t2[L], t3[L], t4[L], t5[L], u[L], v[L];
  fmul<L>(t0, X1, X2, f);
  fmul<L>(t1, Y1, Y2, f);
  fmul<L>(t2, Z1, Z2, f);
  fadd<L>(u, X1, Y1, f);  // t3 = X1 Y2 + X2 Y1
  fadd<L>(v, X2, Y2, f);
  fmul<L>(t3, u, v, f);
  fadd<L>(u, t0, t1, f);
  fsub<L>(t3, t3, u, f);
  fadd<L>(u, Y1, Z1, f);  // t4 = Y1 Z2 + Y2 Z1
  fadd<L>(v, Y2, Z2, f);
  fmul<L>(t4, u, v, f);
  fadd<L>(u, t1, t2, f);
  fsub<L>(t4, t4, u, f);
  fadd<L>(u, X1, Z1, f);  // t5 = X1 Z2 + X2 Z1
  fadd<L>(v, X2, Z2, f);
  fmul<L>(t5, u, v, f);
  fadd<L>(u, t0, t2, f);
  fsub<L>(t5, t5, u, f);
  fdbl<L>(u, t0, f);  // t0 = 3 X1 X2
  fadd<L>(t0, u, t0, f);
  fq_mul12(t2, t2, f);  // t2 = 3b Z1 Z2
  fadd<L>(u, t1, t2, f);  // u = Zc = Y1 Y2 + 3b Z1 Z2
  fsub<L>(t1, t1, t2, f);  // t1 = Y1 Y2 - 3b Z1 Z2
  fq_mul12(t5, t5, f);  // t5 = 3b (X1 Z2 + X2 Z1)
  fmul<L>(v, t3, t1, f);  // X3 = t3 t1 - t4 t5
  fmul<L>(t2, t4, t5, f);
  fsub<L>(X3, v, t2, f);
  fmul<L>(v, t1, u, f);  // Y3 = t1 Zc + t5 t0
  fmul<L>(t2, t5, t0, f);
  fadd<L>(Y3, v, t2, f);
  fmul<L>(v, u, t4, f);  // Z3 = Zc t4 + t0 t3
  fmul<L>(t2, t0, t3, f);
  fadd<L>(Z3, v, t2, f);
}

// Projective P1 plus affine (X2, Y2) with Z2 = 1.  Zero-padded rows (all
// inputs zero) come out as P1, i.e. all zero.
__device__ __forceinline__ void proj_madd_point(uint32_t* X3, uint32_t* Y3, uint32_t* Z3,
                                                const uint32_t* X1, const uint32_t* Y1,
                                                const uint32_t* Z1, const uint32_t* X2,
                                                const uint32_t* Y2, const FqConsts& f) {
  constexpr int L = FQ_LIMBS;
  uint32_t t0[L], t1[L], t2[L], t3[L], t4[L], t5[L], u[L], v[L];
  fmul<L>(t0, X1, X2, f);
  fmul<L>(t1, Y1, Y2, f);
  fadd<L>(u, X1, Y1, f);  // t3 = X1 Y2 + X2 Y1
  fadd<L>(v, X2, Y2, f);
  fmul<L>(t3, u, v, f);
  fadd<L>(u, t0, t1, f);
  fsub<L>(t3, t3, u, f);
  fmul<L>(u, Y2, Z1, f);  // t4 = Y1 + Y2 Z1
  fadd<L>(t4, Y1, u, f);
  fmul<L>(u, X2, Z1, f);  // t5 = X1 + X2 Z1
  fadd<L>(t5, X1, u, f);
  fdbl<L>(u, t0, f);  // t0 = 3 X1 X2
  fadd<L>(t0, u, t0, f);
  fq_mul12(t2, Z1, f);  // t2 = 3b Z1
  fadd<L>(u, t1, t2, f);  // u = Zc = Y1 Y2 + 3b Z1
  fsub<L>(t1, t1, t2, f);  // t1 = Y1 Y2 - 3b Z1
  fq_mul12(t5, t5, f);  // t5 = 3b (X1 + X2 Z1)
  const bool inf2 = is_zero<L>(X2) && is_zero<L>(Y2);  // the affine identity (0, 0)
  fmul<L>(v, t3, t1, f);  // X3 = t3 t1 - t4 t5
  fmul<L>(t2, t4, t5, f);
  fsub<L>(v, v, t2, f);
#pragma unroll
  for (int j = 0; j < L; ++j) X3[j] = inf2 ? X1[j] : v[j];
  fmul<L>(v, t1, u, f);  // Y3 = t1 Zc + t5 t0
  fmul<L>(t2, t5, t0, f);
  fadd<L>(v, v, t2, f);
#pragma unroll
  for (int j = 0; j < L; ++j) Y3[j] = inf2 ? Y1[j] : v[j];
  fmul<L>(v, u, t4, f);  // Z3 = Zc t4 + t0 t3
  fmul<L>(t2, t0, t3, f);
  fadd<L>(v, v, t2, f);
#pragma unroll
  for (int j = 0; j < L; ++j) Z3[j] = inf2 ? Z1[j] : v[j];
}

__device__ __forceinline__ void proj_double_point(uint32_t* X3, uint32_t* Y3, uint32_t* Z3,
                                                  const uint32_t* X, const uint32_t* Y,
                                                  const uint32_t* Z, const FqConsts& f) {
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
