// FRI's fold over Goldilocks as per-thread code (csrc/fri_fold.cu runs it on
// the card, tests/ntt_host.cpp on the CPU): out[i] = c[2i] + r c[2i+1] for
// the (n, 2) Montgomery coefficients c, the last odd term 0 when n is odd
// (zktpu/fri/prover.py::fold_polynomial, prover.rs:34-42).  Every value is
// canonical (field.cuh's gl_mul and gl_add), so the words equal the plain
// fold's: the product by r and the add of the padded odd half.
#pragma once

#include "field.cuh"

// Output i of the fold of n coefficients (i < ceil(n / 2)).
ZK_FN uint64_t fri_fold_at(const uint64_t* c, int64_t n, uint64_t r, int64_t i) {
  const uint64_t odd = 2 * i + 1 < n ? c[2 * i + 1] : 0;
  return gl_add(c[2 * i], gl_mul(odd, r));
}
