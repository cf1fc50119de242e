// BLS12-381 ate pairing, native host implementation.
//
// The reference obtains pairings from arkworks (`Bls12_381::pairing`,
// kzg/src/scheme.rs:167-169, plonk/src/verifier.rs:128-151, used by every
// KZG/PLONK/Nova verification).  Pairings are O(1) per verification and do
// not belong on the TPU (SURVEY.md §7 hard part 5); this module is the
// native runtime piece that replaces the pure-python fallback
// (zktpu/curves/pairing.py) on hosts with a C++ toolchain — same tower,
// same Miller-loop structure, ~10-30x faster.
//
// Field: Fq = 6x64-bit limbs, Montgomery form (R = 2^384), CIOS multiply
// with unsigned __int128 accumulators.  Tower (identical to the python
// implementation and to arkworks ark-bls12-381):
//   Fq2  = Fq[u]/(u^2+1)
//   Fq6  = Fq2[v]/(v^3 - xi), xi = 1+u
//   Fq12 = Fq6[w]/(w^2 - v)
// Miller loop: textbook affine double-and-add on the untwisted point in
// E(Fq12) with verticals (1:1 port of zktpu/curves/pairing.py so the two
// implementations agree value-for-value); the final exponentiation is the
// full pow by (q^12-1)/r, whose byte representation the caller supplies.
//
// The port's own copy of native/pairing.cpp.  zktpu_torch/curves/native_pairing.py
// builds it into build/zktpu_torch/ at the root of the checkout:
// Build: g++ -O2 -shared -fPIC -o libzkpairing-<hash>.so pairing.cpp
// ABI (all field values canonical little-endian u64 limbs, NOT Montgomery):
//   int zkp_pairing_product(const uint64_t* g1_xy,  // n * 12 limbs (x,y)
//                           const uint8_t*  g1_inf, // n flags
//                           const uint64_t* g2_xy,  // n * 24 limbs
//                                                   // (x.c0,x.c1,y.c0,y.c1)
//                           const uint8_t*  g2_inf, // n flags
//                           size_t n,
//                           const uint8_t* exp_le, size_t exp_len,
//                           uint64_t* out);         // 72 limbs (Fq12)
// Returns 0 on success.  Out coefficient order: c0.c0.c0, c0.c0.c1,
// c0.c1.c0, ..., c1.c2.c1 (Fq6 then Fq2 then Fq nesting, low first).

#include <cstdint>
#include <cstring>

namespace {

typedef unsigned __int128 u128;

struct Fp {
    uint64_t v[6];  // Montgomery form
};

static const uint64_t P[6] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const uint64_t R2[6] = {
    0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL,
    0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL};
static const uint64_t PINV64 = 0x89f3fffcfffcfffdULL;
static const uint64_t ONE_M[6] = {
    0x760900000002fffdULL, 0xebf4000bc40c0002ULL, 0x5f48985753c758baULL,
    0x77ce585370525745ULL, 0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL};

inline bool geq_p(const uint64_t a[6]) {
    for (int i = 5; i >= 0; --i) {
        if (a[i] > P[i]) return true;
        if (a[i] < P[i]) return false;
    }
    return true;  // equal
}

inline void sub_p(uint64_t a[6]) {
    u128 borrow = 0;
    for (int i = 0; i < 6; ++i) {
        u128 d = (u128)a[i] - P[i] - borrow;
        a[i] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
}

inline Fp fp_add(const Fp& a, const Fp& b) {
    Fp r;
    u128 carry = 0;
    for (int i = 0; i < 6; ++i) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        r.v[i] = (uint64_t)s;
        carry = s >> 64;
    }
    if (carry || geq_p(r.v)) sub_p(r.v);
    return r;
}

inline Fp fp_sub(const Fp& a, const Fp& b) {
    Fp r;
    u128 borrow = 0;
    for (int i = 0; i < 6; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        r.v[i] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 6; ++i) {
            u128 s = (u128)r.v[i] + P[i] + carry;
            r.v[i] = (uint64_t)s;
            carry = s >> 64;
        }
    }
    return r;
}

inline Fp fp_neg(const Fp& a) {
    Fp zero;
    std::memset(zero.v, 0, sizeof zero.v);
    return fp_sub(zero, a);
}

// CIOS Montgomery multiplication.
inline Fp fp_mul(const Fp& a, const Fp& b) {
    uint64_t t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 6; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 6; ++j) {
            u128 cur = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
            t[j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[6] + carry;
        t[6] = (uint64_t)cur;
        t[7] = (uint64_t)(cur >> 64);

        uint64_t m = t[0] * PINV64;
        carry = ((u128)t[0] + (u128)m * P[0]) >> 64;
        for (int j = 1; j < 6; ++j) {
            u128 c2 = (u128)t[j] + (u128)m * P[j] + carry;
            t[j - 1] = (uint64_t)c2;
            carry = c2 >> 64;
        }
        cur = (u128)t[6] + carry;
        t[5] = (uint64_t)cur;
        t[6] = t[7] + (uint64_t)(cur >> 64);
        t[7] = 0;
    }
    Fp r;
    std::memcpy(r.v, t, sizeof r.v);
    if (t[6] || geq_p(r.v)) sub_p(r.v);
    return r;
}

inline Fp fp_zero() {
    Fp r;
    std::memset(r.v, 0, sizeof r.v);
    return r;
}

inline Fp fp_one() {
    Fp r;
    std::memcpy(r.v, ONE_M, sizeof r.v);
    return r;
}

inline bool fp_is_zero(const Fp& a) {
    for (int i = 0; i < 6; ++i)
        if (a.v[i]) return false;
    return true;
}

inline Fp fp_from_canonical(const uint64_t* limbs) {
    Fp raw;
    std::memcpy(raw.v, limbs, sizeof raw.v);
    Fp r2;
    std::memcpy(r2.v, R2, sizeof r2.v);
    return fp_mul(raw, r2);
}

inline void fp_to_canonical(const Fp& a, uint64_t* out) {
    Fp one_raw;
    std::memset(one_raw.v, 0, sizeof one_raw.v);
    one_raw.v[0] = 1;
    Fp c = fp_mul(a, one_raw);
    std::memcpy(out, c.v, sizeof c.v);
}

// a^(p-2) — Fermat inversion (a != 0).
inline Fp fp_inv(const Fp& a) {
    // exponent p-2, scanned LSB->MSB
    uint64_t e[6];
    std::memcpy(e, P, sizeof e);
    // p - 2 (p is odd, low limb >= 2: no borrow chain needed beyond limb 0)
    e[0] -= 2;
    Fp result = fp_one();
    Fp base = a;
    for (int limb = 0; limb < 6; ++limb) {
        uint64_t bits = e[limb];
        for (int i = 0; i < 64; ++i) {
            if (bits & 1) result = fp_mul(result, base);
            base = fp_mul(base, base);
            bits >>= 1;
        }
    }
    return result;
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2+1)
// ---------------------------------------------------------------------------

struct Fp2 {
    Fp c0, c1;
};

inline Fp2 fp2_zero() { return {fp_zero(), fp_zero()}; }
inline Fp2 fp2_one() { return {fp_one(), fp_zero()}; }

inline Fp2 fp2_add(const Fp2& a, const Fp2& b) {
    return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}
inline Fp2 fp2_sub(const Fp2& a, const Fp2& b) {
    return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}
inline Fp2 fp2_neg(const Fp2& a) { return {fp_neg(a.c0), fp_neg(a.c1)}; }

inline Fp2 fp2_mul(const Fp2& a, const Fp2& b) {
    Fp t0 = fp_mul(a.c0, b.c0);
    Fp t1 = fp_mul(a.c1, b.c1);
    Fp t2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
    return {fp_sub(t0, t1), fp_sub(fp_sub(t2, t0), t1)};
}

inline Fp2 fp2_sqr(const Fp2& a) {
    // (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u   (2 muls)
    Fp t = fp_mul(a.c0, a.c1);
    return {fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1)), fp_add(t, t)};
}

inline Fp2 fp2_inv(const Fp2& a) {
    Fp norm = fp_add(fp_mul(a.c0, a.c0), fp_mul(a.c1, a.c1));
    Fp ninv = fp_inv(norm);
    return {fp_mul(a.c0, ninv), fp_neg(fp_mul(a.c1, ninv))};
}

inline bool fp2_is_zero(const Fp2& a) {
    return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

// xi = 1 + u
inline Fp2 fp2_mul_xi(const Fp2& a) {
    return {fp_sub(a.c0, a.c1), fp_add(a.c0, a.c1)};
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v]/(v^3 - xi)
// ---------------------------------------------------------------------------

struct Fp6 {
    Fp2 c0, c1, c2;
};

inline Fp6 fp6_zero() { return {fp2_zero(), fp2_zero(), fp2_zero()}; }
inline Fp6 fp6_one() { return {fp2_one(), fp2_zero(), fp2_zero()}; }

inline Fp6 fp6_add(const Fp6& a, const Fp6& b) {
    return {fp2_add(a.c0, b.c0), fp2_add(a.c1, b.c1), fp2_add(a.c2, b.c2)};
}
inline Fp6 fp6_sub(const Fp6& a, const Fp6& b) {
    return {fp2_sub(a.c0, b.c0), fp2_sub(a.c1, b.c1), fp2_sub(a.c2, b.c2)};
}
inline Fp6 fp6_neg(const Fp6& a) {
    return {fp2_neg(a.c0), fp2_neg(a.c1), fp2_neg(a.c2)};
}

inline Fp6 fp6_mul(const Fp6& a, const Fp6& b) {
    // Karatsuba 3-way with v^3 = xi: 6 Fq2 muls (same value as schoolbook)
    Fp2 v0 = fp2_mul(a.c0, b.c0);
    Fp2 v1 = fp2_mul(a.c1, b.c1);
    Fp2 v2 = fp2_mul(a.c2, b.c2);
    Fp2 m12 = fp2_mul(fp2_add(a.c1, a.c2), fp2_add(b.c1, b.c2));
    Fp2 m01 = fp2_mul(fp2_add(a.c0, a.c1), fp2_add(b.c0, b.c1));
    Fp2 m02 = fp2_mul(fp2_add(a.c0, a.c2), fp2_add(b.c0, b.c2));
    Fp2 d0 = fp2_add(v0, fp2_mul_xi(fp2_sub(fp2_sub(m12, v1), v2)));
    Fp2 d1 = fp2_add(fp2_sub(fp2_sub(m01, v0), v1), fp2_mul_xi(v2));
    Fp2 d2 = fp2_add(fp2_sub(fp2_sub(m02, v0), v2), v1);
    return {d0, d1, d2};
}

inline Fp6 fp6_mul_by_v(const Fp6& a) {
    return {fp2_mul_xi(a.c2), a.c0, a.c1};
}

inline Fp6 fp6_inv(const Fp6& a) {
    Fp2 t0 = fp2_sub(fp2_sqr(a.c0), fp2_mul_xi(fp2_mul(a.c1, a.c2)));
    Fp2 t1 = fp2_sub(fp2_mul_xi(fp2_sqr(a.c2)), fp2_mul(a.c0, a.c1));
    Fp2 t2 = fp2_sub(fp2_sqr(a.c1), fp2_mul(a.c0, a.c2));
    Fp2 denom = fp2_add(fp2_mul(a.c0, t0),
                        fp2_mul_xi(fp2_add(fp2_mul(a.c2, t1), fp2_mul(a.c1, t2))));
    Fp2 dinv = fp2_inv(denom);
    return {fp2_mul(t0, dinv), fp2_mul(t1, dinv), fp2_mul(t2, dinv)};
}

// ---------------------------------------------------------------------------
// Fq12 = Fq6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct Fp12 {
    Fp6 c0, c1;
};

inline Fp12 fp12_zero() { return {fp6_zero(), fp6_zero()}; }
inline Fp12 fp12_one() { return {fp6_one(), fp6_zero()}; }

inline Fp12 fp12_add(const Fp12& a, const Fp12& b) {
    return {fp6_add(a.c0, b.c0), fp6_add(a.c1, b.c1)};
}
inline Fp12 fp12_sub(const Fp12& a, const Fp12& b) {
    return {fp6_sub(a.c0, b.c0), fp6_sub(a.c1, b.c1)};
}
inline Fp12 fp12_neg(const Fp12& a) { return {fp6_neg(a.c0), fp6_neg(a.c1)}; }

inline Fp12 fp12_mul(const Fp12& a, const Fp12& b) {
    // Karatsuba: 3 Fq6 muls
    Fp6 t0 = fp6_mul(a.c0, b.c0);
    Fp6 t1 = fp6_mul(a.c1, b.c1);
    Fp6 m = fp6_mul(fp6_add(a.c0, a.c1), fp6_add(b.c0, b.c1));
    return {fp6_add(t0, fp6_mul_by_v(t1)), fp6_sub(fp6_sub(m, t0), t1)};
}

inline Fp12 fp12_sqr(const Fp12& a) {
    // (a0 + a1 w)^2 with w^2 = v: 2 Fq6 muls
    Fp6 t = fp6_mul(a.c0, a.c1);
    Fp6 m = fp6_mul(fp6_add(a.c0, a.c1), fp6_add(a.c0, fp6_mul_by_v(a.c1)));
    return {fp6_sub(fp6_sub(m, t), fp6_mul_by_v(t)), fp6_add(t, t)};
}

inline Fp12 fp12_conj(const Fp12& a) { return {a.c0, fp6_neg(a.c1)}; }

inline Fp12 fp12_inv(const Fp12& a) {
    Fp6 t = fp6_sub(fp6_mul(a.c0, a.c0), fp6_mul_by_v(fp6_mul(a.c1, a.c1)));
    Fp6 tinv = fp6_inv(t);
    return {fp6_mul(a.c0, tinv), fp6_neg(fp6_mul(a.c1, tinv))};
}

inline Fp12 fp12_pow_bytes(const Fp12& a, const uint8_t* exp_le, size_t len) {
    Fp12 result = fp12_one();
    Fp12 base = a;
    for (size_t i = 0; i < len; ++i) {
        uint8_t byte = exp_le[i];
        for (int bit = 0; bit < 8; ++bit) {
            if (byte & 1) result = fp12_mul(result, base);
            base = fp12_sqr(base);
            byte >>= 1;
        }
    }
    return result;
}

inline bool fp12_eq(const Fp12& a, const Fp12& b) {
    return std::memcmp(&a, &b, sizeof(Fp12)) == 0;  // canonical Montgomery forms
}

// scalar embeddings
inline Fp12 fp12_from_small(uint64_t k) {
    uint64_t limbs[6] = {k, 0, 0, 0, 0, 0};
    Fp12 r = fp12_zero();
    r.c0.c0.c0 = fp_from_canonical(limbs);
    return r;
}

// ---------------------------------------------------------------------------
// Miller loop on E(Fq12) (1:1 port of zktpu/curves/pairing.py::_miller_loop)
// ---------------------------------------------------------------------------

struct G1 {
    Fp x, y;
    bool inf;
};
struct G2 {
    Fp2 x, y;
    bool inf;
};

// |BLS_X| = 0xd201000000010000; bits after the leading 1, MSB-first.
static const char* BLS_X_BITS =
    "101001000000001000000000000000000000000000000010000000000000000";

struct Untwist {
    Fp12 w_m2, w_m3;  // w^-2, w^-3
};

inline Untwist make_untwist() {
    Fp12 w = fp12_zero();
    w.c1 = fp6_one();
    Fp12 w2 = fp12_mul(w, w);
    Fp12 w3 = fp12_mul(w2, w);
    return {fp12_inv(w2), fp12_inv(w3)};
}

inline Fp12 embed_fp2(const Fp2& a) {
    Fp12 r = fp12_zero();
    r.c0.c0 = a;
    return r;
}

inline Fp12 miller_loop(const G1& p, const G2& q, const Untwist& tw) {
    if (p.inf || q.inf) return fp12_one();
    Fp12 Qx = fp12_mul(embed_fp2(q.x), tw.w_m2);
    Fp12 Qy = fp12_mul(embed_fp2(q.y), tw.w_m3);
    Fp12 xp = fp12_zero();
    xp.c0.c0.c0 = p.x;
    Fp12 yp = fp12_zero();
    yp.c0.c0.c0 = p.y;

    Fp12 num = fp12_one(), den = fp12_one();
    Fp12 Tx = Qx, Ty = Qy;
    const Fp12 three = fp12_from_small(3);
    for (const char* b = BLS_X_BITS; *b; ++b) {
        // tangent at T evaluated at P
        Fp12 lam = fp12_mul(fp12_mul(fp12_sqr(Tx), three),
                            fp12_inv(fp12_add(Ty, Ty)));
        Fp12 l_val = fp12_sub(fp12_sub(yp, Ty), fp12_mul(lam, fp12_sub(xp, Tx)));
        Fp12 x3 = fp12_sub(fp12_sub(fp12_sqr(lam), Tx), Tx);
        Fp12 y3 = fp12_sub(fp12_mul(lam, fp12_sub(Tx, x3)), Ty);
        Tx = x3;
        Ty = y3;
        Fp12 v_val = fp12_sub(xp, Tx);
        num = fp12_mul(fp12_sqr(num), l_val);
        den = fp12_mul(fp12_sqr(den), v_val);
        if (*b == '1') {
            Fp12 lam2;
            if (fp12_eq(Tx, Qx) && fp12_eq(Ty, Qy)) {
                lam2 = fp12_mul(fp12_mul(fp12_sqr(Tx), three),
                                fp12_inv(fp12_add(Ty, Ty)));
            } else {
                lam2 = fp12_mul(fp12_sub(Qy, Ty), fp12_inv(fp12_sub(Qx, Tx)));
            }
            Fp12 l2 = fp12_sub(fp12_sub(yp, Ty), fp12_mul(lam2, fp12_sub(xp, Tx)));
            Fp12 x4 = fp12_sub(fp12_sub(fp12_sqr(lam2), Tx), Qx);
            Fp12 y4 = fp12_sub(fp12_mul(lam2, fp12_sub(Tx, x4)), Ty);
            Tx = x4;
            Ty = y4;
            num = fp12_mul(num, l2);
            den = fp12_mul(den, fp12_sub(xp, Tx));
        }
    }
    Fp12 f = fp12_mul(num, fp12_inv(den));
    return fp12_conj(f);  // BLS parameter x < 0 (same convention as python)
}

}  // namespace

extern "C" int zkp_pairing_product(const uint64_t* g1_xy, const uint8_t* g1_inf,
                                   const uint64_t* g2_xy, const uint8_t* g2_inf,
                                   size_t n, const uint8_t* exp_le,
                                   size_t exp_len, uint64_t* out) {
    Untwist tw = make_untwist();
    Fp12 f = fp12_one();
    for (size_t i = 0; i < n; ++i) {
        G1 p;
        p.inf = g1_inf[i] != 0;
        p.x = fp_from_canonical(g1_xy + i * 12);
        p.y = fp_from_canonical(g1_xy + i * 12 + 6);
        G2 q;
        q.inf = g2_inf[i] != 0;
        q.x.c0 = fp_from_canonical(g2_xy + i * 24);
        q.x.c1 = fp_from_canonical(g2_xy + i * 24 + 6);
        q.y.c0 = fp_from_canonical(g2_xy + i * 24 + 12);
        q.y.c1 = fp_from_canonical(g2_xy + i * 24 + 18);
        f = fp12_mul(f, miller_loop(p, q, tw));
    }
    Fp12 r = fp12_pow_bytes(f, exp_le, exp_len);
    const Fp* coeffs[12] = {
        &r.c0.c0.c0, &r.c0.c0.c1, &r.c0.c1.c0, &r.c0.c1.c1,
        &r.c0.c2.c0, &r.c0.c2.c1, &r.c1.c0.c0, &r.c1.c0.c1,
        &r.c1.c1.c0, &r.c1.c1.c1, &r.c1.c2.c0, &r.c1.c2.c1};
    for (int i = 0; i < 12; ++i) fp_to_canonical(*coeffs[i], out + i * 6);
    return 0;
}
