"""BLS12-381 pairing, host-side (python ints).

The port's own copy of zktpu/curves/pairing.py.

Pairings are O(1) per verification and never a throughput bottleneck
(kzg/src/scheme.rs:167-169, plonk/src/verifier.rs:128-151), so this
implementation optimizes for evident correctness over speed:

  * Tower: Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - ξ), ξ = 1+u;
    Fq12 = Fq6[w]/(w^2 - v).
  * G2 points are untwisted into E(Fq12) explicitly (ψ(x,y) = (x/w^2, y/w^3);
    checked on-curve), and the Miller loop uses the textbook line/vertical
    functions on E(Fq12) — no sparse-multiplication shortcuts to get wrong.
  * Final exponentiation: easy part via conjugation/inversion/frobenius-by-pow,
    hard part by a plain pow with exponent (q^4 - q^2 + 1)/r.

Verification predicates use `pairing_product`, which shares one final
exponentiation across all pairs (the standard multi-pairing trick).
"""
from __future__ import annotations

import functools

from ..fields.host import BLS_X, FQ, FR
from .host_curve import Fq2, G1Affine, G2Affine, XI

P = FQ.modulus


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @classmethod
    def zero(cls):
        return cls(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @classmethod
    def one(cls):
        return cls(Fq2.one(), Fq2.zero(), Fq2.zero())

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        if isinstance(o, Fq2):
            return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        d0 = a0 * b0 + (a1 * b2 + a2 * b1) * XI
        d1 = a0 * b1 + a1 * b0 + (a2 * b2) * XI
        d2 = a0 * b2 + a1 * b1 + a2 * b0
        return Fq6(d0, d1, d2)

    def mul_by_v(self):
        # v * (c0 + c1 v + c2 v^2) = c2 ξ + c0 v + c1 v^2
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def inv(self):
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - (b * c) * XI
        t1 = (c.square()) * XI - a * b
        t2 = b.square() - a * c
        denom = a * t0 + (c * t1 + b * t2) * XI
        dinv = denom.inv()
        return Fq6(t0 * dinv, t1 * dinv, t2 * dinv)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @classmethod
    def zero(cls):
        return cls(Fq6.zero(), Fq6.zero())

    @classmethod
    def one(cls):
        return cls(Fq6.one(), Fq6.zero())

    @classmethod
    def from_fq(cls, v: int):
        return cls(Fq6(Fq2(v, 0), Fq2.zero(), Fq2.zero()), Fq6.zero())

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        # w^2 = v
        return Fq12(t0 + t1.mul_by_v(), a0 * b1 + a1 * b0)

    def square(self):
        return self * self

    def conjugate(self):
        """q^6-power Frobenius: negates the w-part."""
        return Fq12(self.c0, -self.c1)

    def inv(self):
        # (a + b w)^-1 = (a - b w) / (a^2 - b^2 v)
        t = (self.c0 * self.c0) - (self.c1 * self.c1).mul_by_v()
        tinv = t.inv()
        return Fq12(self.c0 * tinv, -(self.c1 * tinv))

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inv().pow(-e)
        acc = Fq12.one()
        base = self
        while e:
            if e & 1:
                acc = acc * base
            base = base.square()
            e >>= 1
        return acc

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1


# w and its inverse powers for the untwist ψ(x, y) = (x w^-2, y w^-3).
def _w_pow(k: int) -> Fq12:
    w = Fq12(Fq6.zero(), Fq6.one())
    return w.pow(k) if k >= 0 else w.pow(-k).inv()


_W_M2 = _w_pow(-2)
_W_M3 = _w_pow(-3)


def _embed_fq2(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2.zero(), Fq2.zero()), Fq6.zero())


class _PointFq12:
    """Affine point on E(Fq12): y^2 = x^3 + 4."""

    __slots__ = ("x", "y", "infinity")

    def __init__(self, x: Fq12, y: Fq12, infinity=False):
        self.x, self.y, self.infinity = x, y, infinity

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        return self.y.square() == self.x.square() * self.x + Fq12.from_fq(4)


def _untwist(q: G2Affine) -> _PointFq12:
    if q.infinity:
        return _PointFq12(Fq12.zero(), Fq12.zero(), True)
    x = _embed_fq2(q.x) * _W_M2
    y = _embed_fq2(q.y) * _W_M3
    pt = _PointFq12(x, y)
    assert pt.is_on_curve(), "untwist failed: wrong twist convention"
    return pt


def _embed_g1(p: G1Affine):
    return Fq12.from_fq(p.x), Fq12.from_fq(p.y)


def _miller_loop(p: G1Affine, q: G2Affine) -> Fq12:
    """f_{|x|, ψ(Q)}(P) with verticals kept (full textbook Miller function)."""
    if p.infinity or q.infinity:
        return Fq12.one()
    Q = _untwist(q)
    xp, yp = _embed_g1(p)
    num = Fq12.one()
    den = Fq12.one()
    Tx, Ty = Q.x, Q.y
    bits = bin(abs(BLS_X))[3:]  # skip leading 1
    for bit in bits:
        # tangent line at T, evaluated at P
        lam = (Tx.square() * Fq12.from_fq(3)) * (Ty * Fq12.from_fq(2)).inv()
        l_val = yp - Ty - lam * (xp - Tx)
        # T <- 2T
        x3 = lam.square() - Tx - Tx
        y3 = lam * (Tx - x3) - Ty
        Tx, Ty = x3, y3
        v_val = xp - Tx  # vertical at 2T
        num = num.square() * l_val
        den = den.square() * v_val
        if bit == "1":
            if Tx == Q.x and Ty == Q.y:
                lam = (Tx.square() * Fq12.from_fq(3)) * (Ty * Fq12.from_fq(2)).inv()
            else:
                lam = (Q.y - Ty) * (Q.x - Tx).inv()
            l_val = yp - Ty - lam * (xp - Tx)
            x3 = lam.square() - Tx - Q.x
            y3 = lam * (Tx - x3) - Ty
            Tx, Ty = x3, y3
            num = num * l_val
            den = den * (xp - Tx)
    f = num * den.inv()
    # BLS parameter x is negative: e = f_{-|x|} = 1/f; the final exponentiation
    # maps conjugate -> inverse inside the cyclotomic subgroup, so conjugating
    # here gives the standard ate value.  (Any fixed convention is consistent
    # between our prover and verifier.)
    return f.conjugate()


@functools.lru_cache(maxsize=1)
def _hard_exponent() -> int:
    q = P
    assert (q**4 - q**2 + 1) % FR.modulus == 0
    return (q**4 - q**2 + 1) // FR.modulus


def _final_exponentiation(f: Fq12) -> Fq12:
    # easy part: f^((q^6 - 1)(q^2 + 1))
    f = f.conjugate() * f.inv()  # f^(q^6 - 1)
    f = f.pow(P**2) * f  # f^(q^2 + 1)
    # hard part
    return f.pow(_hard_exponent())


def pairing(p: G1Affine, q: G2Affine) -> Fq12:
    """Full ate pairing e(P, Q)."""
    return _final_exponentiation(_miller_loop(p, q))


def _fq12_from_coeffs(coeffs) -> Fq12:
    """12 canonical Fq ints (tower order c0.c0.c0 ... c1.c2.c1) -> Fq12."""
    c = [Fq2(coeffs[i], coeffs[i + 1]) for i in range(0, 12, 2)]
    return Fq12(Fq6(c[0], c[1], c[2]), Fq6(c[3], c[4], c[5]))


def pairing_product(pairs) -> Fq12:
    """prod_i e(P_i, Q_i) with a single shared final exponentiation.

    Dispatches to the native C++ implementation (csrc/pairing.cpp) when a
    toolchain is available — ~10-30x faster, same tower and Miller-loop
    conventions — and falls back to the python path otherwise."""
    pairs = list(pairs)
    from .native_pairing import native_pairing_product

    coeffs = native_pairing_product(pairs)
    if coeffs is not None:
        return _fq12_from_coeffs(coeffs)
    f = Fq12.one()
    for p, q in pairs:
        f = f * _miller_loop(p, q)
    return _final_exponentiation(f)


def pairings_equal(p1: G1Affine, q1: G2Affine, p2: G1Affine, q2: G2Affine) -> bool:
    """e(P1, Q1) == e(P2, Q2), via one multi-pairing."""
    return pairing_product([(p1, q1), (-p2, q2)]) == Fq12.one()
