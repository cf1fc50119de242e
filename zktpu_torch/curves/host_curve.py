"""Host-side (python-int) BLS12-381 curve arithmetic.

The port's own copy of zktpu/curves/host_curve.py.

Scalar-sized curve work lives here: SRS G2 points, commitment finalization,
transcript feeding, pairing inputs.  Bulk MSM runs on device
(zktpu_torch/curves/g1.py, zktpu_torch/curves/msm.py).

Replaces the arkworks `ark-ec` usage of the reference
(kzg/src/srs.rs, kzg/src/scheme.rs:84-96,248-290).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.host import FQ, FR, G1_GEN_X, G1_GEN_Y, G2_GEN_X_C0, G2_GEN_X_C1, G2_GEN_Y_C0, G2_GEN_Y_C1

P = FQ.modulus
R_ORDER = FR.modulus


@dataclass(frozen=True)
class G1Affine:
    x: int
    y: int
    infinity: bool = False

    @classmethod
    def identity(cls) -> "G1Affine":
        return cls(0, 0, True)

    @classmethod
    def generator(cls) -> "G1Affine":
        return cls(G1_GEN_X, G1_GEN_Y)

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        return (self.y * self.y - (self.x**3 + 4)) % P == 0

    def __neg__(self) -> "G1Affine":
        if self.infinity:
            return self
        return G1Affine(self.x, (-self.y) % P)

    def __add__(self, other: "G1Affine") -> "G1Affine":
        return _affine_add(self, other)

    def __sub__(self, other: "G1Affine") -> "G1Affine":
        return _affine_add(self, -other)

    def mul(self, k: int) -> "G1Affine":
        return _affine_scalar_mul(self, k % R_ORDER)

    def __eq__(self, other) -> bool:
        if self.infinity or other.infinity:
            return self.infinity == other.infinity
        return self.x == other.x and self.y == other.y


def _affine_add(a: G1Affine, b: G1Affine) -> G1Affine:
    if a.infinity:
        return b
    if b.infinity:
        return a
    if a.x == b.x:
        if (a.y + b.y) % P == 0:
            return G1Affine.identity()
        # doubling
        lam = (3 * a.x * a.x) * pow(2 * a.y, -1, P) % P
    else:
        lam = (b.y - a.y) * pow(b.x - a.x, -1, P) % P
    x3 = (lam * lam - a.x - b.x) % P
    y3 = (lam * (a.x - x3) - a.y) % P
    return G1Affine(x3, y3)


def _affine_scalar_mul(pt: G1Affine, k: int) -> G1Affine:
    acc = G1Affine.identity()
    add = pt
    while k:
        if k & 1:
            acc = acc + add
        add = add + add
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# Fq2 and G2 (affine, python ints) — needed for the SRS (g2, g2*s) and pairing.
# ---------------------------------------------------------------------------


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @classmethod
    def zero(cls):
        return cls(0, 0)

    @classmethod
    def one(cls):
        return cls(1, 0)

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        # (a0 + a1 u)(b0 + b1 u), u^2 = -1
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fq2(t0 - t1, t2 - t0 - t1)

    def square(self):
        return self * self

    def inv(self):
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        ninv = pow(norm, -1, P)
        return Fq2(self.c0 * ninv, -self.c1 * ninv)

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"


XI = Fq2(1, 1)  # the twist constant ξ = 1 + u; E'(Fq2): y^2 = x^3 + 4ξ
B2 = XI * 4


@dataclass(frozen=True)
class G2Affine:
    x: Fq2
    y: Fq2
    infinity: bool = False

    @classmethod
    def identity(cls) -> "G2Affine":
        return cls(Fq2.zero(), Fq2.zero(), True)

    @classmethod
    def generator(cls) -> "G2Affine":
        return cls(Fq2(G2_GEN_X_C0, G2_GEN_X_C1), Fq2(G2_GEN_Y_C0, G2_GEN_Y_C1))

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        lhs = self.y.square()
        rhs = self.x.square() * self.x + B2
        return lhs == rhs

    def __neg__(self) -> "G2Affine":
        if self.infinity:
            return self
        return G2Affine(self.x, -self.y)

    def __add__(self, other: "G2Affine") -> "G2Affine":
        if self.infinity:
            return other
        if other.infinity:
            return self
        if self.x == other.x:
            if (self.y + other.y).is_zero():
                return G2Affine.identity()
            lam = (self.x.square() * 3) * (self.y * 2).inv()
        else:
            lam = (other.y - self.y) * (other.x - self.x).inv()
        x3 = lam.square() - self.x - other.x
        y3 = lam * (self.x - x3) - self.y
        return G2Affine(x3, y3)

    def __sub__(self, other: "G2Affine") -> "G2Affine":
        return self + (-other)

    def mul(self, k: int) -> "G2Affine":
        k %= R_ORDER
        acc = G2Affine.identity()
        add = self
        while k:
            if k & 1:
                acc = acc + add
            add = add + add
            k >>= 1
        return acc

    def __eq__(self, other) -> bool:
        if self.infinity or other.infinity:
            return self.infinity == other.infinity
        return self.x == other.x and self.y == other.y
