"""BLS12-381 constants and G1 arithmetic on Python ints, for the reference.

y^2 = x^3 + 4 over Fq; r is the order of G1 and the modulus of Fr.  The
constants follow from the curve's parameter x = -0xd201000000010000 and are
checked against their published hex forms.  Points are affine (x, y)
tuples, None for the identity; a scalar multiplication runs in Jacobian
coordinates.
"""
from __future__ import annotations

BLS_X = -0xD201000000010000
R = BLS_X**4 - BLS_X**2 + 1
Q = ((BLS_X - 1) ** 2 * R) // 3 + BLS_X
assert R == 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
assert Q == 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# the standard generator of G1 (IETF pairing-friendly curves draft, section 4.2.1)
G1 = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
assert (G1[1] ** 2 - G1[0] ** 3 - 4) % Q == 0

# Fr: multiplicative generator 7, 2^32 | r - 1 (arkworks' FrConfig)
FR_GENERATOR = 7
FR_TWO_ADICITY = 32


def root_of_unity(n: int) -> int:
    """The generator of Fr's multiplicative subgroup of order n (a power of
    two): 7^((r - 1) / 2^32) squared down to order n."""
    log_n = n.bit_length() - 1
    assert 1 << log_n == n and log_n <= FR_TWO_ADICITY
    root = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)
    return pow(root, 1 << (FR_TWO_ADICITY - log_n), R)


def _double(P):
    X, Y, Z = P
    if Z == 0:
        return P
    A = X * X % Q
    B = Y * Y % Q
    C = B * B % Q
    D = 2 * ((X + B) ** 2 - A - C) % Q
    E = 3 * A % Q
    X3 = (E * E - 2 * D) % Q
    return X3, (E * (D - X3) - 8 * C) % Q, 2 * Y * Z % Q


def _add(P, Qp):
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Qp
    if Z1 == 0:
        return Qp
    if Z2 == 0:
        return P
    Z1Z1, Z2Z2 = Z1 * Z1 % Q, Z2 * Z2 % Q
    U1, U2 = X1 * Z2Z2 % Q, X2 * Z1Z1 % Q
    S1, S2 = Y1 * Z2 * Z2Z2 % Q, Y2 * Z1 * Z1Z1 % Q
    if U1 == U2:
        return _double(P) if S1 == S2 else (1, 1, 0)
    H, rr = (U2 - U1) % Q, (S2 - S1) % Q
    HH = H * H % Q
    HHH = H * HH % Q
    V = U1 * HH % Q
    X3 = (rr * rr - HHH - 2 * V) % Q
    return X3, (rr * (V - X3) - S1 * HHH) % Q, Z1 * Z2 * H % Q


def _affine(P):
    X, Y, Z = P
    if Z == 0:
        return None
    zi = pow(Z, -1, Q)
    zi2 = zi * zi % Q
    return X * zi2 % Q, Y * zi2 * zi % Q


def mul(k: int, P=G1):
    """[k] P for an affine P (None: the identity)."""
    k %= R
    if P is None or k == 0:
        return None
    acc, base = (1, 1, 0), (P[0], P[1], 1)
    for bit in bin(k)[2:]:
        acc = _double(acc)
        if bit == "1":
            acc = _add(acc, base)
    return _affine(acc)

