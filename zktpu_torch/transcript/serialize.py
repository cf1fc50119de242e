"""Byte-exact arkworks 0.4 `serialize_uncompressed` encoders and Display forms.

The port's own copy of zktpu/transcript/serialize.py.

Used by the PLONK challenge generator (plonk/src/challenge.rs:49-58), the Nova
transcript (nova/src/transcript.rs:69-88) and Nova's hash_io
(nova/src/circuit.rs:152-168).

Encodings (ark-serialize 0.4):
  - Fp (no flags): little-endian canonical bigint, (MODULUS_BITS+7)//8 bytes.
  - Short-Weierstrass affine, uncompressed: x bytes (no flags) || y bytes with
    SWFlags OR'd into the most-significant byte.  Infinity serializes x=y=0
    with the infinity flag (bit 6).  Non-infinity points carry a y-sign flag:
    bit 7 set iff y > -y (canonical-int comparison).
"""
from __future__ import annotations

from ..fields.host import FQ, FR, FieldSpec


def fp_bytes(spec: FieldSpec, value: int) -> bytes:
    nbytes = (spec.num_bits + 7) // 8
    return (value % spec.modulus).to_bytes(nbytes, "little")


def fr_bytes(value: int) -> bytes:
    return fp_bytes(FR, value)


def fq_bytes(value: int) -> bytes:
    return fp_bytes(FQ, value)


def _sw_flags(y: int, infinity: bool, p: int) -> int:
    if infinity:
        return 1 << 6
    # YIsNegative (bit 7) iff y > -y as canonical ints
    return (1 << 7) if y > p - y else 0


def g1_uncompressed(x: int, y: int, infinity: bool) -> bytes:
    """96-byte arkworks uncompressed encoding of a BLS12-381 G1 affine point."""
    p = FQ.modulus
    if infinity:
        x, y = 0, 0
    xb = fq_bytes(x)
    yb = bytearray(fq_bytes(y))
    yb[-1] |= _sw_flags(y, infinity, p)
    return xb + bytes(yb)


def g2_uncompressed(x0: int, x1: int, y0: int, y1: int, infinity: bool) -> bytes:
    """192-byte arkworks uncompressed encoding of a G2 affine point.

    Fq2 serializes c0 then c1; the sign flag uses the Fq2 ordering
    (compare c1 first, then c0 — arkworks QuadExtField ordering).
    """
    p = FQ.modulus
    if infinity:
        x0 = x1 = y0 = y1 = 0
        flags = 1 << 6
    else:
        neg = ((p - y0) % p, (p - y1) % p)
        # arkworks Ord for QuadExtField: compare c1, tie-break on c0
        y_key = (y1, y0)
        neg_key = (neg[1], neg[0])
        flags = (1 << 7) if y_key > neg_key else 0
    out = fq_bytes(x0) + fq_bytes(x1) + fq_bytes(y0) + bytearray(fq_bytes(y1))
    out = bytearray(out)
    out[-1] |= flags
    return bytes(out)


def fp_display(spec: FieldSpec, value: int) -> str:
    """arkworks `Display for Fp`: decimal of the canonical bigint."""
    return str(value % spec.modulus)
