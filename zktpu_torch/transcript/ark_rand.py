"""Bit-exact replication of arkworks 0.4 `UniformRand for Fp`.

The port's own copy of zktpu/transcript/ark_rand.py.

`Fp::rand` (used for every challenge in the reference via
`F::rand(&mut StdRng)`) works as follows:

1. Fill N 64-bit limbs little-endian from `rng.next_u64()` (BigInt::rand).
2. Mask away the top `64*N - MODULUS_BITS` bits of the last limb.
3. Reject and retry if the resulting bigint >= modulus.
4. Interpret the accepted bigint as the **Montgomery representation**, i.e.
   the field value is `bigint * R^{-1} mod p` with R = 2^{64 N}.

Reference call sites: fri/src/fiat_shamir/transcript.rs:106-123,
plonk/src/challenge.rs:82-89, nova/src/transcript.rs:110-114, and the SRS
secret (kzg/src/srs.rs:34) / PLONK blinding (plonk/src/prover.rs:68-77).
"""
from __future__ import annotations

from ..fields.host import FieldSpec
from .chacha import StdRng


def _num_64bit_limbs(spec: FieldSpec) -> int:
    return (spec.num_bits + 63) // 64


def fp_rand(spec: FieldSpec, rng: StdRng) -> int:
    """Sample a field element exactly like arkworks; returns canonical int."""
    n = _num_64bit_limbs(spec)
    shave = 64 * n - spec.num_bits
    mask = (1 << (64 - shave)) - 1 if shave else (1 << 64) - 1
    r_total_bits = 64 * n
    # NOTE: arkworks' R is 2^{64 n}; our digit representation uses the same
    # radix (16 * num_digits == 64 * n for all shipped fields).
    assert 16 * spec.num_digits == r_total_bits
    r_inv = pow(spec.mont_r, -1, spec.modulus)
    while True:
        limbs = [rng.next_u64() for _ in range(n)]
        limbs[-1] &= mask
        value = 0
        for i in reversed(range(n)):
            value = (value << 64) | limbs[i]
        if value < spec.modulus:
            # Montgomery interpretation
            return (value * r_inv) % spec.modulus


def fp_rand_many(spec: FieldSpec, rng: StdRng, count: int) -> list[int]:
    return [fp_rand(spec, rng) for _ in range(count)]
