"""Host-side (Python-int) prime field arithmetic and BLS12-381 constants.

The port's own copy of zktpu/fields/host.py (same constants, same code).

This module is the *scalar* (O(1) data) layer of the framework: transcripts,
challenge derivation, pairings, SRS G2 points and conversions all run here.
Bulk data-parallel arithmetic lives in :mod:`zktpu_torch.fields.fp` (limb tensors).

Reference parity notes (citations into the Rust reference):
  - The reference uses arkworks ``ark-bls12-381`` (kzg/src/types.rs:6-10) and an
    in-repo Goldilocks definition (fri/src/fields/goldilocks.rs:4-8,
    modulus = 18446744069414584321, generator = 7).
  - Montgomery radices match arkworks 0.4 64-bit limb layouts: R = 2^256 for Fr,
    R = 2^384 for Fq, R = 2^64 for Goldilocks.  This matters for bit-exact
    replication of ``Fp::rand`` (see zktpu/transcript/ark_rand.py).

All BLS12-381 constants below are *derived* from the BLS parameter
x = -0xd201000000010000 and checked in tests (tests/test_fields.py,
tests/test_curves_host.py), not copied from the reference.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# BLS12-381 parameter derivation.
#
#   x   = -0xd201000000010000                     (the BLS parameter)
#   r   = x^4 - x^2 + 1                           (scalar field modulus, "Fr")
#   q   = ((x - 1)^2 * (x^4 - x^2 + 1)) // 3 + x  (base field modulus, "Fq")
# ---------------------------------------------------------------------------
BLS_X = -0xD201000000010000

FR_MODULUS = BLS_X**4 - BLS_X**2 + 1
FQ_MODULUS = ((BLS_X - 1) ** 2 * (BLS_X**4 - BLS_X**2 + 1)) // 3 + BLS_X

# Well-known hex forms, asserted so a typo in the derivation cannot slip by.
assert FR_MODULUS == 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
assert (
    FQ_MODULUS
    == 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
)

GOLDILOCKS_MODULUS = 2**64 - 2**32 + 1  # fri/src/fields/goldilocks.rs:6
assert GOLDILOCKS_MODULUS == 18446744069414584321

# BLS12-381 G1/G2 generators (IETF pairing-friendly-curves spec / arkworks
# G1_GENERATOR_X etc.).  Verified on-curve and in-subgroup by tests.
G1_GEN_X = 3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507
G1_GEN_Y = 1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569

G2_GEN_X_C0 = 352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160
G2_GEN_X_C1 = 3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758
G2_GEN_Y_C0 = 1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905
G2_GEN_Y_C1 = 927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582

G1_COFACTOR = ((BLS_X - 1) ** 2) // 3
assert G1_COFACTOR == 0x396C8C005555E1568C00AAAB0000AAAB


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field used across host & device layers."""

    name: str
    modulus: int
    # Number of 16-bit digits in the device representation.
    num_digits: int
    # Multiplicative generator of the full group (arkworks GENERATOR).
    generator: int
    # Largest s with 2^s | p-1.
    two_adicity: int

    @property
    def mont_r(self) -> int:
        """Montgomery radix.  16 * num_digits bits, matches arkworks layout."""
        return 1 << (16 * self.num_digits)

    @property
    def mont_r2(self) -> int:
        return self.mont_r**2 % self.modulus

    @property
    def mont_pinv_digit(self) -> int:
        """-p^{-1} mod 2^16 (digit-wise Montgomery constant)."""
        return (-pow(self.modulus, -1, 1 << 16)) % (1 << 16)

    @property
    def mont_pinv_full(self) -> int:
        """-p^{-1} mod R (full-width Montgomery constant)."""
        return (-pow(self.modulus, -1, self.mont_r)) % self.mont_r

    @property
    def num_bits(self) -> int:
        return self.modulus.bit_length()

    @functools.cached_property
    def two_adic_root(self) -> int:
        """arkworks TWO_ADIC_ROOT_OF_UNITY = generator^((p-1) / 2^two_adicity)."""
        return pow(self.generator, (self.modulus - 1) >> self.two_adicity, self.modulus)

    # -- scalar helpers (Python ints, canonical representation) --
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.modulus

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.modulus

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.modulus

    def neg(self, a: int) -> int:
        return (-a) % self.modulus

    def inv(self, a: int) -> int:
        if a % self.modulus == 0:
            raise ZeroDivisionError(f"inverse of 0 in {self.name}")
        return pow(a, -1, self.modulus)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.modulus)

    def root_of_unity(self, n: int) -> int:
        """Domain generator for a radix-2 domain of size n (arkworks get_root_of_unity)."""
        assert n & (n - 1) == 0, "domain size must be a power of two"
        log_n = n.bit_length() - 1
        assert log_n <= self.two_adicity, f"no 2^{log_n} root of unity in {self.name}"
        return pow(self.two_adic_root, 1 << (self.two_adicity - log_n), self.modulus)

    def from_le_bytes_mod_order(self, data: bytes) -> int:
        """arkworks PrimeField::from_le_bytes_mod_order semantics."""
        return int.from_bytes(data, "little") % self.modulus

    def to_mont(self, a: int) -> int:
        return (a * self.mont_r) % self.modulus

    def from_mont(self, a: int) -> int:
        return (a * pow(self.mont_r, -1, self.modulus)) % self.modulus


# arkworks ark-bls12-381 FrConfig: GENERATOR = 7, TWO_ADICITY = 32.
FR = FieldSpec("bls12_381_fr", FR_MODULUS, num_digits=16, generator=7, two_adicity=32)
# arkworks FqConfig: GENERATOR = 2, TWO_ADICITY = 1.
FQ = FieldSpec("bls12_381_fq", FQ_MODULUS, num_digits=24, generator=2, two_adicity=1)
# fri/src/fields/goldilocks.rs: modulus = 2^64 - 2^32 + 1, generator = 7.
GOLDILOCKS = FieldSpec(
    "goldilocks", GOLDILOCKS_MODULUS, num_digits=4, generator=7, two_adicity=32
)

_SPECS = {s.name: s for s in (FR, FQ, GOLDILOCKS)}


def get_field(name: str) -> FieldSpec:
    return _SPECS[name]
