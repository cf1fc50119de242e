"""Structured reference string for KZG (counterpart of zktpu/kzg/srs.py).

`new_from_secret` builds [G, sG, ..., s^(size+2) G] (size + 3 points, as in
the reference's kzg/src/srs.rs:51) with the windowed fixed-base batch multiply
on the chosen device (by default the current CUDA device), plus G2 and s G2
on the host; `new` does the same for a random secret.  `g1_affine` gives the
points in affine form for the mixed-add MSM.
"""
from __future__ import annotations

import secrets

from ..curves.host_curve import G1Affine, G2Affine
from ..fields.host import FR
from ..curves import g1
from ..fields.fp import field


class Srs:
    def __init__(self, g1_proj, g2: G2Affine, g2s: G2Affine, size: int, secret: int | None = None):
        # g1_proj: projective (X, Y, Z), each (size, 12), on the SRS's device
        self.g1_proj = g1_proj
        self._g2 = g2
        self._g2s = g2s
        self.size = size
        self._secret = secret  # kept only when built from a known secret
        self._g1_host: list[G1Affine] | None = None
        self._g1_first: G1Affine | None = None
        self._g1_aff = None  # affine (Xa, Ya) planes for msm_affine, made on first use

    @property
    def device(self):
        return self.g1_proj[0].device

    @classmethod
    def new(cls, circuit_size: int, device=None) -> "Srs":
        """An SRS from a random secret (OS entropy), as zktpu's Srs.new."""
        return cls.new_from_secret(secrets.randbelow(FR.modulus), circuit_size, device)

    @classmethod
    def new_from_secret(cls, secret: int, circuit_size: int, device=None) -> "Srs":
        n = circuit_size + 3
        if n <= 4096:  # host power chain
            powers, cur = [], 1
            for _ in range(n):
                powers.append(cur)
                cur = FR.mul(cur, secret)
            sc = g1.scalars_to_u32(powers, device)
        else:  # log-depth cumulative product of the powers on the device
            frd = field(FR, device)
            sc = frd.to_u32_limbs(frd.powers(secret, n))
        pts = g1.fixed_base_mul_u32(G1Affine.generator(), sc)
        g2 = G2Affine.generator()
        return cls(pts, g2, g2.mul(secret), n, secret)

    def g1_affine(self):
        """Affine (Xa, Ya) planes of the G1 powers on the SRS's device (cached):
        one batch inversion (g1.proj_to_affine_dev); msm_affine's input."""
        if self._g1_aff is None:
            self._g1_aff = g1.proj_to_affine_dev(self.g1_proj)
        return self._g1_aff

    def g1_points_host(self) -> list[G1Affine]:
        if self._g1_host is None:
            self._g1_host = g1.proj_to_affine_host(self.g1_proj)
        return self._g1_host

    def g1_generator_host(self) -> G1Affine:
        """The first SRS point ([1]G) without decoding the whole table."""
        if self._g1_host is not None:
            return self._g1_host[0]
        if self._g1_first is None:
            self._g1_first = g1.proj_to_affine_host(tuple(a[:1] for a in self.g1_proj))[0]
        return self._g1_first

    def g2(self) -> G2Affine:
        return self._g2

    def g2s(self) -> G2Affine:
        return self._g2s

    def __eq__(self, other) -> bool:
        """The same size, G2 points and G1 points (compared on the host)."""
        return (
            isinstance(other, Srs)
            and self.size == other.size
            and self.g2() == other.g2()
            and self.g2s() == other.g2s()
            and self.g1_points_host() == other.g1_points_host()
        )
