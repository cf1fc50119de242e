"""KZG commit and open by the SRS's secret, for the reference.

With the SRS [s^i] G, the commitment of p is [p(s)] G, and the opening of p
at z is the evaluation p(z) with the witness [q(s)] G, q = (p - p(z)) / (X - z),
so q(s) = (p(s) - p(z)) / (s - z).  p(s) and p(z) are dot products of the
coefficients with the powers of s and of z (./field.py).
"""
from __future__ import annotations

import torch

from . import curve
from .curve import R
from .field import PlainField


class KzgReference:
    def __init__(self, secret: int, length: int, device, scalar_bits: int = 256):
        """scalar_bits below 256 commits the coefficients cut to their low
        scalar_bits bits (a control that drops precision)."""
        self.s = secret % R
        self.F = PlainField(R, device)
        self.scalar_bits = scalar_bits
        self.s_pows = self.F.powers(self.s, length)
        self._at_s: dict[int, int] = {}

    def poly(self, key: int, words: torch.Tensor) -> torch.Tensor:
        """The reference's own form of a polynomial given as (N, 8) canonical
        32-bit words, with p(s) cached under `key`."""
        F = self.F
        coeffs = F.from_words(words)
        if self.scalar_bits < 256:
            raw = F.mul(coeffs, F.from_ints_raw(1))
            raw[self.scalar_bits // 16:] = 0
            self._at_s[key] = F.dot(F.to_mont(raw), self.s_pows[:, : raw.shape[1]])
        else:
            self._at_s[key] = F.dot(coeffs, self.s_pows[:, : coeffs.shape[1]])
        return coeffs

    def commit_open(self, key: int, coeffs: torch.Tensor, z: int) -> dict:
        """{"commitment", "witness" (affine points), "evaluation"} of p at z."""
        F = self.F
        p_s = self._at_s[key]
        p_z = F.dot(coeffs, F.powers(z, coeffs.shape[1]))
        q_s = (p_s - p_z) * pow(self.s - z, -1, R) % R
        return {"commitment": curve.mul(p_s), "witness": curve.mul(q_s), "evaluation": p_z}
