"""KZG polynomial commitments (counterpart of zktpu/kzg/scheme.py).

commit / commit_many / commit_vector / commit_para / open / open_vector /
verify / aggregate_commitments / batch_verify.  Commitments of large
polynomials run the tensor Pippenger MSM against the SRS points on the SRS's
device; small ones take the host tier.  Verification, aggregation and the
batch check are host curve work and pairings.
"""
from __future__ import annotations

import torch

from ..curves.host_curve import G1Affine
from ..curves.pairing import Fq12, pairing_product
from ..fields.host import FR
from .. import config
from ..curves import g1 as g1mod
from ..curves.msm import msm_proj_many, pick_window
from ..fields.fp import field
from ..poly.poly import Poly
from ..transcript.chacha import StdRng
from .srs import Srs


class KzgCommitment:
    __slots__ = ("point",)

    def __init__(self, point: G1Affine):
        self.point = point

    # transcript feeding interface (x, y, infinity)
    @property
    def x(self):
        return self.point.x

    @property
    def y(self):
        return self.point.y

    @property
    def infinity(self):
        return self.point.infinity

    def __add__(self, other):
        return KzgCommitment(self.point + other.point)

    def __sub__(self, other):
        return KzgCommitment(self.point - other.point)

    def mul(self, k: int) -> "KzgCommitment":
        return KzgCommitment(self.point.mul(k))

    def __eq__(self, other):
        return isinstance(other, KzgCommitment) and self.point == other.point

    def __repr__(self):
        return f"KzgCommitment({'inf' if self.point.infinity else hex(self.point.x)[:14]}...)"


class KzgOpening:
    __slots__ = ("point", "evaluation")

    def __init__(self, point: G1Affine, evaluation: int):
        self.point = point
        self.evaluation = evaluation


class KzgScheme:
    def __init__(self, srs: Srs):
        self.srs = srs

    def _host_tier(self, n: int) -> bool:
        return n <= config.HOST_MSM_MAX and self.srs.size <= config.HOST_MSM_SRS_MAX

    def commit(self, polynomial: Poly) -> KzgCommitment:
        return self.commit_coeffs(polynomial.coeffs)

    def commit_coeffs(self, coeffs: torch.Tensor) -> KzgCommitment:
        n = coeffs.shape[0]
        assert self.srs.size > max(n - 1, 0), "polynomial degree exceeds SRS"
        if n == 0:
            return KzgCommitment(G1Affine.identity())
        if self._host_tier(n):  # tiny MSMs are dispatch-bound: host double-and-add
            frd = field(FR, coeffs.device)
            acc = G1Affine.identity()
            for s, pt in zip(frd.decode_ints(coeffs), self.srs.g1_points_host()):
                if s:
                    acc = acc + pt.mul(s)
            return KzgCommitment(acc)
        return self._msm_many(coeffs[None], n)[0]

    def _msm_many(self, stacked: torch.Tensor, n: int) -> list[KzgCommitment]:
        """(K, n, 8) Montgomery coefficients -> K commitments, one batched MSM."""
        frd = field(FR, stacked.device)
        sc = frd.to_u32_limbs(stacked.to(self.srs.device))
        X, Y, Z = (a[:n] for a in self.srs.g1_proj)
        R = msm_proj_many(sc, X, Y, Z, c=pick_window(n))
        return [KzgCommitment(pt) for pt in g1mod.proj_to_affine_host(R)]

    def commit_many(self, polys: list[Poly]) -> list[KzgCommitment]:
        """Commit K same-SRS polynomials with one batched MSM; identical to
        [commit(p) for p in polys]."""
        if not polys:
            return []
        n = max(len(p) for p in polys)
        if len(polys) == 1 or self._host_tier(n):
            return [self.commit(p) for p in polys]
        assert self.srs.size > n - 1, "polynomial degree exceeds SRS"
        stacked = torch.stack([p._padded(n) for p in polys])  # (K, n, 8)
        return self._msm_many(stacked, n)

    def commit_vector(self, coeffs: list[int]) -> KzgCommitment:
        """Commit to the polynomial with these coefficients (trailing zeros trimmed)."""
        return self.commit(Poly.from_ints(FR, coeffs, self.srs.device))

    def commit_para(self, para: int) -> KzgCommitment:
        return KzgCommitment(self.srs.g1_generator_host().mul(para))

    def open(self, polynomial: Poly, z: int) -> KzgOpening:
        quotient, evaluation = polynomial.divide_by_linear(z)
        return KzgOpening(self.commit(quotient).point, evaluation)

    def open_vector(self, coeffs: list[int], z: int) -> KzgOpening:
        return self.open(Poly.from_ints(FR, coeffs, self.srs.device), z)

    def verify(self, commitment: KzgCommitment, opening: KzgOpening, z: int) -> bool:
        """e([Q], [s]_2 - z [1]_2) == e([P] - y [1]_1, [1]_2)."""
        a = self.srs.g2s() - self.srs.g2().mul(z)
        b = commitment.point - G1Affine.generator().mul(opening.evaluation)
        return pairing_product([(opening.point, a), (-b, self.srs.g2())]) == Fq12.one()

    @staticmethod
    def aggregate_commitments(commitments, challenge: int) -> KzgCommitment:
        """sum_i challenge^i C_i."""
        acc = G1Affine.identity()
        pw = 1
        for c in commitments:
            acc = acc + c.point.mul(pw)
            pw = FR.mul(pw, challenge)
        return KzgCommitment(acc)

    def batch_verify(self, commitments, points, openings, rng: StdRng) -> bool:
        """Random-linear-combination check of several openings with two
        pairings; one rng.gen_u128() draw per opening, as zktpu's."""
        assert len(commitments) == len(points) == len(openings)
        g = G1Affine.generator()
        e1 = G1Affine.identity()
        e2 = G1Affine.identity()
        for cm, z, op in zip(commitments, points, openings):
            w, s = op.point, op.evaluation
            r_prime = rng.gen_u128() % FR.modulus
            e1 = e1 + (cm.point - g.mul(s) + w.mul(z)).mul(r_prime)
            e2 = e2 + w.mul(r_prime)
        return pairing_product([(e1, self.srs.g2()), (-e2, self.srs.g2s())]) == Fq12.one()
