"""KZG polynomial commitments (counterpart of zktpu/kzg/scheme.py).

commit / commit_many / commit_para / open / verify.  Commitments of large
polynomials run the tensor Pippenger MSM against the SRS points on the SRS's
device; small ones take the host tier.  Verification is the host
pairing check.
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

    def commit_para(self, para: int) -> KzgCommitment:
        return KzgCommitment(self.srs.g1_generator_host().mul(para))

    def open(self, polynomial: Poly, z: int) -> KzgOpening:
        quotient, evaluation = polynomial.divide_by_linear(z)
        return KzgOpening(self.commit(quotient).point, evaluation)

    def verify(self, commitment: KzgCommitment, opening: KzgOpening, z: int) -> bool:
        """e([Q], [s]_2 - z [1]_2) == e([P] - y [1]_1, [1]_2)."""
        a = self.srs.g2s() - self.srs.g2().mul(z)
        b = commitment.point - G1Affine.generator().mul(opening.evaluation)
        return pairing_product([(opening.point, a), (-b, self.srs.g2())]) == Fq12.one()
