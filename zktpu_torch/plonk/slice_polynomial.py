"""Quotient-polynomial slicing (counterpart of zktpu/plonk/slice_polynomial.py).

t(X) is split into 3 chunks of ceil(len / 3) coefficients (at least 1) for
degree-bounded commitment; `compact` rejoins them at a point with
X^((degree + 1) i) weights.  Each chunk is trimmed like any Poly, which
decides the committed lengths.
"""
from __future__ import annotations

from ..fields.host import FR
from ..poly.poly import Poly


class SlicePoly:
    def __init__(self, polynomial: Poly):
        device = polynomial.device
        length = len(polynomial)
        tmp = max(-(-length // 3), 1)
        self.slices = [Poly.zero(FR, device) for _ in range(3)]
        for i in range(3):
            chunk = polynomial.coeffs[i * tmp : (i + 1) * tmp]
            if chunk.shape[0]:
                self.slices[i] = Poly(FR, chunk)
        self.degree = tmp - 1
        self.device = device

    def get_degree(self) -> int:
        return self.degree

    def commit(self, scheme):
        return scheme.commit_many(self.slices)

    def compact(self, point: int) -> Poly:
        acc = Poly.zero(FR, self.device)
        for index, s in enumerate(self.slices):
            acc = acc + s.scale(FR.pow(point, (self.degree + 1) * index))
        return acc
