"""Dense univariate polynomials over limb tensors (counterpart of
zktpu/poly/poly.py).

arkworks DensePolynomial semantics: coefficients are trimmed of trailing
zeros on construction (the zero polynomial has none) and degree() = len - 1
(0 for the zero polynomial).  Products use the NTT; division by X^n - 1 is a
strided suffix sum, q_i = sum_{j >= 1} p_{i + jn}; division by (X - z) is a
reverse cumulative sum with powers of z.  Small operands take the host tier.
"""
from __future__ import annotations

import torch

from ..fields.host import FieldSpec
from .. import config
from ..fields.fp import field
from .domain import Radix2Domain, get_domain


class Poly:
    """coeffs: (len, L) int32 Montgomery limbs on one device, trimmed."""

    __slots__ = ("spec", "df", "coeffs")

    def __init__(self, spec: FieldSpec, coeffs: torch.Tensor, trim: bool = True):
        self.spec = spec
        self.df = field(spec, coeffs.device)
        if trim and coeffs.shape[0]:
            coeffs = self._trim(coeffs)
        self.coeffs = coeffs

    # -- construction --

    @classmethod
    def from_ints(cls, spec: FieldSpec, values, device=None) -> "Poly":
        vals = [int(v) % spec.modulus for v in values]
        if not vals:
            return cls.zero(spec, device)
        return cls(spec, field(spec, device).encode_ints(vals))

    @classmethod
    def zero(cls, spec: FieldSpec, device=None) -> "Poly":
        df = field(spec, device)
        return cls(spec, torch.zeros((0, df.num_limbs), dtype=torch.int32, device=df.device), trim=False)

    @classmethod
    def constant(cls, spec: FieldSpec, value: int, device=None) -> "Poly":
        return cls.from_ints(spec, [value], device)

    @staticmethod
    def _trim(coeffs: torch.Tensor) -> torch.Tensor:
        nz = torch.nonzero((coeffs != 0).any(-1))
        if nz.numel() == 0:
            return coeffs[:0]
        return coeffs[: int(nz[-1]) + 1]

    # -- basic properties --

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    def __len__(self) -> int:
        return int(self.coeffs.shape[0])

    @property
    def degree(self) -> int:
        """arkworks degree(): 0 for the zero polynomial (by convention)."""
        return max(len(self) - 1, 0)

    def is_zero(self) -> bool:
        return len(self) == 0

    def to_ints(self) -> list[int]:
        return self.df.decode_ints(self.coeffs) if len(self) else []

    def __eq__(self, other) -> bool:
        if not isinstance(other, Poly) or len(self) != len(other):
            return False
        return bool(torch.equal(self.coeffs, other.coeffs.to(self.device)))

    # -- arithmetic --

    def _padded(self, n: int) -> torch.Tensor:
        if len(self) == n:
            return self.coeffs
        pad = torch.zeros((n - len(self), self.df.num_limbs), dtype=torch.int32, device=self.device)
        return torch.cat([self.coeffs, pad])

    def __add__(self, other: "Poly") -> "Poly":
        n = max(len(self), len(other))
        if n == 0:
            return Poly.zero(self.spec, self.device)
        return Poly(self.spec, self.df.add(self._padded(n), other._padded(n)))

    def __sub__(self, other: "Poly") -> "Poly":
        n = max(len(self), len(other))
        if n == 0:
            return Poly.zero(self.spec, self.device)
        return Poly(self.spec, self.df.sub(self._padded(n), other._padded(n)))

    def __neg__(self) -> "Poly":
        if len(self) == 0:
            return self
        return Poly(self.spec, self.df.neg(self.coeffs), trim=False)

    def scale(self, k: int) -> "Poly":
        """Multiply by a scalar (canonical int)."""
        k = k % self.spec.modulus
        if len(self) == 0 or k == 0:
            return Poly.zero(self.spec, self.device)
        return Poly(self.spec, self.df.mont_mul(self.coeffs, self.df.encode_int(k)), trim=False)

    def __mul__(self, other: "Poly") -> "Poly":
        if len(self) == 0 or len(other) == 0:
            return Poly.zero(self.spec, self.device)
        out_len = len(self) + len(other) - 1
        if out_len <= config.HOST_POLY_MAX:  # small: host schoolbook
            a, b = self.to_ints(), other.to_ints()
            p = self.spec.modulus
            out = [0] * out_len
            for i, ai in enumerate(a):
                for j, bj in enumerate(b):
                    out[i + j] = (out[i + j] + ai * bj) % p
            return Poly.from_ints(self.spec, out, self.device)
        dom = get_domain(self.spec, out_len, self.device)
        ea = dom.fft(self._padded(dom.size))
        eb = dom.fft(other._padded(dom.size))
        prod = dom.ifft(self.df.mont_mul(ea, eb))
        return Poly(self.spec, prod[:out_len])

    def shift(self, k: int) -> "Poly":
        """Multiply by X^k."""
        if len(self) == 0 or k == 0:
            return self
        pad = torch.zeros((k, self.df.num_limbs), dtype=torch.int32, device=self.device)
        return Poly(self.spec, torch.cat([pad, self.coeffs]), trim=False)

    def mul_by_vanishing(self, n: int) -> "Poly":
        """p(X) * (X^n - 1)."""
        return self.shift(n) - self

    def divide_by_vanishing(self, n: int) -> tuple["Poly", "Poly"]:
        """Divide by X^n - 1; returns (quotient, remainder)."""
        L = len(self)
        if L <= n:
            return Poly.zero(self.spec, self.device), self
        if L <= config.HOST_POLY_MAX:  # small: host ints
            p = self.spec.modulus
            c = self.to_ints()
            q = [0] * (L - n)
            for i in range(L - n - 1, -1, -1):
                q[i] = (c[i + n] + (q[i + n] if i + n < L - n else 0)) % p
            r = [(c[i] + (q[i] if i < L - n else 0)) % p for i in range(n)]
            return Poly.from_ints(self.spec, q, self.device), Poly.from_ints(self.spec, r, self.device)
        qlen = L - n
        nblocks = -(-qlen // n)
        high = Poly(self.spec, self.coeffs[n:], trim=False)._padded(nblocks * n)
        blocks = high.reshape(nblocks, n, -1)
        # suffix block sums: q_block[j] = sum_{k >= j} p_block[k]
        acc = blocks[-1]
        out = [acc]
        for j in range(nblocks - 2, -1, -1):
            acc = self.df.add(acc, blocks[j])
            out.append(acc)
        q = torch.stack(out[::-1]).reshape(nblocks * n, -1)[:qlen]
        r = self.df.add(self.coeffs[:n], Poly(self.spec, q, trim=False)._padded(max(n, qlen))[:n])
        return Poly(self.spec, q), Poly(self.spec, r)

    def divide_by_linear(self, z: int) -> tuple["Poly", int]:
        """Divide by (X - z); returns (quotient, remainder = p(z))."""
        L = len(self)
        if L == 0:
            return Poly.zero(self.spec, self.device), 0
        if L == 1:
            return Poly.zero(self.spec, self.device), self.to_ints()[0]
        z = z % self.spec.modulus
        if z == 0:
            return Poly(self.spec, self.coeffs[1:]), self.df.decode_int(self.coeffs[0])
        if L <= config.HOST_POLY_MAX:  # small: host synthetic (Ruffini) division
            p = self.spec.modulus
            c = self.to_ints()
            q = [0] * (L - 1)
            acc = c[L - 1]
            for i in range(L - 2, 0, -1):
                q[i] = acc
                acc = (c[i] + z * acc) % p
            q[0] = acc
            return Poly.from_ints(self.spec, q, self.device), (c[0] + z * acc) % p
        spec, df = self.spec, self.df
        # q_i = sum_{j>i} c_j z^{j-i-1} = z^{-(i+1)} S_i,  S_i = sum_{j>i} c_j z^j
        cz = df.mont_mul(self.coeffs, df.powers(z, L))
        incl = df.cumsum(cz, axis=0, reverse=True)
        S = torch.cat([incl[1:], df.zero[None]], dim=0)
        zinv = spec.inv(z)
        zinv_pows = df.mont_mul(df.powers(zinv, L), df.encode_int(zinv))  # zinv^(i+1)
        q = df.mont_mul(S, zinv_pows)[: L - 1]
        return Poly(self.spec, q), df.decode_int(incl[0])  # p(z) = sum_j c_j z^j

    def evaluate(self, z: int) -> int:
        z = z % self.spec.modulus
        L = len(self)
        if L == 0:
            return 0
        if L <= 256:  # host Horner
            acc = 0
            for c in reversed(self.to_ints()):
                acc = (acc * z + c) % self.spec.modulus
            return acc
        df = self.df
        return df.decode_int(df.sum(df.mont_mul(self.coeffs, df.powers(z, L)), axis=0))

    def __repr__(self) -> str:
        return f"Poly({self.spec.name}, deg={'-inf' if self.is_zero() else self.degree}, len={len(self)}, {self.device})"


def poly_from_evals(dom: Radix2Domain, evals: torch.Tensor) -> Poly:
    """arkworks Evaluations::from_vec_and_domain(...).interpolate()."""
    return Poly(dom.spec, dom.ifft(evals))


def evaluate_many(polys: list[Poly], z: int) -> list[int]:
    """[p(z) for p in polys] with one shared power table and one tensor pass."""
    if not polys:
        return []
    L = max(len(p) for p in polys)
    if L == 0:
        return [0] * len(polys)
    if L <= 256:  # host Horner
        return [p.evaluate(z) for p in polys]
    df = polys[0].df
    stacked = torch.stack([p._padded(L) for p in polys])  # (K, L, limbs)
    terms = df.mont_mul(stacked, df.powers(z, L))
    return df.decode_ints(df.sum(terms, axis=1))
