"""Plain PyTorch arithmetic in a prime field below 2^255, for the reference.

An element is 16 limbs of 16 bits in int64, limb-major: a vector of N
elements is a (16, N) tensor (any trailing shape broadcasts), so that every
limb step is one contiguous tensor operation.  Values are kept in Montgomery
form with R = 2^256 and always canonical (below p).  Products of two limbs
fit in 32 bits and the sums of a product's columns stay below 2^40, so int64
never overflows.  Nothing here knows of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

LIMBS = 16
BITS = 16
MASK = (1 << BITS) - 1


def _limbs_of(value: int) -> list[int]:
    return [(value >> (BITS * i)) & MASK for i in range(LIMBS)]


class PlainField:
    def __init__(self, modulus: int, device):
        assert 2 < modulus < 1 << 255 and modulus & 1
        self.p = modulus
        self.device = torch.device(device)
        self.R = 1 << (BITS * LIMBS)
        self.r_inv = pow(self.R, -1, modulus)
        self.pinv = (-pow(modulus, -1, 1 << BITS)) % (1 << BITS)
        self._P = torch.tensor(_limbs_of(modulus), dtype=torch.int64, device=self.device)
        self._rev: dict[int, torch.Tensor] = {}
        self._tw: dict[tuple[int, int], torch.Tensor] = {}

    # -- conversions --

    def from_ints(self, values) -> torch.Tensor:
        """Canonical Python ints -> (16, N) Montgomery limbs."""
        p, R = self.p, self.R
        rows = np.array([_limbs_of(int(v) % p * R % p) for v in values], dtype=np.int64).reshape(-1, LIMBS)
        return torch.from_numpy(rows.T.copy()).to(self.device)

    def const(self, value: int) -> torch.Tensor:
        """One element as (16, 1)."""
        return self.from_ints([value])

    def from_words(self, words: torch.Tensor) -> torch.Tensor:
        """(N, 8) little-endian 32-bit words (int32 bit patterns) of canonical
        values -> (16, N) Montgomery limbs."""
        w = words.to(self.device, torch.int64) & 0xFFFFFFFF
        raw = torch.stack([w & MASK, w >> BITS], dim=-1).reshape(w.shape[0], LIMBS).T.contiguous()
        return self.to_mont(raw)

    def from_small(self, values: torch.Tensor) -> torch.Tensor:
        """(N,) integers in [0, 2^16) -> (16, N) Montgomery limbs."""
        raw = torch.zeros((LIMBS, values.shape[0]), dtype=torch.int64, device=self.device)
        raw[0] = values.to(self.device, torch.int64)
        return self.to_mont(raw)

    def to_mont(self, raw: torch.Tensor) -> torch.Tensor:
        return self.mul(raw, self.from_ints_raw(self.R * self.R % self.p))

    def from_ints_raw(self, value: int) -> torch.Tensor:
        return torch.tensor(_limbs_of(value), dtype=torch.int64, device=self.device)[:, None]

    def to_ints(self, a: torch.Tensor) -> list[int]:
        """(16, N) Montgomery limbs -> canonical Python ints."""
        rows = a.reshape(LIMBS, -1).T.cpu().numpy()
        shifts = [BITS * i for i in range(LIMBS)]
        out = []
        for row in rows:
            v = 0
            for limb, sh in zip(row.tolist(), shifts):
                v |= limb << sh
            out.append(v * self.r_inv % self.p)
        return out

    def to_int(self, a: torch.Tensor) -> int:
        return self.to_ints(a.reshape(LIMBS, 1))[0]

    # -- arithmetic --

    def _shaped(self, v: torch.Tensor, ndim: int) -> torch.Tensor:
        return v.reshape((LIMBS,) + (1,) * (ndim - 1))

    def _canonical(self, r: torch.Tensor) -> torch.Tensor:
        """(17, ...) limbs of a value below 2p, each limb below 2^48 ->
        (16, ...) canonical limbs."""
        for j in range(LIMBS):
            r[j + 1] += r[j] >> BITS
            r[j] &= MASK
        d = r[:LIMBS] - self._shaped(self._P, r.dim())
        for j in range(LIMBS - 1):
            d[j + 1] += d[j] >> BITS
            d[j] &= MASK
        keep = (d[LIMBS - 1] < 0) | (r[LIMBS] < 0)
        return torch.where(keep, r[:LIMBS], d)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a b R^-1 mod p (Montgomery product), broadcasting over the trailing shape."""
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        b = b.expand((LIMBS,) + shape)
        t = torch.zeros((2 * LIMBS + 1,) + shape, dtype=torch.int64, device=a.device)
        for i in range(LIMBS):
            t[i:i + LIMBS].addcmul_(a[i:i + 1], b)
        P = self._shaped(self._P, t.dim())
        for i in range(LIMBS):
            m = (t[i] * self.pinv) & MASK
            t[i:i + LIMBS].addcmul_(P, m[None])
            t[i + 1] += t[i] >> BITS
        return self._canonical(t[LIMBS:])

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = a + b
        r = torch.zeros((LIMBS + 1,) + s.shape[1:], dtype=torch.int64, device=s.device)
        r[:LIMBS] = s
        return self._canonical(r)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a + (p - b), a value in (0, 2p), from limbs that may be negative."""
        s = a + (self._shaped(self._P, b.dim()) - b)
        r = torch.zeros((LIMBS + 1,) + s.shape[1:], dtype=torch.int64, device=s.device)
        r[:LIMBS] = s
        return self._canonical(r)

    def scale(self, a: torch.Tensor, k: int) -> torch.Tensor:
        return self.mul(a, self._shaped(self.const(k), a.dim()))

    def add_const(self, a: torch.Tensor, k: int) -> torch.Tensor:
        return self.add(a, self._shaped(self.const(k), a.dim()).expand_as(a))

    # -- reductions and scans over the last axis --

    def sum(self, a: torch.Tensor) -> int:
        """The field sum of a (16, N) vector, as a canonical int."""
        cols = a.reshape(LIMBS, -1).sum(dim=1).tolist()
        v = sum(c << (BITS * i) for i, c in enumerate(cols))
        return v * self.r_inv % self.p

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> int:
        return self.sum(self.mul(a, b))

    def powers(self, base: int, count: int) -> torch.Tensor:
        """[base^i for i < count] as (16, count): a host table of the low
        powers and one of the high ones, joined by one product."""
        lo_n = 1 << max(0, (count.bit_length() + 1) // 2)
        hi_n = -(-count // lo_n)
        p = self.p
        lo, cur = [], 1
        for _ in range(lo_n):
            lo.append(cur)
            cur = cur * base % p
        hi, step, cur = [], cur, 1
        for _ in range(hi_n):
            hi.append(cur)
            cur = cur * step % p
        out = self.mul(self.from_ints(hi)[:, :, None], self.from_ints(lo)[:, None, :])
        return out.reshape(LIMBS, -1)[:, :count].contiguous()

    def cumprod(self, a: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """Inclusive running products along the last axis (log-depth)."""
        x = a.flip(-1) if reverse else a.clone()
        n, d = x.shape[-1], 1
        while d < n:
            x = torch.cat([x[:, :d], self.mul(x[:, d:], x[:, :-d])], dim=1)
            d *= 2
        return x.flip(-1) if reverse else x

    # -- radix-2 NTT over a power-of-two length, natural order in and out --

    def _bit_reversal(self, log_n: int) -> torch.Tensor:
        if log_n not in self._rev:
            idx = torch.arange(1 << log_n, device=self.device)
            rev = torch.zeros_like(idx)
            for b in range(log_n):
                rev |= ((idx >> b) & 1) << (log_n - 1 - b)
            self._rev[log_n] = rev
        return self._rev[log_n]

    def _twiddles(self, root: int, half: int) -> torch.Tensor:
        if (root, half) not in self._tw:
            self._tw[(root, half)] = self.powers(root, half)
        return self._tw[(root, half)]

    def ntt(self, a: torch.Tensor, root: int) -> torch.Tensor:
        """[sum_j a_j root^(i j)] for i < n, n = a.shape[-1] a power of two
        and root a primitive n-th root of unity (bit reversal, then radix-2
        stages; the index and twiddle tables are kept for the next call)."""
        n = a.shape[-1]
        log_n = n.bit_length() - 1
        assert 1 << log_n == n
        x = a[:, self._bit_reversal(log_n)]
        table = self._twiddles(root, max(n // 2, 1))  # root^j, j < n/2
        half = 1
        while half < n:
            tw = table[:, :: n // (2 * half)][:, None, :]  # (16, 1, half)
            v = x.reshape(LIMBS, n // (2 * half), 2, half)
            u, w = v[:, :, 0], self.mul(v[:, :, 1], tw)
            x = torch.stack([self.add(u, w), self.sub(u, w)], dim=2).reshape(LIMBS, n)
            half *= 2
        return x

    def intt(self, a: torch.Tensor, root: int) -> torch.Tensor:
        n = a.shape[-1]
        return self.scale(self.ntt(a, pow(root, -1, self.p)), pow(n, -1, self.p))
