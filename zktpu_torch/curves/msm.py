"""Pippenger multi-scalar multiplication over limb tensors (counterpart of
zktpu/curves/msm.py, digit backend).

Per window of c bits, for every window and every scalar vector at once:
  1. ids = the window's c-bit digit of each scalar;
  2. sort the points by id (torch.sort);
  3. suffix sums T[i] = sum_{j >= i} P_sorted[j] by a log-depth doubling scan
     (each step one batched proj_add);
  4. the weighted bucket sum telescopes through the sorted order:
       sum_k k S_k = sum_{k=1}^{2^c - 1} T[lower_bound(ids, k)]
     (torch.searchsorted; an empty suffix gives the identity), summed by a
     tree of proj_adds.
Windows combine MSB first with c doublings between (Horner).  Any grouping
gives the same group element; results are compared in affine form.
"""
from __future__ import annotations

import torch

from ..fields.limbs import MASK32, widen
from . import g1
from .g1 import proj_add, proj_double, proj_identity


def window_digits(scalars_u32: torch.Tensor, c: int) -> torch.Tensor:
    """(..., 8) little-endian u32 limbs -> (W, ...) c-bit window digits
    (int64), LSB window first; a window may straddle two limbs."""
    num_windows = -(-256 // c)
    s = widen(scalars_u32)
    bit = torch.arange(num_windows, device=s.device) * c
    limb, off = bit >> 5, bit & 31
    nxt = limb + 1
    lo = s[..., limb] >> off
    hi = (s[..., nxt.clamp(max=7)] << (32 - off)) & MASK32  # off == 0 -> 0
    hi = torch.where(nxt < 8, hi, 0)
    return torch.movedim((lo | hi) & ((1 << c) - 1), -1, 0)


def _suffix_scan(P):
    """T[:, i] = sum_{j >= i} P[:, j] over dim 1, by log-depth doubling."""
    n = P[0].shape[1]
    d = 1
    while d < n:
        head = proj_add(tuple(a[:, : n - d] for a in P), tuple(a[:, d:] for a in P))
        P = tuple(torch.cat([h, a[:, n - d :]], dim=1) for h, a in zip(head, P))
        d *= 2
    return P


def msm_proj_many(scalars_u32: torch.Tensor, X, Y, Z, c: int = 8):
    """(K, N, 8) scalars x one (N, 12) point set -> K projective points ((K, 12) x3)."""
    K, N = scalars_u32.shape[:2]
    device = X.device
    if N == 0:
        return proj_identity((K,), device)
    digits = window_digits(scalars_u32, c)  # (W, K, N)
    W = digits.shape[0]
    ids, order = torch.sort(digits.reshape(W * K, N).contiguous(), dim=1)
    T = _suffix_scan(tuple(a[order] for a in (X, Y, Z)))  # (W K, N, 12) each
    ks = torch.arange(1, 1 << c, device=device, dtype=ids.dtype)
    starts = torch.searchsorted(ids.contiguous(), ks.expand(W * K, -1).contiguous())  # (W K, 2^c - 1)
    idx = starts.clamp(max=N - 1)[..., None].expand(-1, -1, X.shape[-1])
    empty = (starts >= N)[..., None]
    ident = proj_identity((), device)
    G = tuple(torch.where(empty, i, torch.gather(a, 1, idx)) for a, i in zip(T, ident))
    parts = tuple(a.reshape(W, K, -1) for a in g1.proj_tree_sum(G, axis=1))
    acc = tuple(a[W - 1] for a in parts)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = proj_double(acc)
        acc = proj_add(acc, tuple(a[w] for a in parts))
    return acc


def msm_proj(scalars_u32: torch.Tensor, X, Y, Z, c: int = 8):
    """(N, 8) scalars x (N, 12) points -> one projective point ((12,) x3)."""
    return tuple(a[0] for a in msm_proj_many(scalars_u32[None], X, Y, Z, c=c))


def pick_window(n: int) -> int:
    """Window size by point count (the same rule as zktpu)."""
    if n <= (1 << 8):
        return 4
    if n <= (1 << 12):
        return 8
    if n <= (1 << 18):
        return 13
    return 16
