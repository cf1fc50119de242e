"""Pippenger multi-scalar multiplication over limb tensors (counterpart of
zktpu/curves/msm.py, digit backend).

Per window of c bits, for every window and every scalar vector at once:
  1. ids = the window's c-bit digit of each scalar;
  2. sort the points by id (torch.sort);
  3. suffix sums T[i] = sum_{j >= i} P_sorted[j] (curves/scan.py);
  4. the weighted bucket sum telescopes through the sorted order:
       sum_k k S_k = sum_{k=1}^{2^c - 1} T[lower_bound(ids, k)]
     (torch.searchsorted; an empty suffix gives the identity), summed by a
     tree of proj_adds.
Windows combine MSB first with c doublings between (Horner,
g1_kernel.horner_combine).  Any grouping
gives the same group element; results are compared in affine form.

Two point formats: ``msm_proj`` takes projective points and scans the whole
sorted order by doubling; ``msm_affine`` takes affine points (identity
(0, 0)), runs the blocked mixed-add scan and reads it at the bucket starts
only.
"""
from __future__ import annotations

import torch

from ..fields.limbs import MASK32, widen
from . import g1
from .g1 import proj_identity
from .g1_kernel import horner_combine
from .scan import point_suffix_scan, point_suffix_scan_sparse_affine


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


def _buckets(scalars_u32: torch.Tensor, c: int):
    """For (K, N, 8) scalars: the sort order of every window of every vector
    ((W K, N)), the bucket starts lower_bound(ids, k) for k = 1..2^c - 1
    ((W K, 2^c - 1), N where a bucket and all above it are empty), and W."""
    K, N = scalars_u32.shape[:2]
    digits = window_digits(scalars_u32, c)  # (W, K, N)
    W = digits.shape[0]
    ids, order = torch.sort(digits.reshape(W * K, N).contiguous(), dim=1)
    ks = torch.arange(1, 1 << c, device=ids.device, dtype=ids.dtype)
    starts = torch.searchsorted(ids.contiguous(), ks.expand(W * K, -1).contiguous())
    return order, starts, W


def _combine(G, W: int, K: int, c: int):
    """Tree-sum the (W K, 2^c - 1) gathered suffix values of each window, then
    combine the windows MSB first with c doublings between (Horner, one
    launch on the card)."""
    parts = tuple(a.reshape(W, K, -1) for a in g1.proj_tree_sum(G, axis=1))
    return horner_combine(parts, c)


def msm_proj_many(scalars_u32: torch.Tensor, X, Y, Z, c: int = 8):
    """(K, N, 8) scalars x one (N, 12) point set -> K projective points ((K, 12) x3)."""
    K, N = scalars_u32.shape[:2]
    device = X.device
    if N == 0:
        return proj_identity((K,), device)
    order, starts, W = _buckets(scalars_u32, c)
    T = point_suffix_scan(tuple(a[order] for a in (X, Y, Z)))  # (W K, N, 12) each
    idx = starts.clamp(max=N - 1)[..., None].expand(-1, -1, X.shape[-1])
    empty = (starts >= N)[..., None]
    ident = proj_identity((), device)
    G = tuple(torch.where(empty, i, torch.gather(a, 1, idx)) for a, i in zip(T, ident))
    return _combine(G, W, K, c)


def msm_proj(scalars_u32: torch.Tensor, X, Y, Z, c: int = 8):
    """(N, 8) scalars x (N, 12) points -> one projective point ((12,) x3)."""
    return tuple(a[0] for a in msm_proj_many(scalars_u32[None], X, Y, Z, c=c))


def msm_affine_many(scalars_u32: torch.Tensor, Xa, Ya, c: int = 8):
    """(K, N, 8) scalars x one AFFINE (N, 12) point set (identity (0, 0)) ->
    K projective points ((K, 12) x3), through the mixed-add scan."""
    K, N = scalars_u32.shape[:2]
    if N == 0:
        return proj_identity((K,), Xa.device)
    order, starts, W = _buckets(scalars_u32, c)
    G = point_suffix_scan_sparse_affine((Xa[order], Ya[order]), starts)
    return _combine(G, W, K, c)


def msm_affine(scalars_u32: torch.Tensor, Xa, Ya, c: int = 8):
    """(N, 8) scalars x affine (N, 12) points -> one projective point ((12,) x3)."""
    return tuple(a[0] for a in msm_affine_many(scalars_u32[None], Xa, Ya, c=c))


def padded_msm_len(n: int) -> int:
    """zktpu's compile-bucket length for an N-point MSM: the next power of two
    (at least 16), or that power's half + 256 when n is just above it."""
    if n <= 1:
        return 16
    m = max(16, 1 << (n - 1).bit_length())
    h = m >> 1
    if h >= 4096 and n <= h + 256:
        return h + 256
    return m


def pad_msm_inputs_affine(scalars_u32: torch.Tensor, Xa, Ya):
    """Pad to padded_msm_len with zero scalars and (0, 0) affine identity points
    (zero scalars land in bucket 0, which the weighted sum excludes)."""
    n = scalars_u32.shape[0]
    pad = padded_msm_len(n) - n
    if pad == 0:
        return scalars_u32, Xa, Ya
    return tuple(torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]) for a in (scalars_u32, Xa, Ya))


def pick_window(n: int) -> int:
    """Window size by point count (the same rule as zktpu)."""
    if n <= (1 << 8):
        return 4
    if n <= (1 << 12):
        return 8
    if n <= (1 << 18):
        return 13
    return 16
