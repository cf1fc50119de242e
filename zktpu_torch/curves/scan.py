"""Suffix scans over batches of G1 points (counterpart of zktpu/curves/scan.py).

Two scans, both batched over a leading axis (every window of every scalar
vector of an MSM at once):

- ``point_suffix_scan``: T[:, i] = sum_{j >= i} P[:, j] over projective
  points, by log-depth doubling (log2 N full-width ``proj_add`` launches).
  ``msm_proj`` uses it.
- ``point_suffix_scan_sparse_affine``: the same sums over AFFINE points, read
  only at given positions, in zktpu's three blocked phases.  The blocks are
  what give the mixed add (kernel 4, ``proj_madd``) an affine operand: inside
  a block of K points the running sum is projective and every next point is
  an original affine one.  Work is about N mixed adds, 2 N / K full adds for
  the block totals and one full add per position, against N log2 N full adds
  for the doubling scan.  ``msm_affine`` uses it.
"""
from __future__ import annotations

import torch

from .g1 import affine_to_proj, proj_add, proj_identity, proj_madd


def point_suffix_scan(P):
    """T[:, i] = sum_{j >= i} P[:, j] over dim 1 of projective (B, N, 12) planes.

    Two buffers take turns: each step's proj_add reads slices of one and
    writes the other in place, and only the d-row tail that the step leaves
    unchanged is copied over.  P itself is not written."""
    B, n, L = P[0].shape
    if n <= 1:
        return P
    bufs = [tuple(torch.empty((B, n, L), dtype=a.dtype, device=a.device) for a in P) for _ in range(2)]
    d, k = 1, 0
    while d < n:
        nxt = bufs[k]
        proj_add(tuple(a[:, : n - d] for a in P), tuple(a[:, d:] for a in P), out=tuple(b[:, : n - d] for b in nxt))
        for b, a in zip(nxt, P):
            b[:, n - d :] = a[:, n - d :]
        P, k, d = nxt, 1 - k, 2 * d
    return P


def point_suffix_scan_sparse_affine(A, idx: torch.Tensor, K: int = 16):
    """T[b, idx[b, m]] with T[b, i] = sum_{j >= i} A[b, j].

    A = (Xa, Ya): affine (B, N, 12) Montgomery planes, identity (0, 0).
    idx: (B, M) positions; a position >= N (an empty suffix) gives the
    identity.  Returns projective (B, M, 12) planes.
    """
    Xa, Ya = A
    B, n, L = Xa.shape
    device = Xa.device
    g = -(-n // K)
    pad = torch.zeros((B, g * K - n, L), dtype=Xa.dtype, device=device)
    # (K, B, g, L): column t of every block is one contiguous slice; zero
    # padding is the affine identity, which the mixed add passes through
    xb, yb = (torch.cat([a, pad], dim=1).reshape(B, g, K, L).permute(2, 0, 1, 3).contiguous() for a in (Xa, Ya))

    # phase 1: in-block suffix scan, K - 1 mixed adds over all blocks at once;
    # only column K - 1 is lifted to projective
    last_inf = (xb[K - 1] == 0).all(-1) & (yb[K - 1] == 0).all(-1)
    carry = affine_to_proj(xb[K - 1], yb[K - 1], last_inf)
    S = tuple(torch.empty((K, B, g, L), dtype=Xa.dtype, device=device) for _ in range(3))
    for s, c in zip(S, carry):
        s[K - 1] = c
    for t in range(K - 2, -1, -1):  # each mixed add writes its column of S in place
        carry = proj_madd(carry, (xb[t], yb[t]), out=tuple(s[t] for s in S))

    # phase 2: suffix scan of the block totals, shifted to exclusive
    R = point_suffix_scan(carry)  # (B, g, L) inclusive
    ident = proj_identity((B, 1), device)
    Rx = tuple(torch.cat([r[:, 1:], i], dim=1) for r, i in zip(R, ident))

    # phase 3: the correction at the requested positions only
    valid = (idx < n)[..., None]
    ic = idx.clamp(max=n - 1)
    col, blk = ic % K, ic // K
    row = torch.arange(B, device=device)[:, None].expand_as(ic)
    got = proj_add(tuple(s[col, row, blk] for s in S), tuple(r[row, blk] for r in Rx))
    return tuple(torch.where(valid, a, i) for a, i in zip(got, proj_identity((), device)))
