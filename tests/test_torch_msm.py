"""zktpu_torch Pippenger MSM vs the naive host sum and zktpu's window digits."""
import random

import numpy as np
import pytest
import torch

from zktpu.curves import msm as zmsm
from zktpu.curves.host_curve import G1Affine
from zktpu.fields import host
from zktpu_torch.curves import g1, msm

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

G = G1Affine.generator()
R = host.FR_MODULUS


def _naive(scalars, points):
    acc = G1Affine.identity()
    for s, p in zip(scalars, points):
        acc = acc + p.mul(s)
    return acc


def _msm(scalars, points, c=None):
    sc = g1.scalars_to_u32(scalars, device="cpu")
    R = msm.msm_proj(sc, *points, c=msm.pick_window(len(scalars)) if c is None else c)
    return g1.proj_to_affine_host(tuple(a[None] for a in R))[0]


def _points(n, seed):
    rng = random.Random(seed)
    return [G.mul(rng.randrange(1, 1 << 12)) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 17, 100])
def test_msm_matches_naive_sum(n):
    rng = random.Random(n)
    pts = _points(n, seed=n)
    scalars = [rng.randrange(R) for _ in range(n)]
    if n > 3:
        scalars[0], scalars[1] = 0, R - 1  # zero scalar, p - 1
        pts[3] = pts[2]  # a repeated point
        scalars[3] = scalars[2]
    assert _msm(scalars, g1.host_points_to_device(pts, device="cpu")) == _naive(scalars, pts)


def test_msm_all_digits_maximal():
    """Every 4-bit window of 2^252 - 1 is 15 (every bucket search lands at 0)
    and its top window is 0 (every search runs off the end: the identity)."""
    pts = _points(9, seed=2)
    scalars = [(1 << 252) - 1] * 9
    got = _msm(scalars, g1.host_points_to_device(pts, device="cpu"), c=4)
    assert got == _naive(scalars, pts)


def test_msm_many_matches_single():
    pts = _points(12, seed=4)
    rng = random.Random(8)
    rows = [[rng.randrange(R) for _ in range(12)] for _ in range(3)]
    rows[1] = [0] * 12
    P = g1.host_points_to_device(pts, device="cpu")
    sc = torch.stack([g1.scalars_to_u32(r, device="cpu") for r in rows])
    got = g1.proj_to_affine_host(msm.msm_proj_many(sc, *P, c=8))
    assert got == [_naive(r, pts) for r in rows]


@pytest.mark.parametrize("c", [4, 8, 13, 16])
def test_window_digits_match_zktpu(c):
    rng = random.Random(c)
    scalars = [rng.randrange(R) for _ in range(20)] + [0, R - 1, (1 << 252) - 1]
    want = np.asarray(zmsm.window_digits(np.asarray(_u32(scalars)), c))
    got = msm.window_digits(g1.scalars_to_u32(scalars, device="cpu"), c).numpy()
    np.testing.assert_array_equal(got, want)


def _u32(scalars):
    return np.array([[(s >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for s in scalars], dtype=np.uint32)


def test_pick_window_matches_zktpu():
    for n in (1, 256, 257, 4096, 4097, 1 << 18, (1 << 18) + 1, 1 << 22):
        assert msm.pick_window(n) == zmsm.pick_window(n)


def _scan_by_cat(P):
    """The doubling scan as it was before it took out= planes: proj_add of
    two slices, then torch.cat of the head and the unchanged tail."""
    n = P[0].shape[1]
    d = 1
    while d < n:
        head = g1.proj_add(tuple(a[:, : n - d] for a in P), tuple(a[:, d:] for a in P))
        P = tuple(torch.cat([h, a[:, n - d :]], dim=1) for h, a in zip(head, P))
        d *= 2
    return P


@pytest.mark.parametrize("n", [1, 17, 37])
def test_scans_in_place_match_reference(n):
    """The ping-pong doubling scan gives the words of the cat-based one and
    leaves its input unwritten; the blocked affine scan, whose phase 1 writes
    its mixed adds into S in place, gives the same sums at every position."""
    from zktpu_torch.curves.scan import point_suffix_scan, point_suffix_scan_sparse_affine

    rows = [_points(n, seed=n + b) for b in range(2)]
    P = tuple(torch.stack(t) for t in zip(*(g1.host_points_to_device(r, device="cpu") for r in rows)))
    before = tuple(a.clone() for a in P)
    got = point_suffix_scan(P)
    want = _scan_by_cat(P)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(torch.equal(a, c) for a, c in zip(P, before))
    A = tuple(torch.stack(t) for t in zip(*(g1.proj_to_affine_dev(g1.host_points_to_device(r, device="cpu"))
                                            for r in rows)))
    idx = torch.tensor([[0, n - 1, n, n // 2], [n // 3, 0, n - 1, n + 5]])
    sums = g1.proj_to_affine_host(point_suffix_scan_sparse_affine(A, idx))
    flat = g1.proj_to_affine_host(want)
    assert sums == [flat[b * n + i] if i < n else G1Affine.identity() for b in range(2) for i in idx[b].tolist()]


@pytest.mark.parametrize("W,K", [(3, 1), (4, 3), (5, 1), (5, 3)])
def test_horner_combine_plain_matches_old_loop_and_host(W, K):
    """horner_combine_plain (what the one-launch kernel is held against) at
    c = 4: equal words to the loop of proj_double / proj_add calls that
    _combine ran before, and equal points to sum_w 2^(c w) part_w in host
    arithmetic; one part is the identity."""
    from zktpu_torch.curves.g1_kernel import horner_combine_plain

    c = 4
    pts = _points(W * K, seed=10 * W + K)
    pts[1] = G1Affine.identity()
    parts = tuple(t.reshape(W, K, 12) for t in g1.host_points_to_device(pts, device="cpu"))
    got = horner_combine_plain(parts, c)
    acc = tuple(a[W - 1] for a in parts)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = g1.proj_double(acc)
        acc = g1.proj_add(acc, tuple(a[w] for a in parts))
    for a, b in zip(got, acc):
        assert torch.equal(a, b)
    want = []
    for k in range(K):
        s = G1Affine.identity()
        for w in range(W):
            s = s + pts[w * K + k].mul(1 << (c * w))
        want.append(s)
    assert g1.proj_to_affine_host(got) == want
