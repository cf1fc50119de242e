"""The affine-point MSM slice of zktpu_torch against zktpu and host ints.

Kernel 4's plain version (the mixed add) is held word for word against
zktpu's jnp mixed add on its edge lanes; the batch affine conversion, the
blocked mixed-add suffix scan, msm_affine and msm_affine_many against host
curve arithmetic and the port's msm_proj; kernel 5's plain version (the
chained product) against host ints and zktpu's product.  Inputs are made
with numpy from fixed seeds; every comparison is exact (integers and words).

The points of the MSM cases are k_i G with known k_i, so the host reference
is one scalar multiplication by sum s_i k_i.  The plain (CPU) group law costs
several seconds per MSM, most of it in the c (W - 1) sequential doublings of
the Horner combine, so each (N, c) case is one msm_affine call, and msm_proj
(already held against host sums up to N = 100 in test_torch_msm.py) is
compared at the cheapest case.  N = 1 and 17 are padded to 16 and 32 points,
multiples of the scan's block of 16; N = 100 is not, and is not padded.

zktpu's own msm_affine is not built here: XLA:CPU segfaults compiling it,
which is why zktpu's tests gate it behind ZKTPU_RUN_AFFINE_MSM
(tests/test_g1_msm_kzg.py).  The port is held against host arithmetic instead.
"""
import numpy as np
import pytest
import torch

from zktpu.curves import g1 as zg1
from zktpu.fields.fp import device_field
from zktpu_torch.convert import digits_to_limbs, limbs_to_digits
from zktpu_torch.curves import g1, msm
from zktpu_torch.curves.g1_kernel import proj_madd
from zktpu_torch.curves.host_curve import G1Affine
from zktpu_torch.curves.pairing import Fq12, pairing_product
from zktpu_torch.curves.scan import point_suffix_scan_sparse_affine
from zktpu_torch.fields.fp import field
from zktpu_torch.fields.host import FQ, FR
from zktpu_torch.fields.mont_kernel import mont_mul_chain, mont_mul_chain_plain
from zktpu_torch.kzg import Srs

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

G = G1Affine.generator()
P, R = FQ.modulus, FR.modulus
FQT = field(FQ, "cpu")
CHAIN = 12


def _logs(rng, n):
    return [int(k) for k in rng.integers(1, 1 << 12, size=n)]


def _points(rng, n):
    return [G.mul(k) for k in _logs(rng, n)]


def _proj_general_z(rng, pts):
    """Host points -> projective planes (x z, y z, z) with random nonzero z."""
    zs = [int.from_bytes(rng.bytes(48), "little") % (P - 1) + 1 for _ in pts]
    X = FQT.encode_ints([0 if p.infinity else p.x * z % P for p, z in zip(pts, zs)])
    Y = FQT.encode_ints([1 if p.infinity else p.y * z % P for p, z in zip(pts, zs)])
    Z = FQT.encode_ints([0 if p.infinity else z for p, z in zip(pts, zs)])
    return X, Y, Z


def _affine(pts):
    """Host points -> affine planes with (0, 0) for the identity."""
    return (FQT.encode_ints([0 if p.infinity else p.x for p in pts]),
            FQT.encode_ints([0 if p.infinity else p.y for p in pts]))


def _to_host(P1):
    return g1.proj_to_affine_host(tuple(a.reshape(-1, 12) for a in P1))


def _naive(scalars, pts):
    acc = G1Affine.identity()
    for s, p in zip(scalars, pts):
        acc = acc + p.mul(s)
    return acc


def test_proj_madd_plain_matches_zktpu_words():
    """Lanes: 0 P1 = identity; 1 A2 = (0, 0); 2 A2 = P1 (doubling); 3 A2 = -P1;
    4 all-zero padding; 5-7 general."""
    rng = np.random.default_rng(31)
    p1 = _points(rng, 8)
    p1[0] = G1Affine.identity()
    a2 = _points(rng, 8)
    a2[1], a2[2], a2[3] = G1Affine.identity(), p1[2], -p1[3]
    P1 = _proj_general_z(rng, p1)
    A2 = _affine(a2)
    for t in (*P1, *A2):
        t[4] = 0
    got = proj_madd(P1, A2)
    want = zg1._proj_madd_jnp(zg1.FQD, tuple(limbs_to_digits(t.numpy()) for t in P1),
                              tuple(limbs_to_digits(t.numpy()) for t in A2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), digits_to_limbs(np.asarray(b)))
    assert all(not t[4].any() for t in got)
    assert _to_host(tuple(t[:4] for t in got)) + _to_host(tuple(t[5:] for t in got)) == [
        x + y for i, (x, y) in enumerate(zip(p1, a2)) if i != 4
    ]


def test_proj_to_affine_dev_matches_host():
    rng = np.random.default_rng(5)
    pts = _points(rng, 9)
    Xa, Ya = g1.proj_to_affine_dev(_proj_general_z(rng, pts))
    assert FQT.decode_ints(Xa) == [p.x for p in pts]
    assert FQT.decode_ints(Ya) == [p.y for p in pts]


@pytest.mark.parametrize("K", [4, 16])
def test_sparse_affine_scan_matches_naive_suffix_sums(K):
    rng = np.random.default_rng(K)
    n, B = 37, 2  # not a multiple of K: the last block is zero-padded
    rows = [_points(rng, n) for _ in range(B)]
    rows[1][5] = G1Affine.identity()  # an identity inside the data
    planes = [_affine(r) for r in rows]
    A = tuple(torch.stack([p[i] for p in planes]) for i in range(2))
    idx = torch.tensor([[0, 1, 15, 16, 36, 37, 40], [n, 3, 17, 31, 0, 36, 5]])
    got = point_suffix_scan_sparse_affine(A, idx, K=K)
    want = []
    for b, r in enumerate(rows):
        for i in idx[b].tolist():
            want.append(_naive([1] * max(n - i, 0), r[i:]))
    assert _to_host(got) == want


@pytest.mark.parametrize("n, c, pad, vs_proj", [(1, 4, True, True), (100, 8, False, False)])
def test_msm_affine_matches_naive_and_msm_proj(n, c, pad, vs_proj):
    rng = np.random.default_rng(1000 * c + n)
    logs = _logs(rng, n)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    scalars[0] = (1 << (c * (256 // c - 1))) - 1  # every digit maximal but the top one
    if n > 3:
        scalars[1] = 0
        logs[2] = 0  # a (0, 0) point with a nonzero scalar
    pts = [G.mul(k) for k in logs]
    want = G.mul(sum(s * k for s, k in zip(scalars, logs)))
    sc, Xa, Ya = g1.scalars_to_u32(scalars, device="cpu"), *_affine(pts)
    if pad:  # zero scalars on (0, 0) points up to zktpu's bucket length
        sc, Xa, Ya = msm.pad_msm_inputs_affine(sc, Xa, Ya)
        assert sc.shape[0] == msm.padded_msm_len(n) > n and not Xa[n:].any() and not sc[n:].any()
    assert _to_host(msm.msm_affine(sc, Xa, Ya, c=c)) == [want]
    if vs_proj:
        X, Y, Z = g1.host_points_to_device(pts, device="cpu")
        assert _to_host(msm.msm_proj(sc[:n], X, Y, Z, c=c)) == [want]


def test_msm_affine_many_on_srs_affine_points():
    """K = 3 scalar vectors (random with every digit maximal in one scalar,
    all zero, random) over N = 17 SRS points from Srs.g1_affine, one of them
    replaced by (0, 0), padded to zktpu's bucket length (32), at c = 4."""
    n, tau, c = 17, 0x1F3A5, 4
    srs = Srs.new_from_secret(tau, n - 3, device="cpu")
    Xa, Ya = srs.g1_affine()
    host_pts = srs.g1_points_host()
    assert FQT.decode_ints(Xa) == [p.x for p in host_pts] and FQT.decode_ints(Ya) == [p.y for p in host_pts]
    Xa, Ya = Xa.clone(), Ya.clone()
    Xa[7] = 0
    Ya[7] = 0
    logs = [0 if i == 7 else pow(tau, i, R) for i in range(n)]
    rng = np.random.default_rng(3)
    rows = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)] for _ in range(3)]
    rows[0][5] = (1 << (c * (256 // c - 1))) - 1
    rows[1] = [0] * n
    padded = [msm.pad_msm_inputs_affine(g1.scalars_to_u32(r, device="cpu"), Xa, Ya) for r in rows]
    sc, (Xa, Ya) = torch.stack([p[0] for p in padded]), padded[0][1:]
    assert sc.shape[1] == Xa.shape[0] == msm.padded_msm_len(n) == 32
    got = _to_host(msm.msm_affine_many(sc, Xa, Ya, c=c))
    assert got == [G.mul(sum(s * k for s, k in zip(r, logs)) % R) for r in rows]
    assert _to_host(msm.msm_affine_many(sc[:, :0], Xa[:0], Ya[:0])) == [G1Affine.identity()] * 3


def test_srs_new_uses_a_random_secret():
    a, b = Srs.new(4, device="cpu"), Srs.new(4, device="cpu")
    assert a.size == 7 and a.g1_generator_host() == G
    assert a.g1_points_host()[1] != b.g1_points_host()[1]
    s_g = a.g1_points_host()[1]  # e(sG, G2) == e(G, sG2)
    assert pairing_product([(s_g, a.g2()), (-G, a.g2s())]) == Fq12.one()


def test_mont_mul_chain_plain_matches_host_and_zktpu():
    rng = np.random.default_rng(12)
    a = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P for _ in range(13)]
    b = [P - 1, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P for _ in range(13)]
    A, B = FQT.encode_ints(a), FQT.encode_ints(b)
    got = mont_mul_chain(FQ, A, B, CHAIN)  # CPU tensors: the plain version
    assert torch.equal(got, mont_mul_chain_plain(FQ, A, B, CHAIN))
    assert FQT.decode_ints(got) == [x * pow(y, CHAIN, P) % P for x, y in zip(a, b)]
    df = device_field(FQ)
    za, zb = (limbs_to_digits(t.numpy()) for t in (A, B))
    for _ in range(CHAIN):
        za = df.mont_mul(za, zb)
    np.testing.assert_array_equal(got.numpy(), digits_to_limbs(np.asarray(za)))
