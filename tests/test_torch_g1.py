"""zktpu_torch G1 group law vs zktpu and the host curve.

The plain proj_add / proj_double (the CPU side of kernels 2 and 3) are held
word for word against zktpu's jnp group law on the complete-formula edge
lanes: identity operands, P + P, P + (-P) and identity + identity.
"""
import numpy as np
import pytest
import torch

from zktpu.curves import g1 as zg1
from zktpu.curves.host_curve import G1Affine
from zktpu.fields import host
from zktpu_torch.convert import digits_to_limbs, limbs_to_digits
from zktpu_torch.curves import g1
from zktpu_torch.curves.g1_kernel import proj_add, proj_add_plain, proj_double

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

G = G1Affine.generator()
PTS1 = [G.mul(k) for k in (1, 2, 3, 7, 1)] + [G1Affine.identity()]
PTS2 = [G1Affine.identity(), G.mul(5), G.mul(3), G.mul(host.FR_MODULUS - 7), G.mul(11), G1Affine.identity()]


def _to_torch(P):
    return tuple(torch.from_numpy(digits_to_limbs(np.asarray(a))) for a in P)


def _assert_words_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(limbs_to_digits(a.numpy()), np.asarray(b))


@pytest.fixture(scope="module")
def zktpu_points():
    return zg1.host_points_to_device(PTS1), zg1.host_points_to_device(PTS2)


def test_proj_add_matches_zktpu_words(zktpu_points):
    P, Q = zktpu_points
    got = proj_add(_to_torch(P), _to_torch(Q))
    _assert_words_equal(got, zg1._proj_add_jnp(zg1.FQD, P, Q))
    assert g1.proj_to_affine_host(got) == [a + b for a, b in zip(PTS1, PTS2)]


def test_proj_double_matches_zktpu_words(zktpu_points):
    P, _ = zktpu_points
    got = proj_double(_to_torch(P))
    _assert_words_equal(got, zg1._proj_double_jnp(zg1.FQD, P))
    assert g1.proj_to_affine_host(got) == [p + p for p in PTS1]


def test_host_points_to_device_matches_zktpu(zktpu_points):
    P, _ = zktpu_points
    _assert_words_equal(g1.host_points_to_device(PTS1, device="cpu"), P)
    assert g1.proj_to_affine_host(g1.host_points_to_device(PTS1, device="cpu")) == PTS1


def test_zero_padding_lanes_map_to_zero():
    z = torch.zeros((3, 12), dtype=torch.int32)
    for t in proj_add_plain((z, z, z), (z, z, z)) + proj_double((z, z, z)):
        assert not t.any()


def test_proj_tree_sum_and_broadcast():
    P = g1.host_points_to_device(PTS1 + PTS2, device="cpu")
    want = G1Affine.identity()
    for pt in PTS1 + PTS2:
        want = want + pt
    assert g1.proj_to_affine_host(tuple(a[None] for a in g1.proj_tree_sum(P))) == [want]
    one = tuple(a[1:2] for a in g1.host_points_to_device(PTS2, device="cpu"))  # (1, 12) against (6, 12)
    assert g1.proj_to_affine_host(proj_add(g1.host_points_to_device(PTS1, device="cpu"), one)) == [a + PTS2[1] for a in PTS1]


def test_fixed_base_mul_matches_host():
    r = host.FR_MODULUS
    scalars = [0, 1, 5, r - 1, 2**200 + 3, 0xDEADBEEF << 96, (1 << 255) % r]
    got = g1.proj_to_affine_host(g1.fixed_base_mul_u32(G, g1.scalars_to_u32(scalars, device="cpu")))
    assert got == [G.mul(s) for s in scalars]
