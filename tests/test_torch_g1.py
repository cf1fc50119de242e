"""zktpu_torch G1 group law vs zktpu and the host curve.

The plain proj_add / proj_double (the CPU side of kernels 2 and 3) are held
word for word against zktpu's jnp group law on the complete-formula edge
lanes: identity operands, P + P, P + (-P) and identity + identity.  zktpu's
words are a committed golden (tests/goldens/g1.npz, written once by
tests/goldens/make_goldens.py g1), so no JAX graph compiles here.
"""
import os

import numpy as np
import pytest
import torch

from zktpu_torch.curves import g1
from zktpu_torch.curves.g1_kernel import proj_add, proj_add_plain, proj_double
from zktpu_torch.curves.host_curve import G1Affine
from zktpu_torch.fields.host import FR

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "g1.npz")
G = G1Affine.generator()
PTS1 = [G.mul(k) for k in (1, 2, 3, 7, 1)] + [G1Affine.identity()]
PTS2 = [G1Affine.identity(), G.mul(5), G.mul(3), G.mul(FR.modulus - 7), G.mul(11), G1Affine.identity()]


def _assert_words_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.fixture(scope="module")
def zktpu_points():
    """zktpu's words (tests/goldens/g1.npz): {"P", "Q", "add", "double"} -> (X, Y, Z) as (6, 12) limbs."""
    with np.load(GOLDEN) as z:
        return {name: tuple(z[f"{name}/{k}"] for k in "XYZ") for name in ("P", "Q", "add", "double")}


def _torch(triple):
    return tuple(torch.from_numpy(a) for a in triple)


def test_proj_add_matches_zktpu_words(zktpu_points):
    got = proj_add(_torch(zktpu_points["P"]), _torch(zktpu_points["Q"]))
    _assert_words_equal(got, zktpu_points["add"])
    assert g1.proj_to_affine_host(got) == [a + b for a, b in zip(PTS1, PTS2)]


def test_proj_double_matches_zktpu_words(zktpu_points):
    got = proj_double(_torch(zktpu_points["P"]))
    _assert_words_equal(got, zktpu_points["double"])
    assert g1.proj_to_affine_host(got) == [p + p for p in PTS1]


def test_host_points_to_device_matches_zktpu(zktpu_points):
    _assert_words_equal(g1.host_points_to_device(PTS1, device="cpu"), zktpu_points["P"])
    _assert_words_equal(g1.host_points_to_device(PTS2, device="cpu"), zktpu_points["Q"])
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
    r = FR.modulus
    scalars = [0, 1, 5, r - 1, 2**200 + 3, 0xDEADBEEF << 96, (1 << 255) % r]
    got = g1.proj_to_affine_host(g1.fixed_base_mul_u32(G, g1.scalars_to_u32(scalars, device="cpu")))
    assert got == [G.mul(s) for s in scalars]


def test_plane_strides_of_slices_and_broadcasts():
    """The (pointer, outer, inner) row strides the kernels read operands by."""
    from zktpu_torch.curves.g1_kernel import _plane

    a = torch.zeros((3, 10, 12), dtype=torch.int32)
    assert _plane(a[:, 2:9], (3, 7)) == (a[:, 2:].data_ptr(), 10, 1)
    assert _plane(a[1, 4], (3, 7)) == (a[1, 4].data_ptr(), 0, 0)  # one point broadcast
    assert _plane(a[:, 5:6], (3, 7)) == (a[:, 5].data_ptr(), 10, 0)  # one point per row
    assert _plane(a.reshape(3, 2, 5, 12), (3, 2, 5)) == (a.data_ptr(), 5, 1)  # outer dims collapse
    assert _plane(a.transpose(0, 1), (10, 3)) == (a.data_ptr(), 1, 10)
    assert _plane(torch.zeros((4, 5, 6, 12), dtype=torch.int32)[:, :2, :3], (4, 2, 3)) is None  # not collapsible
    assert _plane(a.reshape(-1)[1:25].reshape(2, 12), (2,)) is None  # rows not 16-byte aligned
    assert _plane(a[0].t().contiguous().t(), (10,)) is None  # limb-major: limbs not contiguous


def test_group_law_wrappers_out_and_aliasing():
    """out= planes get the plain result through the same signature; outputs
    that overlap an input or each other, or have the wrong shape, raise."""
    from zktpu_torch.curves.g1_kernel import proj_madd, proj_madd_plain

    P = g1.host_points_to_device(PTS1, device="cpu")
    Q = g1.host_points_to_device(PTS2, device="cpu")
    plane = [torch.zeros((2, 6, 12), dtype=torch.int32) for _ in range(3)]
    out = tuple(t[1] for t in plane)  # views into larger planes
    assert proj_add(P, Q, out=out) is out
    for a, b in zip(plane, proj_add_plain(P, Q)):
        assert torch.equal(a[1], b) and not a[0].any()
    A2 = tuple(t[0] for t in g1.proj_to_affine_dev(tuple(t[1:2] for t in Q)))  # affine 5 G, broadcast
    got = proj_madd(P, A2, out=tuple(torch.empty((6, 12), dtype=torch.int32) for _ in range(3)))
    for a, b in zip(got, proj_madd_plain(P, A2)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="overlap"):
        proj_add(P, Q, out=(P[0], Q[1].clone(), Q[2].clone()))
    with pytest.raises(ValueError, match="overlap"):
        proj_madd(P, A2, out=(plane[0][0], plane[0][0], plane[2][0]))
    with pytest.raises(ValueError, match="overlap"):
        proj_double(P, out=(plane[0][0], plane[1][0], P[2]))
    with pytest.raises(ValueError, match="int32"):
        proj_add(P, Q, out=tuple(t[:, :5] for t in plane))
