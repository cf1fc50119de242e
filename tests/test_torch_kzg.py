"""zktpu_torch SRS and KZG vs host arithmetic and zktpu's commitments."""
import random

import pytest
import torch

import zktpu_torch.config as cfg
from zktpu.curves.host_curve import G1Affine, G2Affine
from zktpu.fields.host import FR
from zktpu.kzg.scheme import KzgScheme as ZScheme
from zktpu.poly.poly import Poly as ZPoly
from zktpu_torch.curves import g1
from zktpu_torch.fields.fp import field
from zktpu_torch.kzg import KzgScheme, Srs
from zktpu_torch.poly.poly import Poly

from test_torch_plonk import zktpu_srs

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

SECRET = 0x5EED
R = FR.modulus


@pytest.fixture(scope="module")
def srs():
    return Srs.new_from_secret(SECRET, 24, device="cpu")


def test_srs_matches_host_powers(srs):
    G = G1Affine.generator()
    assert srs.size == 27
    assert srs.g1_points_host() == [G.mul(pow(SECRET, i, R)) for i in range(27)]
    assert srs.g1_generator_host() == G
    assert srs.g2() == G2Affine.generator() and srs.g2s() == G2Affine.generator().mul(SECRET)


def test_device_power_scalars_match_host():
    """The scalars of the large-SRS path (powers, then to u32 limbs)."""
    frd = field(FR, "cpu")
    want = g1.scalars_to_u32([pow(SECRET, i, R) for i in range(40)], device="cpu")
    assert torch.equal(frd.to_u32_limbs(frd.powers(SECRET, 40)), want)


@pytest.mark.parametrize("tier", ["host", "msm"])
def test_commit_and_open_match_zktpu(srs, tier, monkeypatch):
    if tier == "msm":
        monkeypatch.setattr(cfg, "HOST_MSM_MAX", 0)
    rng = random.Random(7)
    coeffs = [rng.randrange(R) for _ in range(20)]
    zscheme = ZScheme(zktpu_srs(SECRET, 24))
    scheme = KzgScheme(srs)
    poly = Poly.from_ints(FR, coeffs, device="cpu")
    cm = scheme.commit(poly)
    assert cm.point == zscheme.commit(ZPoly.from_ints(FR, coeffs)).point
    z = rng.randrange(R)
    opening = scheme.open(poly, z)
    want = zscheme.open(ZPoly.from_ints(FR, coeffs), z)
    assert opening.point == want.point and opening.evaluation == want.evaluation
    assert scheme.verify(cm, opening, z)
    opening.evaluation = (opening.evaluation + 1) % R
    assert not scheme.verify(cm, opening, z)


def test_commit_many_matches_commit(srs, monkeypatch):
    monkeypatch.setattr(cfg, "HOST_MSM_MAX", 0)
    rng = random.Random(9)
    polys = [Poly.from_ints(FR, [rng.randrange(R) for _ in range(k)], device="cpu") for k in (5, 17, 0)]
    scheme = KzgScheme(srs)
    got = scheme.commit_many(polys)
    monkeypatch.setattr(cfg, "HOST_MSM_MAX", 64)
    assert [c.point for c in got] == [scheme.commit(p).point for p in polys]
    assert scheme.commit_para(3).point == G1Affine.generator().mul(3)
