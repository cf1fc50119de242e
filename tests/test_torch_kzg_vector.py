"""The port's commit_vector, open_vector, aggregate_commitments and
batch_verify (zktpu_torch/kzg/scheme.py) against zktpu's, on the cases of
tests/test_g1_msm_kzg.py:104-125: every affine coordinate and evaluation,
and batch_verify's verdicts with the same StdRng seed, against committed
goldens (tests/goldens/kzg_vector.json, written by
tests/goldens/make_goldens.py kzg_vector)."""
import json
import os

import pytest
import torch

from zktpu_torch.fields.host import FR
from zktpu_torch.kzg import KzgOpening, KzgScheme, Srs
from zktpu_torch.poly.poly import Poly
from zktpu_torch.transcript.chacha import StdRng

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "kzg_vector.json")
SECRET, SRS_SIZE = 2, 10
HOMOMORPHISM, FACTOR = [1, 2, 3, 4, 5], 9
AGGREGATE, CHALLENGE = ([1, 2, 3, 4, 5], [1, 2, 3, 4, 8]), 77777
BATCH_POLYS = ([1, 2, 3, 4, 5], [1, 8, 3, 4, 8], [12, 8, 3, 9, 8], [95, 8, 0, 9, 8], [12, 0, 3, 9, 0])
BATCH_POINTS = [12, 4, 2003, 13, 9]
RNG_SEED = 99
VECTOR_POINT = 3


def _pt(p) -> list:
    return [p.x, p.y, p.infinity]


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def scheme():
    return KzgScheme(Srs.new_from_secret(SECRET, SRS_SIZE, device="cpu"))


def _poly(coeffs) -> Poly:
    return Poly.from_ints(FR, coeffs, device="cpu")


def test_scalar_mul_homomorphism(scheme, golden):
    poly = _poly(HOMOMORPHISM)
    c1, c2 = scheme.commit(poly), scheme.commit(poly.scale(FACTOR))
    assert c1.mul(FACTOR) == c2
    g = golden["homomorphism"]
    assert [_pt(c1.point), _pt(c2.point), _pt(c1.mul(FACTOR).point)] == [g["c1"], g["c2"], g["c1_mul"]]


def test_aggregate(scheme, golden):
    c1, c2 = (scheme.commit(_poly(c)) for c in AGGREGATE)
    batch = KzgScheme.aggregate_commitments([c1, c2], CHALLENGE)
    assert batch.point == c1.point + c2.point.mul(CHALLENGE)
    g = golden["aggregate"]
    assert [_pt(c1.point), _pt(c2.point), _pt(batch.point)] == [g["c1"], g["c2"], g["batch"]]
    assert KzgScheme.aggregate_commitments([], CHALLENGE).point.infinity


def test_batch_verify_accepts_and_rejects_as_zktpu(scheme, golden):
    polys = [_poly(c) for c in BATCH_POLYS]
    openings = [scheme.open(f, z) for f, z in zip(polys, BATCH_POINTS)]
    commits = [scheme.commit(f) for f in polys]
    g = golden["batch"]
    assert [_pt(c.point) for c in commits] == g["commits"]
    assert [_pt(o.point) + [o.evaluation] for o in openings] == g["openings"]
    assert scheme.batch_verify(commits, BATCH_POINTS, openings, StdRng.from_seed_u64(RNG_SEED)) is g["accept"] is True
    openings[2] = KzgOpening(openings[2].point, openings[2].evaluation + 1)
    got = scheme.batch_verify(commits, BATCH_POINTS, openings, StdRng.from_seed_u64(RNG_SEED))
    assert got is g["reject_changed_evaluation"] is False


def test_batch_verify_draws_match_zktpu(golden):
    rng = StdRng.from_seed_u64(RNG_SEED)
    assert [rng.gen_u128() for _ in BATCH_POINTS] == golden["gen_u128"]


def test_commit_empty_is_identity(scheme, golden):
    assert scheme.commit(Poly.zero(FR, device="cpu")).point.infinity
    assert _pt(scheme.commit_vector([]).point) == golden["empty"] == [0, 0, True]
    assert scheme.commit_vector([0, 0, 0]).point.infinity  # trailing zeros trimmed


def test_commit_and_open_vector(scheme, golden):
    com = scheme.commit_vector(HOMOMORPHISM)
    opening = scheme.open_vector(HOMOMORPHISM, VECTOR_POINT)
    assert com == scheme.commit(_poly(HOMOMORPHISM))
    assert _pt(com.point) == golden["vector"]["commit"]
    assert _pt(opening.point) + [opening.evaluation] == golden["vector"]["open"]
    assert scheme.verify(com, opening, VECTOR_POINT)
