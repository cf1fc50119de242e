"""CPU tests of the plain reference: its field and curve arithmetic against
Python ints, its transcript against the program's, and its PLONK proof and
KZG answers against the program's at tiny sizes.

    python -m pytest zkbench/test_zkbench_reference.py -q
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from zkbench.reference import curve
from zkbench.reference.curve import Q, R
from zkbench.reference.field import PlainField
from zkbench.reference.kzg import KzgReference
from zkbench.reference.plonk import MulChainReference
from zkbench.reference.transcript import StdRng, Transcript, fp_rand, g1_bytes

torch.set_num_threads(1)

EDGES = [0, 1, 2, R - 1, R - 2, (1 << 128) - 1, 1 << 254]


@pytest.fixture(scope="module")
def F():
    return PlainField(R, "cpu")


def _vals(rng, k):
    return [rng.randrange(R) for _ in range(k)] + EDGES


def test_field_ops_match_python_ints(F):
    rng = random.Random(7)
    xs, ys = _vals(rng, 60), _vals(rng, 60)[::-1]
    a, b = F.from_ints(xs), F.from_ints(ys)
    assert F.to_ints(a) == xs
    assert F.to_ints(F.mul(a, b)) == [x * y % R for x, y in zip(xs, ys)]
    assert F.to_ints(F.add(a, b)) == [(x + y) % R for x, y in zip(xs, ys)]
    assert F.to_ints(F.sub(a, b)) == [(x - y) % R for x, y in zip(xs, ys)]
    assert F.to_ints(F.scale(a, 5)) == [5 * x % R for x in xs]
    assert F.dot(a, b) == sum(x * y for x, y in zip(xs, ys)) % R
    assert F.sum(a) == sum(xs) % R


def test_field_scans_powers_and_conversions(F):
    rng = random.Random(8)
    xs = _vals(rng, 30)
    acc, pre = 1, []
    for x in xs:
        acc = acc * x % R
        pre.append(acc)
    assert F.to_ints(F.cumprod(F.from_ints(xs))) == pre
    acc, suf = 1, []
    for x in reversed(xs):
        acc = acc * x % R
        suf.append(acc)
    assert F.to_ints(F.cumprod(F.from_ints(xs), reverse=True)) == suf[::-1]
    for count in (1, 2, 37, 300):
        assert F.to_ints(F.powers(11, count)) == [pow(11, i, R) for i in range(count)]
    words = np.array([[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for x in xs], dtype=np.uint32)
    assert F.to_ints(F.from_words(torch.from_numpy(words.view(np.int32)))) == xs
    small = torch.tensor([0, 1, 65535, 12345])
    assert F.to_ints(F.from_small(small)) == [0, 1, 65535, 12345]


@pytest.mark.parametrize("log_n", [1, 3, 5])
def test_ntt_matches_the_sums(F, log_n):
    n = 1 << log_n
    w = curve.root_of_unity(n)
    assert pow(w, n, R) == 1 and (n == 1 or pow(w, n // 2, R) != 1)
    rng = random.Random(log_n)
    v = [rng.randrange(R) for _ in range(n)]
    want = [sum(v[j] * pow(w, i * j, R) for j in range(n)) % R for i in range(n)]
    got = F.ntt(F.from_ints(v), w)
    assert F.to_ints(got) == want
    assert F.to_ints(F.intt(got, w)) == v


def test_curve_matches_the_program_host_curve():
    from zktpu_torch.curves.host_curve import G1Affine

    g = G1Affine.generator()
    assert (g.x, g.y) == curve.G1
    rng = random.Random(3)
    for k in [0, 1, 2, 3, R - 1, R, rng.randrange(R), rng.randrange(1 << 64)]:
        want = g.mul(k)
        got = curve.mul(k)
        assert got == (None if want.infinity else (want.x, want.y))
    assert curve.mul(5, curve.mul(7)) == curve.mul(35)
    x, y = curve.mul(rng.randrange(R))
    assert (y * y - x ** 3 - 4) % Q == 0


def test_transcript_matches_the_program():
    from zktpu_torch.curves.host_curve import G1Affine
    from zktpu_torch.fields.host import FR
    from zktpu_torch.transcript import ark_rand, chacha, serialize
    from zktpu_torch.transcript.transcripts import PlonkChallengeGenerator

    for seed in (0, 1, 2 ** 63 + 5, 2 ** 64 - 1):
        a, b = StdRng(seed), chacha.StdRng.from_seed_u64(seed)
        assert [a.next_u64() for _ in range(40)] == [b.next_u64() for _ in range(40)]
        a, b = StdRng(seed), chacha.StdRng.from_seed_u64(seed)
        assert [fp_rand(a) for _ in range(5)] == [ark_rand.fp_rand(FR, b) for _ in range(5)]
    g = G1Affine.generator()
    for k in (0, 1, 9, R - 9):
        p = g.mul(k)
        assert g1_bytes(curve.mul(k)) == serialize.g1_uncompressed(p.x, p.y, p.infinity)
    mine, theirs = Transcript(), PlonkChallengeGenerator()
    for k in (3, 0, 77):
        mine.feed(curve.mul(k))
        theirs.feed(g.mul(k))
        assert mine.challenges(2) == theirs.generate_challenges(2)


def _program_proof(log_n, secret, witness_seed, blind_seed):
    from zktpu_torch.kzg.srs import Srs
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.plonk.synthetic import synthetic_mul_chain
    from zktpu_torch.transcript.chacha import StdRng as ProgramRng

    circuit = synthetic_mul_chain(log_n, witness_seed, device="cpu")
    srs = Srs.new_from_secret(secret, circuit.size, device="cpu")
    return generate_proof(circuit, srs, ProgramRng.from_seed_u64(blind_seed))


def test_plonk_reference_equals_the_program_proof():
    from zkbench.drivers.plonk_mulchain import proof_fields

    secret, wseed, bseed = 0x1234_5678_9ABC_DEF0_1111, 2 ** 40 + 3, 2 ** 63 + 11
    want = proof_fields(_program_proof(3, secret, wseed, bseed))
    ref = MulChainReference(3, secret, "cpu")
    assert ref.prove(wseed, bseed) == want
    assert MulChainReference(3, secret, "cpu", scalar_bits=128).prove(wseed, bseed)["commitments"]["a"] \
        != want["commitments"]["a"]


def test_kzg_reference_equals_the_program():
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FR
    from zktpu_torch.kzg.scheme import KzgScheme
    from zktpu_torch.kzg.srs import Srs
    from zktpu_torch.poly.poly import Poly

    n, secret = 40, 987654321987654321
    rng = random.Random(5)
    vals = [rng.randrange(1 << 254) for _ in range(n)]
    words = torch.from_numpy(np.array([[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for x in vals],
                                      dtype=np.uint32).view(np.int32))
    scheme = KzgScheme(Srs.new_from_secret(secret, n, device="cpu"))
    poly = Poly(FR, field(FR, "cpu").to_mont(words))
    ref = KzgReference(secret, n, "cpu")
    coeffs = ref.poly(0, words)
    for z in (3, rng.randrange(R)):
        c, op = scheme.commit(poly), scheme.open(poly, z)
        got = ref.commit_open(0, coeffs, z)
        assert got["commitment"] == (c.point.x, c.point.y)
        assert got["witness"] == (op.point.x, op.point.y)
        assert got["evaluation"] == op.evaluation == sum(v * pow(z, i, R) for i, v in enumerate(vals)) % R
