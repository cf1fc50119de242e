"""The port's own host layer against zktpu's: the same constants, the same
StdRng stream, the same transcript challenges, pairings, gates, field hash
and size tiers.

zktpu_torch keeps copies of zktpu's pure-Python host modules (fields/host.py,
curves/host_curve.py, curves/pairing.py with its C++ library,
transcript/*.py, plonk/gate.py, hash/host_hash.py) so that it imports nothing
of zktpu; these tests hold each copy to the original.  All comparisons are
exact.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zktpu.curves import host_curve as z_curve
from zktpu.curves import pairing as z_pairing
from zktpu.fields import host as z_host
from zktpu.hash import host_hash as z_hash
from zktpu.plonk import gate as z_gate
from zktpu.transcript import ark_rand as z_rand
from zktpu.transcript import chacha as z_chacha
from zktpu.transcript import serialize as z_ser
from zktpu.transcript import transcripts as z_tr
from zktpu_torch.curves import host_curve, native_pairing, pairing
from zktpu_torch.fields import host
from zktpu_torch.hash import host_hash
from zktpu_torch.plonk import gate
from zktpu_torch.transcript import ark_rand, chacha, serialize, transcripts

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

R = host.FR.modulus
SCALARS = [0, 1, 2, 7, R - 1, 2**200 + 3, 0xDEADBEEF << 96]


def _g1(p):
    return (p.x, p.y, p.infinity)


def _g2(q):
    return (q.x.c0, q.x.c1, q.y.c0, q.y.c1, q.infinity)


def _fq12(f):
    return [c for f6 in (f.c0, f.c1) for f2 in (f6.c0, f6.c1, f6.c2) for c in (f2.c0, f2.c1)]


@pytest.mark.parametrize("name", ["FR", "FQ", "GOLDILOCKS"])
def test_field_spec_constants(name):
    ours, theirs = getattr(host, name), getattr(z_host, name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for attr in ("mont_r", "mont_r2", "mont_pinv_digit", "mont_pinv_full", "num_bits", "two_adic_root"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.root_of_unity(2) == theirs.root_of_unity(2)
    assert ours.to_mont(12345) == theirs.to_mont(12345)
    constants = sorted(k for k, v in vars(z_host).items() if k.isupper() and isinstance(v, int))
    assert constants and all(getattr(host, k) == getattr(z_host, k) for k in constants)


def test_g1_and_g2_ops():
    G, zG = host_curve.G1Affine.generator(), z_curve.G1Affine.generator()
    H, zH = host_curve.G2Affine.generator(), z_curve.G2Affine.generator()
    for k in SCALARS:
        a, za = G.mul(k), zG.mul(k)
        assert _g1(a) == _g1(za) and _g1(a + G) == _g1(za + zG) and _g1(-a) == _g1(-za)
        assert serialize.g1_uncompressed(*_g1(a)) == z_ser.g1_uncompressed(*_g1(za))
    for k in SCALARS[:5]:
        b, zb = H.mul(k), zH.mul(k)
        assert _g2(b) == _g2(zb) and _g2(b + H) == _g2(zb + zH)


def test_std_rng_and_fp_rand():
    for seed in (0, 42, 2**63 + 5):
        ours, theirs = chacha.StdRng.from_seed_u64(seed), z_chacha.StdRng.from_seed_u64(seed)
        assert [ours.next_u64() for _ in range(64)] == [theirs.next_u64() for _ in range(64)]
    for spec, zspec in ((host.FR, z_host.FR), (host.FQ, z_host.FQ)):
        ours, theirs = chacha.StdRng.from_seed_u64(7), z_chacha.StdRng.from_seed_u64(7)
        assert [ark_rand.fp_rand(spec, ours) for _ in range(64)] == [z_rand.fp_rand(zspec, theirs) for _ in range(64)]


def test_plonk_transcript_challenges():
    pts = [host_curve.G1Affine.generator().mul(k) for k in (3, 5, 0)]
    zpts = [z_curve.G1Affine.generator().mul(k) for k in (3, 5, 0)]
    ours = transcripts.PlonkChallengeGenerator.from_commitments(pts)
    theirs = z_tr.PlonkChallengeGenerator.from_commitments(zpts)
    assert ours.generate_challenges(3) == theirs.generate_challenges(3)
    ours.feed(pts[1])
    theirs.feed(zpts[1])
    assert ours.generate_challenge() == theirs.generate_challenge()


def test_two_pair_pairing_product():
    G, H = host_curve.G1Affine.generator(), host_curve.G2Affine.generator()
    zG, zH = z_curve.G1Affine.generator(), z_curve.G2Affine.generator()
    rng = np.random.default_rng(9)
    a, b = (int(v) for v in rng.integers(1, 1 << 62, size=2))
    got = pairing.pairing_product([(G.mul(a), H.mul(b)), (G.mul(b), H)])
    want = z_pairing.pairing_product([(zG.mul(a), zH.mul(b)), (zG.mul(b), zH)])
    assert _fq12(got) == _fq12(want)
    assert pairing.pairing_product([(G.mul(a), H.mul(b)), (-G.mul(a * b), H)]) == pairing.Fq12.one()
    assert native_pairing.library_path().startswith(str(native_pairing._BUILD_DIR))


def test_gate():
    cases = [
        ("new_add_gate", ((0, 1), (1, 1), (2, 1)), {"pi": 5}),
        ("new_mul_gate", ((0, 0), (1, 0), (2, 0)), {}),
        ("new_constant_gate", ((0, 2), None, (2, 2), 9), {"pi": R - 1}),
    ]
    for ctor, args, kw in cases:
        ours, theirs = getattr(gate.Gate, ctor)(*args, **kw), getattr(z_gate.Gate, ctor)(*args, **kw)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.is_dummy() == theirs.is_dummy() is False
    assert dataclasses.asdict(gate.Gate.new_dummy_gate()) == dataclasses.asdict(z_gate.Gate.new_dummy_gate())


def test_host_hash():
    """hash(x) and hash_slice(xs) over Goldilocks and Fr, values reduced mod p."""
    for name in ("GOLDILOCKS", "FR"):
        ours, theirs = getattr(host, name), getattr(z_host, name)
        p = ours.modulus
        vals = [0, 1, 9, 10, p - 1, p, p + 5, 10**19, 2**64 - 1]
        assert [host_hash.hash_elem(ours, v) for v in vals] == [z_hash.hash_elem(theirs, v) for v in vals]
        for xs in ([], [7], vals[:2], vals[3:6]):
            assert host_hash.hash_slice(ours, xs) == z_hash.hash_slice(theirs, xs)


_TIERS = ("HOST_MSM_MAX", "HOST_MSM_SRS_MAX", "HOST_NTT_MAX", "HOST_POLY_MAX", "QUOTIENT_8N_MAX_N")
_READ_TIERS = f"""
import zktpu.config as a, zktpu_torch.config as b
print([(getattr(a, k), getattr(b, k)) for k in {_TIERS!r}])
"""


def test_config_reads_the_same_environment_overrides():
    """Each ZKTPU_* tier override, set in a subprocess, gives both packages
    the same value; unset, both keep the same defaults."""
    import zktpu.config as z_config
    from zktpu_torch import config

    assert [getattr(config, k) for k in _TIERS] == [getattr(z_config, k) for k in _TIERS]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    env.update({f"ZKTPU_{k}": str(17 + i) for i, k in enumerate(_TIERS)})
    out = subprocess.run([sys.executable, "-c", _READ_TIERS], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str([(17 + i, 17 + i) for i in range(len(_TIERS))])
