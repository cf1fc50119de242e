"""The whole slice: zktpu_torch PLONK proofs equal zktpu's, field by field.

For a fixed SRS secret and a seeded StdRng the port's Proof must equal
zktpu.plonk.prover.generate_proof's, read from a committed golden
(tests/goldens/plonk_pythagorean.{json,npz}, written by
tests/goldens/make_goldens.py plonk) with zktpu's SRS points and arrays.
zktpu's SRS is built from host points (no fixed-base compile); the port
builds its own with fixed_base_mul_u32.  The Pythagorean circuit is also
proved with every tensor path forced (thresholds 0, coset quotient), on
both quotient paths.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import zktpu_torch.config as cfg
from zktpu.curves import g1 as zg1
from zktpu.curves.host_curve import G1Affine, G2Affine
from zktpu.fields.host import FR
from zktpu.kzg.srs import Srs as ZSrs
from zktpu.transcript.chacha import StdRng
from zktpu_torch.convert import circuit_from_numpy, srs_from_numpy
from zktpu_torch.curves import host_curve as th
from zktpu_torch.kzg import Srs
from zktpu_torch.kzg.scheme import KzgCommitment
from zktpu_torch.plonk.circuit import Circuit
from zktpu_torch.plonk.prover import Proof, generate_proof
from zktpu_torch.plonk.verifier import PlonkVerificationError, verify

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

SECRET = 1234567
SEED = 42
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "plonk_pythagorean")
GATE_POLYS = ("f_ax", "f_bx", "f_cx", "q_lx", "q_rx", "q_ox", "q_mx", "q_cx", "pi_x")
COPY_POLYS = ("s_sigma_1", "s_sigma_2", "s_sigma_3")


def pythagorean(cls, c_val=25):
    # x^2 + y^2 = z^2 with (3, 4, 5)
    circuit = cls()
    circuit.add_multiplication_gate((1, 0, 3), (0, 0, 3), (0, 3, 9), 0)
    circuit.add_multiplication_gate((1, 1, 4), (0, 1, 4), (1, 3, 16), 0)
    circuit.add_multiplication_gate((1, 2, 5), (0, 2, 5), (2, 3, c_val), 0)
    circuit.add_addition_gate((2, 0, 9), (2, 1, 16), (2, 2, c_val), 0)
    return circuit


def zktpu_srs(secret, circuit_size):
    n = circuit_size + 3
    G = G1Affine.generator()
    pts = [G.mul(pow(secret, i, FR.modulus)) for i in range(n)]
    g2 = G2Affine.generator()
    return ZSrs(zg1.host_points_to_device(pts), g2, g2.mul(secret), n, secret)


def assert_same_proof(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if hasattr(b, "point"):
            assert a.point == b.point, f.name
        else:
            assert a == b, f.name


def _g2(coords) -> th.G2Affine:
    return th.G2Affine(th.Fq2(*coords[:2]), th.Fq2(*coords[2:]))


@pytest.fixture(scope="module")
def reference():
    """zktpu's side from the golden: (its values, its arrays, its proof)."""
    with open(GOLDEN + ".json") as f:
        g = json.load(f)
    with np.load(GOLDEN + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    proof = Proof(**{k: KzgCommitment(th.G1Affine(*v)) if isinstance(v, list) else v for k, v in g["proof"].items()})
    return g, arrays, proof


def test_forced_tensor_paths_match_zktpu(reference, monkeypatch):
    for name in ("HOST_MSM_MAX", "HOST_NTT_MAX", "HOST_POLY_MAX"):
        monkeypatch.setattr(cfg, name, 0)
    compiled = pythagorean(Circuit).compile(device="cpu")
    srs = Srs.new_from_secret(SECRET, compiled.size, device="cpu")
    assert srs.g1_points_host() == [th.G1Affine(*p) for p in reference[0]["srs_points"]]
    proof = generate_proof(compiled, srs, StdRng.from_seed_u64(SEED), force="coset")
    assert_same_proof(proof, reference[2])
    verify(compiled, srs, proof)


@pytest.fixture(scope="module")
def port_setup():
    compiled = pythagorean(Circuit).compile(device="cpu")
    return compiled, Srs.new_from_secret(SECRET, compiled.size, device="cpu")


@pytest.mark.parametrize("quotient", ["coeff", "coset_8n", "coset_4n"])
def test_default_tiers_match_zktpu_on_each_quotient_path(reference, port_setup, quotient, monkeypatch):
    if quotient == "coset_4n":
        monkeypatch.setattr(cfg, "QUOTIENT_8N_MAX_N", 4)
    compiled, srs = port_setup
    timings = {}
    force = "coeff" if quotient == "coeff" else "coset"
    proof = generate_proof(compiled, srs, StdRng.from_seed_u64(SEED), timings=timings, force=force)
    assert_same_proof(proof, reference[2])
    verify(compiled, srs, proof)
    assert {f"round{i}" for i in range(1, 6)} <= set(timings)
    assert all(v >= 0 for v in timings.values())


def test_carried_across_circuit_and_srs_match_zktpu(reference):
    g, arrays, want = reference
    coeffs = {name: arrays[f"coeffs/{name}"] for name in GATE_POLYS + COPY_POLYS}
    evals = {k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith("evals/")}
    compiled = circuit_from_numpy(g["size"], coeffs, evals, g["k1"], g["k2"], "cpu")
    srs = srs_from_numpy([arrays[f"g1_proj/{i}"] for i in range(3)], _g2(g["g2"]), _g2(g["g2s"]), g["srs_size"], "cpu")
    proof = generate_proof(compiled, srs, StdRng.from_seed_u64(SEED))
    assert_same_proof(proof, want)
    verify(compiled, srs, proof)


def test_tampered_proof_rejected(port_setup):
    compiled, srs = port_setup
    proof = generate_proof(compiled, srs, StdRng.from_seed_u64(3))
    proof.bar_a = FR.add(proof.bar_a, 1)
    with pytest.raises(PlonkVerificationError):
        verify(compiled, srs, proof)


@pytest.mark.parametrize("quotient", ["coeff", "coset_8n", "coset_4n"])
def test_bad_witness_raises(quotient, monkeypatch):
    if quotient == "coset_4n":
        monkeypatch.setattr(cfg, "QUOTIENT_8N_MAX_N", 4)
    compiled = pythagorean(Circuit, c_val=20).compile(device="cpu")
    srs = Srs.new_from_secret(999, compiled.size, device="cpu")
    force = "coeff" if quotient == "coeff" else "coset"
    with pytest.raises(AssertionError):
        generate_proof(compiled, srs, StdRng.from_seed_u64(1), force=force)
