"""The port's checkpoints (zktpu_torch/compat/) against zktpu's, both ways,
through files zktpu wrote (tests/goldens/compat_*, written by
tests/goldens/make_goldens.py compat)."""

import os

import numpy as np
import pytest
import torch

from zktpu_torch.compat import (
    load_fri_proof,
    load_ivc_state,
    load_plonk_proof,
    load_srs,
    save_fri_proof,
    save_ivc_state,
    save_plonk_proof,
    save_srs,
)
from zktpu_torch.fields.host import GOLDILOCKS
from zktpu_torch.kzg import KzgScheme, Srs

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

SRS_SECRET, SRS_CIRCUIT_SIZE = 777, 13  # a 16-point SRS
PLONK_EQ, PLONK_WITNESSES, PLONK_SECRET, PLONK_SEED = "x*y+3*x^2+x*y*z=11", {"x": 1, "y": 2, "z": 3}, 999, 2
FRI_COEFFS, FRI_BLOWUP, FRI_QUERIES = [1, 2, 3, 4, 5, 6], 2, 2
IVC_INPUTS, IVC_SECRET, IVC_STEPS = [3, 4, 1, 2], 424242, 2
HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
CPU = "cpu"


def _golden(name: str) -> str:
    return os.path.join(HERE, f"compat_{name}")


def _text(path: str) -> str:
    with open(path) as f:
        return f.read()


def test_srs_both_ways(tmp_path):
    """zktpu's file loads as the port's own SRS of the same secret; the port's
    file holds zktpu's arrays under zktpu's keys."""
    ours = Srs.new_from_secret(SRS_SECRET, SRS_CIRCUIT_SIZE, device=CPU)
    loaded = load_srs(_golden("srs.npz"), device=CPU)
    assert loaded.size == ours.size == SRS_CIRCUIT_SIZE + 3 == 16
    assert all(torch.equal(a, b) for a, b in zip(loaded.g1_proj, ours.g1_proj))
    assert loaded == ours
    path = str(tmp_path / "srs.npz")
    save_srs(path, ours)
    with np.load(path) as got, np.load(_golden("srs.npz")) as want:
        assert sorted(got.files) == sorted(want.files) == ["X", "Y", "Z", "format", "meta_hex"]
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


def test_srs_rejects_unversioned_checkpoint_as_zktpu(tmp_path):
    from zktpu.compat import load_srs as z_load_srs

    path = str(tmp_path / "srs_old.npz")
    with np.load(_golden("srs.npz")) as z:
        data = {k: z[k] for k in z.files if k != "format"}
    np.savez_compressed(path, **data)
    with pytest.raises(ValueError, match="format mismatch") as ours:
        load_srs(path, device=CPU)
    with pytest.raises(ValueError) as theirs:
        z_load_srs(path)
    assert str(ours.value) == str(theirs.value)


def test_plonk_proof_both_ways(tmp_path):
    """zktpu's proof loads, verifies with the port's verifier and is written
    back byte for byte (chip_smoke.py also has a changed proof rejected)."""
    from zktpu_torch.plonk.parser import Parser
    from zktpu_torch.plonk.verifier import verify

    proof = load_plonk_proof(_golden("plonk.json"))
    p = Parser()
    for k, v in PLONK_WITNESSES.items():
        p.add_witness(k, v)
    compiled = p.parse(PLONK_EQ).compile(device=CPU)
    srs = Srs.new_from_secret(PLONK_SECRET, compiled.size, device=CPU)
    verify(compiled, srs, proof)
    path = str(tmp_path / "plonk.json")
    save_plonk_proof(path, proof)
    assert _text(path) == _text(_golden("plonk.json"))


def test_fri_proof_both_ways(tmp_path):
    """The port's own proof of zktpu's polynomial is written as zktpu wrote
    its proof; zktpu's file loads and verifies with the port's verifier."""
    from zktpu_torch.convert import fri_proof_to_ints
    from zktpu_torch.fri.prover import generate_proof
    from zktpu_torch.fri.verifier import verify
    from zktpu_torch.poly.poly import Poly

    ours = generate_proof(Poly.from_ints(GOLDILOCKS, FRI_COEFFS, device=CPU), FRI_BLOWUP, FRI_QUERIES)
    path = str(tmp_path / "fri.json")
    save_fri_proof(path, ours)
    assert _text(path) == _text(_golden("fri.json"))
    loaded = load_fri_proof(_golden("fri.json"))
    verify(loaded)
    assert fri_proof_to_ints(loaded) == fri_proof_to_ints(ours)


def test_ivc_state_both_ways(tmp_path):
    """The port's augmented circuit after two steps of zktpu's IVC is written
    as zktpu wrote its own; zktpu's file loads into an equal circuit."""
    from zktpu_torch.nova.nifs import gen_test_values
    from zktpu_torch.tools import prof_nova

    r1cs, witnesses, xs = gen_test_values(IVC_INPUTS, device=CPU)
    scheme = KzgScheme(Srs.new_from_secret(IVC_SECRET, len(witnesses[0]) + len(xs[0]) + 1, device=CPU))
    run = prof_nova.run_ivc(scheme, r1cs, prof_nova.cubic_circuit(), lambda k: (witnesses[k], xs[k]), IVC_STEPS)
    ours = run["augmented"]
    path = str(tmp_path / "ivc.json")
    save_ivc_state(path, ours)
    assert _text(path) == _text(_golden("ivc.json"))
    loaded = load_ivc_state(_golden("ivc.json"), ours.f_circuit)
    for k in ("i", "z_0", "z_i", "z_i1", "h_i", "h_i1", "trivial_instance"):
        assert getattr(loaded, k) == getattr(ours, k), k
    assert loaded.f_circuit is ours.f_circuit
