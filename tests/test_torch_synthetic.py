"""The synthetic multiplication-chain circuit (the circuit chip_smoke proves at
2^14 gates) at small sizes: equal to zktpu's, proves, verifies, and a bad
witness raises through the coset quotient."""
import numpy as np
import pytest
import torch

from zktpu.plonk.synthetic import synthetic_mul_chain as zktpu_synthetic
from zktpu.transcript.chacha import StdRng
from zktpu_torch.convert import limbs_to_digits
from zktpu_torch.kzg import Srs
from zktpu_torch.plonk.prover import compute_acc, generate_proof
from zktpu_torch.plonk.synthetic import synthetic_mul_chain
from zktpu_torch.plonk.verifier import verify
from zktpu_torch.poly.domain import get_domain
from zktpu_torch.poly.poly import poly_from_evals

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

_POLYS = ("f_ax", "f_bx", "f_cx", "q_lx", "q_rx", "q_ox", "q_mx", "q_cx", "pi_x")


@pytest.fixture(scope="module")
def zktpu_circuit():
    return zktpu_synthetic(4, seed=3)


def test_synthetic_circuit_matches_zktpu(zktpu_circuit):
    want = zktpu_circuit
    got = synthetic_mul_chain(4, seed=3, device="cpu")
    assert got.size == want.size == 16
    for name in _POLYS:
        a, b = getattr(got.gate_constraints, name), getattr(want.gate_constraints, name)
        np.testing.assert_array_equal(limbs_to_digits(a.coeffs.numpy()), np.asarray(b.coeffs), err_msg=name)
    for name in ("s_sigma_1", "s_sigma_2", "s_sigma_3"):
        a, b = getattr(got.copy_constraints, name), getattr(want.copy_constraints, name)
        np.testing.assert_array_equal(limbs_to_digits(a.coeffs.numpy()), np.asarray(b.coeffs), err_msg=name)
    for key in ("a", "b", "c", "qm", "qo"):
        np.testing.assert_array_equal(
            limbs_to_digits(got.gate_constraints.evals[key].numpy()),
            np.asarray(want.gate_constraints.evals[key]),
            err_msg=key,
        )


def test_grand_product_matches_zktpu(zktpu_circuit):
    from zktpu.plonk.prover import compute_acc as zktpu_compute_acc
    from zktpu.poly.domain import get_domain as zktpu_domain

    circuit = synthetic_mul_chain(4, seed=3, device="cpu")
    dom = get_domain(circuit.gate_constraints.f_ax.spec, circuit.size, device="cpu")
    got = compute_acc(12345, 678, dom, circuit)
    want = zktpu_compute_acc(12345, 678, zktpu_domain(dom.spec, circuit.size), zktpu_circuit)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(limbs_to_digits(a.coeffs.numpy()), np.asarray(b.coeffs))
    assert got[0].evaluate(1) == 1  # z(w^0) = 1


def test_synthetic_prove_verify_32_gates():
    circuit = synthetic_mul_chain(5, seed=3, device="cpu")
    srs = Srs.new_from_secret(0x5EED5EED, circuit.size, device="cpu")
    timings = {}
    proof = generate_proof(circuit, srs, StdRng.from_seed_u64(42), timings=timings, force="coset")
    verify(circuit, srs, proof)
    assert {f"round{i}" for i in range(1, 6)} <= set(timings)
    assert {"round1.commits", "round3.quotient", "round5.witness_polys"} <= set(timings)


def test_synthetic_bad_witness_raises_on_coset_path():
    circuit = synthetic_mul_chain(3, seed=3, device="cpu")
    gc = circuit.gate_constraints
    a_e = gc.evals["a"].clone()
    a_e[5] = a_e[6]  # another field element: a_5 b_5 != c_5
    gc.evals["a"] = a_e
    gc.f_ax = poly_from_evals(get_domain(gc.f_ax.spec, circuit.size, device="cpu"), a_e)
    srs = Srs.new_from_secret(7, circuit.size, device="cpu")
    with pytest.raises(AssertionError, match="has remainder"):
        generate_proof(circuit, srs, StdRng.from_seed_u64(7), force="coset")
