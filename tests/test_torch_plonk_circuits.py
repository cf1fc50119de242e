"""zktpu_torch PLONK on the reference's other test circuits (xyz = 6 and the
example circuit xy + 3x^2 + xyz = 11): proofs equal zktpu's and verify."""
import pytest
import torch

from zktpu.plonk.circuit import Circuit as ZCircuit
from zktpu.plonk.prover import generate_proof as zktpu_generate_proof
from zktpu.transcript.chacha import StdRng
from zktpu_torch.kzg import Srs
from zktpu_torch.plonk.circuit import Circuit
from zktpu_torch.plonk.prover import generate_proof
from zktpu_torch.plonk.verifier import verify

from test_torch_plonk import assert_same_proof, zktpu_srs

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it


def xyz6(cls):
    circuit = cls()
    circuit.add_multiplication_gate((0, 0, 1), (1, 0, 2), (0, 1, 2), 0)
    circuit.add_multiplication_gate((2, 0, 2), (1, 1, 3), (2, 1, 6), 0)
    return circuit


def example(cls):
    circuit = cls()
    circuit.add_multiplication_gate((0, 1, 1), (1, 0, 2), (0, 3, 2), 0)
    circuit.add_multiplication_gate((1, 1, 1), (0, 0, 1), (0, 2, 1), 0)
    circuit.add_multiplication_gate((2, 1, 1), (2, 6, 3), (1, 3, 3), 0)
    circuit.add_addition_gate((0, 4, 2), (2, 2, 3), (0, 5, 5), 0)
    circuit.add_multiplication_gate((2, 0, 2), (1, 4, 3), (1, 5, 6), 0)
    circuit.add_addition_gate((2, 3, 5), (2, 4, 6), (2, 5, 11), 0)
    circuit.add_constant_gate((0, 6, 3), (1, 6, 0), (1, 2, 3), 0)
    return circuit


@pytest.mark.parametrize("build, secret, seed", [(xyz6, 55, 11), (example, 777, 13)], ids=["xyz6", "example"])
def test_proof_matches_zktpu_and_verifies(build, secret, seed):
    zc = build(ZCircuit).compile()
    want = zktpu_generate_proof(zc, zktpu_srs(secret, zc.size), StdRng.from_seed_u64(seed))
    compiled = build(Circuit).compile(device="cpu")
    srs = Srs.new_from_secret(secret, compiled.size, device="cpu")
    proof = generate_proof(compiled, srs, StdRng.from_seed_u64(seed))
    assert_same_proof(proof, want)
    verify(compiled, srs, proof)
