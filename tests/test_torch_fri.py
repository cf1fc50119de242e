"""The port's FRI (zktpu_torch/fri/) against zktpu's, exactly, through
committed goldens of zktpu's outputs (tests/goldens/, written by
tests/goldens/make_goldens.py fri fri_cases):

- generate_proof against zktpu.fri.prover.generate_proof through
  fri_proof_to_ints (roots, const_val, every evaluation and auth path), on
  zktpu's own tiers (host NTT, host hashing below 2^12 values), and the
  port's forced tensor path (force_device: the NTT and the vector hash at
  every size, which the card takes) on the same inputs (fri_cases.json,
  zktpu run with its NTT host tier raised to 2^8);
- at a 2^13 domain, where the first two layers take the vector hash,
  against zktpu's proof (fri_2e13.json);
- a coset evaluation and folds word for word, and Merkle trees (every
  level, the root and every proof) over Goldilocks and Fr;
- the verifier's accept and reject cases, mirroring tests/test_fri.py.
"""
import json
import os

import numpy as np
import pytest
import torch

from zktpu_torch.fields.host import FR, GOLDILOCKS
from zktpu_torch.convert import fri_proof_to_ints
from zktpu_torch.fri.merkle import MerkleTree, verify_merkle_proof
from zktpu_torch.fri.prover import fold_polynomial, folding_phase, generate_proof, query_phase
from zktpu_torch.fri.verifier import FriVerificationError, verify
from zktpu_torch.poly.domain import get_domain
from zktpu_torch.poly.poly import Poly

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

GL = GOLDILOCKS
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "goldens", "fri_2e13.json")
CASES_GOLDEN = os.path.join(HERE, "goldens", "fri_cases.json")
# (coefficients, blowup, queries): degree 1-64, domains 2^2-2^8, odd lengths fold with padding
CASES = [(2, 2, 2), (5, 4, 3), (64, 2, 4), (64, 4, 2)]
# the golden proof: 2^12 coefficients from default_rng(GOLDEN_SEED), blowup 2 (a 2^13 domain)
GOLDEN_SEED, GOLDEN_LOG_COEFFS, GOLDEN_QUERIES = 20261017, 12, 2
FOLD_SIZES = [2, 5, 64]
MERKLE_SIZES = [1, 2, 5, 7, 13, 64]
FR_TREE_VALUES = [0, 1, FR.modulus - 1, 12345, 7]


def case_id(case) -> str:
    return f"len{case[0]}-blowup{case[1]}-q{case[2]}"


def _coeffs(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int(v) for v in rng.integers(0, GL.modulus, size=n, dtype=np.uint64)]
    vals[0] = GL.modulus - 1
    return vals


def _poly(coeffs) -> Poly:
    return Poly.from_ints(GL, coeffs, device="cpu")


def golden_coefficients() -> list[int]:
    rng = np.random.default_rng(GOLDEN_SEED)
    return [int(v) for v in rng.integers(0, GL.modulus, size=1 << GOLDEN_LOG_COEFFS, dtype=np.uint64)]


@pytest.fixture(scope="module")
def zk():
    """zktpu's outputs for the cases below (tests/goldens/fri_cases.json)."""
    with open(CASES_GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_proof_matches_zktpu(zk, case):
    n, blowup, queries = case
    proof = generate_proof(_poly(_coeffs(n, n)), blowup, queries)
    assert fri_proof_to_ints(proof) == zk["proofs"][case_id(case)]
    verify(proof)
    if proof.domain_size <= 32:  # the card's path: tensor NTT and vector hash at every size
        forced = generate_proof(_poly(_coeffs(n, n)), blowup, queries, force_device=True)
        assert fri_proof_to_ints(forced) == zk["proofs"][case_id(case)]


def test_coset_evaluations_match_zktpu(zk):
    """A layer's coset evaluations in Montgomery form, word for word: zktpu's
    digit arrays (goldilocks_digits_to_limbs of its host tier's) against the
    port's Goldilocks NTT (the forced tensor transform)."""
    coeffs = _coeffs(64, 64)
    n, coset = 128, GL.generator
    got = get_domain(GL, n, device="cpu").coset_fft(_poly(coeffs)._padded(n), coset, force_device=True)
    np.testing.assert_array_equal(got.numpy(), np.array(zk["coset_fft_128"], dtype=np.int32))


def test_proof_at_2e13_matches_zktpu_golden():
    """2^12 coefficients, blowup 2: layers 0 and 1 hash on the vector path
    (the plain kernel here), the NTT is the plain stage loop at 2^13."""
    with open(GOLDEN) as f:
        want = json.load(f)
    proof = generate_proof(_poly(golden_coefficients()), 2, GOLDEN_QUERIES)
    assert proof.domain_size == 1 << 13
    assert fri_proof_to_ints(proof) == want
    verify(proof)


@pytest.mark.parametrize("coeffs", [[1, 2, 3, 4], [1, 2, 3, 4, 5, 6]])
def test_fri_end_to_end(coeffs):
    verify(generate_proof(_poly(coeffs), blowup_factor=2, number_of_queries=2))


def _tamper_cases():
    def const(p):
        p.const_val = (p.const_val - 1) % GL.modulus

    def evaluation(p):
        d = p.decommitment_list[0]
        d.evaluations[1] = (d.evaluations[1] + 1) % GL.modulus

    def root(p):
        p.layers_root[0] = (p.layers_root[0] + 1) % GL.modulus

    def path(p):
        ap = p.decommitment_list[1].auth_paths[0]
        ap.hash_proof[0] = (ap.hash_proof[0] + 1) % GL.modulus

    def sym_index(p):
        p.decommitment_list[0].sym_auth_paths[1].index ^= 1

    return [const, evaluation, root, path, sym_index]


@pytest.mark.parametrize("tamper", _tamper_cases(), ids=lambda f: f.__name__)
def test_tampered_proof_rejected(tamper):
    proof = generate_proof(_poly([1, 2, 3, 4, 5, 6]), 2, 2)
    verify(proof)
    tamper(proof)
    with pytest.raises(FriVerificationError):
        verify(proof)


def test_fold_and_phase_invariants():
    """prover.rs:170-221: fold [1, 2, 3, 4] by 1, the second layer's coset and
    size, and the symmetric query index."""
    assert fold_polynomial(_poly([1, 2, 3, 4]), 1).to_ints() == [3, 7]
    _c, transcript, layers = folding_phase(_poly([1, 2, 3, 4]), GL.generator, 4, 2)
    assert layers[1].coset == 49 and layers[1].domain_size == 2
    decommitments, _ = query_phase(1, 4, transcript, layers)
    d = decommitments[0]
    assert (d.auth_paths[0].index + 2) % 4 == d.sym_auth_paths[0].index


def fold_inputs(n: int):
    """(coefficients, r) of the fold case of length n."""
    return _coeffs(n, 500 + n), int(np.random.default_rng(n).integers(0, GL.modulus, dtype=np.uint64))


@pytest.mark.parametrize("n", FOLD_SIZES)
def test_fold_plain_matches_zktpu_fold(zk, n):
    """The fold kernel's plain version against zktpu's fold_polynomial, word
    for word (Montgomery limbs): an even length, an odd one (the last odd
    term 0) and two coefficients."""
    from zktpu_torch.fri.fold_kernel import fold_plain

    coeffs, r = fold_inputs(n)
    want = zk["folds"][str(n)]
    got = fold_plain(GL, _poly(coeffs).coeffs, r)
    np.testing.assert_array_equal(got.numpy(), np.array(want["limbs"], dtype=np.int32))
    assert fold_polynomial(_poly(coeffs), r).to_ints() == want["ints"]


@pytest.mark.parametrize("n,force", [(8, True), (128, True), (128, False)])
def test_layer_evaluations_fused_from_mont(n, force):
    """FriLayer's evaluations, the coset NTT with the raw 1 as its output
    factor, equal what the layer made before (the coset NTT's Montgomery
    words, then from_mont) and the host's p(coset w^i), on the forced tensor
    path and on zktpu's host tier."""
    from zktpu_torch.fri.layer import FriLayer

    coeffs = _coeffs(n // 2, 600 + n)
    poly = _poly(coeffs)
    coset = GL.generator
    layer = FriLayer.from_poly(poly, coset, n, force_device=force)
    dom = get_domain(GL, n, device="cpu")
    before = poly.df.from_mont(dom.coset_fft(poly._padded(n), coset, force_device=force))
    assert torch.equal(layer.evaluations, before)
    w, p = dom.group_gen, GL.modulus
    host = [sum(c * pow(coset * pow(w, i, p) % p, k, p) for k, c in enumerate(coeffs)) % p for i in range(4)]
    assert layer.evaluations[:4].numpy().view(np.uint64)[:, 0].tolist() == host


@pytest.mark.parametrize("n", MERKLE_SIZES)
def test_merkle_tree_matches_zktpu(zk, n):
    """Odd lengths (a trailing singleton on several levels), one leaf, and a
    power of two: every level, the padded leaves, the root and every proof,
    on the host tier and on the forced vector path; out-of-range neighbours
    raise IndexError as zktpu's do."""
    vals = _coeffs(n, 100 + n)
    want = zk["merkle"][str(n)]
    for force in (False, True):
        tree = MerkleTree(torch.from_numpy(np.array(vals, dtype=np.uint64).view(np.int32).reshape(n, 2)), GL,
                          force_device=force)
        assert tree.internal_nodes == want["internal_nodes"] and tree.root() == want["root"]
        assert tree.leaves == want["leaves"] and tree.depth == want["depth"]
        for i, w in enumerate(want["proofs"]):
            if w is None:
                with pytest.raises(IndexError):
                    tree.generate_proof(i)
                continue
            got = tree.generate_proof(i)
            assert [got.index, got.leaf_val, got.hash_proof, got.root] == w
            assert verify_merkle_proof(got) == (i < n)  # a padding leaf was never hashed
    # from_levels: the same tree from its levels, as ints and as tensors
    forced = MerkleTree(vals, GL, force_device=True, device="cpu")
    for levels in (want["internal_nodes"], forced.levels):
        rebuilt = MerkleTree.from_levels(vals, levels, GL)
        assert rebuilt.root() == want["root"] and rebuilt.internal_nodes == want["internal_nodes"]


def test_merkle_roundtrip_and_other_fields(zk):
    """merkle_tree.rs:134-152, and a tree over Fr (host hashing, as zktpu)."""
    tree = MerkleTree([1, 2, 3, 4], GL)
    proof = tree.generate_proof(1)
    assert verify_merkle_proof(proof)
    proof.index = 2
    assert not verify_merkle_proof(proof)
    ours = MerkleTree(FR_TREE_VALUES, FR, force_device=True)  # hashes on the host: no device needed
    want = zk["merkle_fr"]
    assert ours.internal_nodes == want["internal_nodes"] and ours.root() == want["root"]
