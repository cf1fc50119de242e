"""The port's Nova (zktpu_torch/nova/) against zktpu's, exactly, through
committed goldens (tests/goldens/nova.json and nova.npz, written by
tests/goldens/make_goldens.py nova):

- zktpu's 4-step IVC (inputs 3, 4, 1, 2 on the x^3 + x + 5 R1CS, SRS secret
  424242) step by step: every hash, com_T, r, new and folded instance and
  NIFS opening, and the states; the opening of an all-zero E (the zero
  polynomial: the identity and 0);
- matrix_vector_product, compute_t and fold_witness on an 8-squaring chain
  (zktpu_torch.tools.prof_nova's R1CS) with operands from numpy's
  default_rng, word for word;
- matrix_vector_product on a (16, 67) matrix of random entries
  (tests/goldens/nova_matvec.npz, make_goldens.py matvec), which the chain's
  0/1 matrices cannot exercise: the port's on the CPU and the host build of
  the matvec kernel (tests/matvec_host.cpp);
- the cases of tests/test_nova.py: satisfaction, a tampered witness
  rejected, folding keeps satisfaction, a one-fold round trip with a
  tampered r rejected, wrong IO rejected;
- the Nova converters of zktpu_torch/convert.py on zktpu's digit arrays.
"""
import json
import os

import numpy as np
import pytest
import torch

from zktpu_torch import convert
from zktpu_torch.fields.host import FQ, FR
from zktpu_torch.kzg import KzgScheme, Srs
from zktpu_torch.nova.circuit import AugmentedCircuit, State
from zktpu_torch.nova.nifs import NIFS, NIFSProof, gen_test_values
from zktpu_torch.nova.r1cs import FWitness, NovaError, create_trivial_pair, is_r1cs_satisfied
from zktpu_torch.nova.utils import matrix_vector_product, to_f_vec, vec_equal
from zktpu_torch.tools import prof_nova
from zktpu_torch.transcript.transcripts import NovaTranscript

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
INPUTS = [3, 4, 1, 2]
SRS_SECRET = 424242
ZERO_E_R = 5  # NIFS.prove's r over a fresh witness, whose E is all zero
CHAIN_LOG_M = 3
CHAIN_SEED = 20261017
MATVEC_SHAPE = (16, 67)
MATVEC_SEED = 20261018
CPU = "cpu"


def chain_rows(log_m: int):
    """The squaring chain's A, B, C as rows of ints (m rows, m + 3 columns)."""
    m = 1 << log_m
    rows = [[[0] * (m + 3) for _ in range(m)] for _ in range(3)]
    for k in range(m):
        rows[0][k][k] = rows[1][k][k] = rows[2][k][k + 1] = 1
    return rows


def chain_operands() -> dict:
    """compute_t's and fold_witness's operands on the chain, from default_rng(CHAIN_SEED)."""
    m = 1 << CHAIN_LOG_M
    rng = np.random.default_rng(CHAIN_SEED)

    def vec(n):
        words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR.modulus for row in words]

    out = {k: vec(m + 3) for k in ("z1", "z2")}
    out.update({k: vec(m) for k in ("e1", "e2")})
    out.update({k: vec(m + 1) for k in ("w1", "w2")})
    out.update(zip(("u1", "u2", "r"), vec(3)))
    return out


def matvec_operands() -> tuple[list[list[int]], list[int]]:
    """The matvec golden's matrix rows and z: canonical ints from
    default_rng(MATVEC_SEED), with 0, 1 and p - 1 at the front of each."""
    m, n = MATVEC_SHAPE
    rng = np.random.default_rng(MATVEC_SEED)
    p = FR.modulus

    def vals(count):
        words = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
        return [0, 1, p - 1] + [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words[3:]]

    flat = vals(m * n)
    return [flat[i * n : (i + 1) * n] for i in range(m)], vals(n)


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(HERE, "nova.json")) as f:
        js = json.load(f)
    return js, dict(np.load(os.path.join(HERE, "nova.npz")))


@pytest.fixture(scope="module")
def setup():
    r1cs, witnesses, x = gen_test_values(INPUTS, device=CPU)
    scheme = KzgScheme(Srs.new_from_secret(SRS_SECRET, len(witnesses[0]) + len(x[0]) + 1, device=CPU))
    m = r1cs.matrix_a.shape[0]
    w = [FWitness.new(wi, m, CPU) for wi in witnesses]
    u = [wi.commit(scheme, xi) for wi, xi in zip(w, x)]
    return r1cs, witnesses, x, scheme, w, u


def _json(obj):
    return json.loads(json.dumps(obj))


def test_ivc_four_steps_matches_zktpu(setup, golden):
    r1cs, witnesses, x, scheme, _, _ = setup
    run = prof_nova.run_ivc(scheme, r1cs, prof_nova.cubic_circuit(), lambda s: (witnesses[s], x[s]), len(INPUTS), CPU)
    js, _ = golden
    assert _json(run["records"]) == js["records"]
    assert run["states"][:-1] == js["states"][: len(INPUTS)]
    assert run["states"][-1] == js["states"][len(INPUTS)]
    assert run["records"][0]["u0"]["com_e"] == [0, 0, True]  # an all-zero E commits to the identity


def test_opening_of_an_all_zero_e(setup, golden):
    _, _, _, scheme, w, u = setup
    proof = NIFS.prove(ZERO_E_R, w[0], u[0], scheme, NovaTranscript())
    got = {"opening_point": proof.opening_point,
           "opening_e": [proof.opening_e.point.x, proof.opening_e.point.y, proof.opening_e.point.infinity,
                         proof.opening_e.evaluation],
           "opening_w": [proof.opening_w.point.x, proof.opening_w.point.y, proof.opening_w.point.infinity,
                         proof.opening_w.evaluation]}
    assert got == golden[0]["zero_e"]
    assert got["opening_e"] == [0, 0, True, 0]


def test_chain_products_match_zktpu(golden):
    _, arrays = golden
    r1cs = prof_nova.chain_r1cs(CHAIN_LOG_M, CPU)
    assert torch.equal(r1cs.matrix_a, torch.from_numpy(arrays["chain_a"]))
    ops = chain_operands()
    z1, z2 = to_f_vec(ops["z1"], CPU), to_f_vec(ops["z2"], CPU)
    np.testing.assert_array_equal(matrix_vector_product(r1cs.matrix_a, z1).numpy(), arrays["chain_az1"])
    np.testing.assert_array_equal(matrix_vector_product(r1cs.matrix_c, z2).numpy(), arrays["chain_cz2"])
    t = NIFS.compute_t(r1cs, ops["u1"], ops["u2"], z1, z2)
    np.testing.assert_array_equal(t.numpy(), arrays["chain_t"])
    f1 = FWitness(e=to_f_vec(ops["e1"], CPU), w=to_f_vec(ops["w1"], CPU))
    f2 = FWitness(e=to_f_vec(ops["e2"], CPU), w=to_f_vec(ops["w2"], CPU))
    folded = NIFS.fold_witness(ops["r"], f1, f2, t)
    np.testing.assert_array_equal(folded.e.numpy(), arrays["chain_fold_e"])
    np.testing.assert_array_equal(folded.w.numpy(), arrays["chain_fold_w"])


def test_matvec_matches_zktpu_golden():
    """zktpu's matrix_vector_product on random entries, word for word: the
    port's encoding, its product on the CPU (the plain version) and the host
    build of the matvec kernel in two designs."""
    from test_torch_csrc_host import matvec_host_lib
    from zktpu_torch.nova.matvec_kernel import run
    from zktpu_torch.nova.utils import to_f_matrix

    arrays = dict(np.load(os.path.join(HERE, "nova_matvec.npz")))
    rows, zs = matvec_operands()
    A, z = to_f_matrix(rows, CPU), to_f_vec(zs, CPU)
    assert A.shape == MATVEC_SHAPE + (8,)
    np.testing.assert_array_equal(A.numpy(), arrays["a"])
    np.testing.assert_array_equal(z.numpy(), arrays["z"])
    np.testing.assert_array_equal(matrix_vector_product(A, z).numpy(), arrays["az"])
    for design in ("one_warp_four_rows", "library"):
        np.testing.assert_array_equal(run(matvec_host_lib(design), A, z).numpy(), arrays["az"])


def test_chain_ivc_satisfied_and_final_state():
    """Two chain steps on the CPU: the first fold satisfies the relaxed
    R1CS, every step verifies, the final state equals the host's."""
    log_m, steps = 2, 2
    inputs = prof_nova.chain_inputs(steps)
    r1cs = prof_nova.chain_r1cs(log_m, CPU)
    scheme = KzgScheme(Srs.new_from_secret(prof_nova.SRS_SECRET, (1 << log_m) + 3, device=CPU))
    folds = []

    def after_fold(step, fw, fu):
        is_r1cs_satisfied(r1cs, fu, fw, scheme)
        folds.append(step)

    run = prof_nova.run_ivc(scheme, r1cs, prof_nova.chain_circuit(), prof_nova.chain_step_witness(log_m, inputs),
                            steps, CPU, after_fold=after_fold)
    assert folds == [0]
    assert run["states"][-1] == prof_nova.host_final_state(log_m, inputs)


def test_r1cs_satisfaction(setup):
    r1cs, _, x, scheme, w, u = setup
    is_r1cs_satisfied(r1cs, u[0], w[0], scheme)
    bad = FWitness(e=w[0].e, w=to_f_vec([9, 9, 27, 30], CPU))
    with pytest.raises(NovaError):
        is_r1cs_satisfied(r1cs, bad.commit(scheme, x[0]), bad, scheme)


def test_prover_folding_satisfied(setup):
    r1cs, _, _, scheme, w, u = setup
    folded_w, folded_u, _, _ = NIFS.prover(r1cs, w[0], w[1], u[0], u[1], scheme, NovaTranscript())
    is_r1cs_satisfied(r1cs, folded_u, folded_w, scheme)


def test_one_fold_roundtrip(setup):
    r1cs, _, _, scheme, w, u = setup
    pt = NovaTranscript()
    fw, fu, com_t, r = NIFS.prover(r1cs, w[0], w[1], u[0], u[1], scheme, pt)
    proof = NIFS.prove(r, fw, fu, scheme, pt)
    v_folded = NIFS.verifier(r, u[0], u[1], com_t)
    NIFS.verify(proof, u[0], u[1], v_folded, com_t, scheme, NovaTranscript())
    bad = NIFSProof(FR.add(proof.r, 1), proof.opening_point, proof.opening_e, proof.opening_w)
    with pytest.raises(NovaError):
        NIFS.verify(bad, u[0], u[1], v_folded, com_t, scheme, NovaTranscript())


def test_augmented_circuit_rejects_wrong_io(setup):
    _, witnesses, x, scheme, w, u = setup
    _tw, trivial_instance = create_trivial_pair(len(x[0]), len(witnesses[0]), scheme, CPU)
    circ = AugmentedCircuit(prof_nova.cubic_circuit(), trivial_instance, State(0))
    circ.i = 1
    circ.h_i = 123456
    with pytest.raises(NovaError):
        circ.run(u[0], u[1], w[0], u[0].com_e)


def test_converters_round_trip_and_satisfy(setup, golden):
    """zktpu's R1CS, witness and instance (digit arrays and ints) through
    the converters: equal to the port's own, and satisfied by the port's
    is_r1cs_satisfied; the first fold's relaxed pair too; the augmented
    circuit's state both ways."""
    r1cs, _, _, scheme, w, u = setup
    js, arrays = golden
    digits = {k: convert.limbs_to_digits(arrays[k]) for k in ("a", "b", "c", "w0_e", "w0_w", "fold_e", "fold_w")}
    conv = convert.r1cs_from_numpy(digits["a"], digits["b"], digits["c"], 1, 4, CPU)
    for name in ("matrix_a", "matrix_b", "matrix_c"):
        assert torch.equal(getattr(conv, name), getattr(r1cs, name))
    back = convert.r1cs_to_numpy(conv)
    assert all(np.array_equal(back[k], digits[k]) for k in "abc") and (back["num_io"], back["num_vars"]) == (1, 4)
    fw = convert.fwitness_from_numpy(digits["w0_e"], digits["w0_w"], CPU)
    assert vec_equal(fw.w, w[0].w) and vec_equal(fw.e, w[0].e)
    fi = convert.finstance_from_ints(js["u0"])
    assert convert.finstance_to_ints(fi) == js["u0"] == convert.finstance_to_ints(u[0])
    is_r1cs_satisfied(conv, fi, fw, scheme)
    fold_w = convert.fwitness_from_numpy(digits["fold_e"], digits["fold_w"], CPU)
    fold_u = convert.finstance_from_ints(js["fold"])
    assert fold_u.u != 1 and not fold_w.e.eq(0).all()
    is_r1cs_satisfied(conv, fold_u, fold_w, scheme)
    state = {"i": 3, "z_0": 0, "z_i": FQ.modulus - 5, "h_i": 77}
    circ = convert.augmented_state_from_ints(AugmentedCircuit(prof_nova.cubic_circuit(), fi, State(0)), state)
    assert convert.augmented_state_to_ints(circ) == state
