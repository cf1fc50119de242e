"""The field linear combination (fields/lincomb_kernel.py) and the launch
path's broadcast rule (cuda_lib.broadcast_shapes), on the CPU.

Against zktpu, word for word, through committed goldens
(tests/goldens/lincomb.npz, written by tests/goldens/make_goldens.py
lincomb from zktpu's own chains on the operands of lincomb_operands()):

- NIFS.compute_t and NIFS.fold_witness on a dense (M, N) R1CS of random
  entries (the chains of zktpu/nova/nifs.py:31-52), through the port's NIFS,
  which runs each as one lincomb;
- PLONK round 5's w_ev_x chain (zktpu/plonk/prover.py:184-191: six
  polynomials of unequal lengths, each less its evaluation, scaled by
  powers of v and summed, on zktpu's Poly), through the plain lincomb.

The kernel's own row code runs on the CPU in tests/test_torch_csrc_host.py
(-k lincomb); tests/test_torch_cuda.py holds the kernel to the plain chain
on the card.
"""
import os

import numpy as np
import pytest
import torch

from zktpu_torch import cuda_lib
from zktpu_torch.fields.fp import field, limbs_to_ints
from zktpu_torch.fields.host import FR
from zktpu_torch.fields.lincomb_kernel import lincomb_plain
from zktpu_torch.nova.nifs import NIFS
from zktpu_torch.nova.r1cs import R1CS, FWitness
from zktpu_torch.nova.utils import to_f_matrix, to_f_vec

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "lincomb.npz")
SEED = 20261018
M, N = 6, 9  # the R1CS's constraints and variables
W_EV_X_LENGTHS = (14, 13, 11, 12, 9, 10)  # r, a, b, c, s_sigma_1, s_sigma_2
FRT = field(FR, "cpu")


def lincomb_operands() -> dict:
    """Canonical Fr ints from default_rng(SEED), with 0, 1 and p - 1 at the
    front of each vector: the R1CS's matrices, z1, z2, u1, u2, E1, E2, W1,
    W2 and r; w_ev_x's polynomials, their evaluations (bars) and v."""
    rng = np.random.default_rng(SEED)
    p = FR.modulus

    def vec(n):
        words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]
        return ([0, 1, p - 1] + vals)[:n] if n > 3 else vals

    out = {k: [vec(N) for _ in range(M)] for k in ("a", "b", "c")}
    out.update({k: vec(N) for k in ("z1", "z2")})
    out.update({k: vec(M) for k in ("e1", "e2")})
    out.update({k: vec(N - 3) for k in ("w1", "w2")})
    out.update(zip(("u1", "u2", "r", "v"), vec(4)))
    out["polys"] = [vec(n) for n in W_EV_X_LENGTHS]
    out["bars"] = vec(len(W_EV_X_LENGTHS))
    return out


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def ops():
    return lincomb_operands()


def _ints(t) -> list[int]:
    return limbs_to_ints(np.asarray(t))


def test_compute_t_matches_zktpu(golden, ops):
    r1cs = R1CS(to_f_matrix(ops["a"], "cpu"), to_f_matrix(ops["b"], "cpu"), to_f_matrix(ops["c"], "cpu"),
                num_io=1, num_vars=N - 3)
    t = NIFS.compute_t(r1cs, ops["u1"], ops["u2"], to_f_vec(ops["z1"], "cpu"), to_f_vec(ops["z2"], "cpu"))
    assert torch.equal(t, torch.from_numpy(golden["t"]))


def test_fold_witness_matches_zktpu(golden, ops):
    f1 = FWitness(e=to_f_vec(ops["e1"], "cpu"), w=to_f_vec(ops["w1"], "cpu"))
    f2 = FWitness(e=to_f_vec(ops["e2"], "cpu"), w=to_f_vec(ops["w2"], "cpu"))
    folded = NIFS.fold_witness(ops["r"], f1, f2, torch.from_numpy(golden["t"]))
    assert torch.equal(folded.e, torch.from_numpy(golden["fold_e"]))
    assert torch.equal(folded.w, torch.from_numpy(golden["fold_w"]))
    with pytest.raises(ValueError):  # the chain's adds take equal shapes
        NIFS.fold_witness(ops["r"], f1, FWitness(e=f2.e[:-1], w=f2.w), torch.from_numpy(golden["t"]))


def test_w_ev_x_chain_matches_zktpu(golden, ops):
    """(r - bar_r) + sum_k v^k (P_k - bar_k) as the prover runs it: five
    products by scalars, r, and one constant at row 0."""
    p, v = FR.modulus, ops["v"]
    polys = [FRT.encode_ints(c) for c in ops["polys"]]
    vk = [pow(v, k, p) for k in range(1, 6)]
    const = (ops["bars"][0] + sum(x * b for x, b in zip(vk, ops["bars"][1:]))) % p
    got = lincomb_plain(FRT, [(P, FRT.encode_int(x), 1) for P, x in zip(polys[1:], vk)],
                        [(polys[0], 1), (FRT.encode_int(const), -1)])
    assert torch.equal(got, torch.from_numpy(golden["w_ev_x"]))


@pytest.mark.parametrize("signs", [(1, 1, 1, 1), (-1, 1, -1, -1), (-1, -1, -1, -1)])
def test_lincomb_matches_host_ints(ops, signs):
    """Unequal lengths, a scalar and a full-length b, a row-0 addend,
    against Python-int arithmetic."""
    p = FR.modulus
    a, b, c = ops["e1"], ops["e2"], ops["w1"]
    s1, s2, s3, s4 = signs
    got = FRT.lincomb([(FRT.encode_ints(a), FRT.encode_ints(b), s1), (FRT.encode_ints(c), FRT.encode_int(ops["v"]), s2)],
                      [(FRT.encode_ints(c[:2]), s3), (FRT.encode_int(ops["r"]), s4)])
    want = [(s1 * a[i] * b[i] + (s2 * c[i] * ops["v"] if i < len(c) else 0) + (s3 * c[i] if i < 2 else 0)
             + (s4 * ops["r"] if i == 0 else 0)) % p for i in range(len(a))]
    assert FRT.decode_ints(got) == want


def test_lincomb_empty_and_zero_rows():
    assert FRT.lincomb([], []).shape == (0, 8)
    z = torch.zeros((0, 8), dtype=torch.int32)
    assert FRT.lincomb([(z, FRT.one, 1)], [(z, -1)]).shape == (0, 8)
    one_row = FRT.lincomb([(z, FRT.one, 1)], [(FRT.one, -1)])
    assert FRT.decode_ints(one_row) == [FR.modulus - 1]


BROADCASTS = [
    ((), ()), ((3,), ()), ((), (4,)), ((5,), (5,)), ((5,), (1,)), ((1,), (5,)), ((2, 3), (3,)),
    ((2, 1), (1, 4)), ((0,), (1,)), ((1,), (0,)), ((0, 3), (3,)), ((4, 1, 3), (2, 1)), ((7, 8), (1, 1)),
    ((2, 3, 4), (2, 1, 4), (1, 1, 1)), ((2048, 8), (8,)), ((2048, 8, 8), (8, 8), (8,)), ((1, 1), (1,)),
]
NOT_BROADCASTING = [((2,), (3,)), ((2, 3), (3, 2)), ((0,), (2,)), ((4, 1), (3, 2)), ((5, 8), (1, 8), (6, 1))]


@pytest.mark.parametrize("shapes", BROADCASTS + NOT_BROADCASTING, ids=str)
def test_broadcast_rule_equals_torch(shapes):
    try:
        want = tuple(torch.broadcast_shapes(*shapes))
    except RuntimeError:
        assert shapes in NOT_BROADCASTING
        with pytest.raises(RuntimeError):
            cuda_lib.broadcast_shapes(*shapes)
        return
    assert shapes in BROADCASTS
    assert cuda_lib.broadcast_shapes(*shapes) == want


def test_broadcast_rule_refuses_negative_lengths():
    with pytest.raises(ValueError):
        torch.broadcast_shapes((-1,), (2,))
    with pytest.raises(ValueError):
        cuda_lib.broadcast_shapes((-1,), (2,))
