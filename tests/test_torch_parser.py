"""The port's parser and CPI (zktpu_torch/plonk/{parser,cpi}.py) against
zktpu's: the cases of tests/test_parser.py, and the PLONK proofs of its
equations byte for byte against committed goldens of zktpu's proofs
(tests/goldens/parser.json, written by tests/goldens/make_goldens.py parser)."""
import dataclasses
import json
import os

import pytest
import torch

from zktpu_torch.fields.host import FR
from zktpu_torch.kzg import KzgScheme, Srs
from zktpu_torch.plonk.circuit import Circuit
from zktpu_torch.plonk.cpi import CPIGenerator
from zktpu_torch.plonk.parser import Parser, _is_i32, _parse_i32, _split_terms, parse_string
from zktpu_torch.plonk.prover import generate_proof
from zktpu_torch.plonk.verifier import PlonkVerificationError, verify
from zktpu_torch.transcript.chacha import StdRng
from zktpu_torch.transcript.serialize import fr_bytes, g1_uncompressed

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "parser.json")
SRS_SECRET, SRS_SIZE = 31337, 20
EQ = "x*y+3*x^2+x*y*z=11"
XYZ = {"x": 1, "y": 2, "z": 3}
# name: (equation, witnesses, StdRng seed): tests/test_parser.py's three
# equations with their seeds (its cross rejection also proves EQ with seed 6;
# here the rejection takes the e2e proof of EQ, and each proof costs seconds
# of host-tier G1 multiplications)
PROOFS = {
    "e2e": (EQ, XYZ, 5),
    "cross2": ("x*y+3*x^2+x*y*z=13", {"x": 1, "y": 2, "z": 4}, 6),
    "negative": ("x*y+3*x*x+x*y*z=-1", {"x": -1, "y": -2, "z": -3}, 9),
}
CPI_COMMITS = ("com_q_lx", "com_q_rx", "com_q_mx", "com_q_ox", "com_q_cx", "com_s_sigma_1", "com_s_sigma_2",
               "com_s_sigma_3")


def proof_bytes(proof) -> bytes:
    """A PLONK proof of either package as bytes: its fields in order, each
    commitment as arkworks' uncompressed G1 encoding, each scalar as its 32
    little-endian bytes, the degree as 8."""
    out = []
    for f in dataclasses.fields(proof):
        v = getattr(proof, f.name)
        if hasattr(v, "point"):
            out.append(g1_uncompressed(v.point.x, v.point.y, v.point.infinity))
        elif f.name == "degree":
            out.append(int(v).to_bytes(8, "little"))
        else:
            out.append(fr_bytes(int(v)))
    return b"".join(out)


def _parser(wit) -> Parser:
    p = Parser()
    for k, v in wit.items():
        p.add_witness(k, v)
    return p


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def srs20():
    return Srs.new_from_secret(SRS_SECRET, SRS_SIZE, device="cpu")


@pytest.fixture(scope="module")
def proved(srs20):
    """Each equation compiled on the CPU and proved with its seed."""
    out = {}
    for name, (eq, wit, seed) in PROOFS.items():
        compiled = _parser(wit).parse(eq).compile(device="cpu")
        out[name] = compiled, generate_proof(compiled, srs20, rng=StdRng.from_seed_u64(seed))
    return out


def test_parse_string_normalization():
    assert parse_string("x * y + 3 * x ^ 2 + x * y * z = 11") == "x*y+3*x*x+x*y*z=11"
    assert _split_terms("x*y+3*x*x=11") == ["x*y", "3*x*x", "-11"]
    assert _is_i32("-2147483648") and not _is_i32("2147483648") and not _is_i32("--1") and not _is_i32("x")
    with pytest.raises(ValueError):
        _parse_i32("-")


def test_parse_string_panics_on_symbol_exponent():
    with pytest.raises(ValueError):
        parse_string("x * y + 3 * x ^ x + x * y * z=0")


def test_parser_matches_hand_written_circuit():
    generated = _parser(XYZ).parse("x*y+3*x*x+x*y*z=11")
    hand = Circuit()
    hand.add_multiplication_gate((1, 2, 1), (1, 0, 2), (0, 4, 2), 0)
    hand.add_constant_gate((0, 2, 3), (1, 7, 0), (2, 1, 3), 0)
    hand.add_multiplication_gate((0, 1, 3), (1, 3, 1), (0, 3, 3), 0)
    hand.add_multiplication_gate((2, 2, 3), (0, 0, 1), (1, 4, 3), 0)
    hand.add_addition_gate((0, 5, 2), (2, 3, 3), (0, 6, 5), 0)
    hand.add_multiplication_gate((2, 0, 2), (1, 5, 3), (1, 6, 6), 0)
    hand.add_addition_gate((2, 4, 5), (2, 5, 6), (0, 8, 11), 0)
    hand.add_constant_gate((1, 8, FR.neg(11)), (1, 1, 0), (2, 7, FR.neg(11)), 0)
    hand.add_addition_gate((2, 6, 11), (0, 7, FR.neg(11)), (2, 8, 0), 0)
    assert generated.gates == hand.gates
    assert generated.vals == hand.vals


def test_parser_missing_witness_raises():
    with pytest.raises(ValueError):
        _parser(XYZ).parse("x*y+3*x*x+x*y*z*a=0")


@pytest.mark.parametrize("name", list(PROOFS))
def test_proof_bytes_match_zktpu(proved, golden, name):
    assert proof_bytes(proved[name][1]).hex() == golden["proofs"][name]


@pytest.mark.parametrize("name", ["e2e", "negative"])
def test_parser_proof_verifies(proved, srs20, name):
    compiled, proof = proved[name]
    verify(compiled, srs20, proof)


def test_parser_cross_rejection(proved, srs20):
    (c1, p1), (c2, p2) = proved["e2e"], proved["cross2"]
    with pytest.raises(PlonkVerificationError):
        verify(c1, srs20, p2)
    with pytest.raises(PlonkVerificationError):
        verify(c2, srs20, p1)


def test_cpi_matches_prover_commitments_and_zktpu(proved, golden, srs20):
    scheme = KzgScheme(srs20)
    cpi = CPIGenerator().compute_common_preprocessed_input(EQ, scheme)
    compiled = proved["e2e"][0]
    gc, cc = compiled.gate_constraints, compiled.copy_constraints
    assert (cpi.n, cpi.k1, cpi.k2) == (compiled.size, cc.k1, cc.k2)
    polys = (gc.q_lx, gc.q_rx, gc.q_mx, gc.q_ox, gc.q_cx, cc.s_sigma_1, cc.s_sigma_2, cc.s_sigma_3)
    for name, poly in zip(CPI_COMMITS, polys):
        assert getattr(cpi, name) == scheme.commit(poly), name
        point = getattr(cpi, name).point
        assert [point.x, point.y, point.infinity] == golden["cpi"][name], name
    assert cpi.pi_x.to_ints() == gc.pi_x.to_ints() == golden["cpi"]["pi_x"]
    assert [cpi.n, cpi.k1, cpi.k2] == [golden["cpi"][k] for k in ("n", "k1", "k2")]
