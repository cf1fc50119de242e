"""Common preprocessed input (the port's copy of zktpu/plonk/cpi.py,
pointed at zktpu_torch's Circuit and KzgScheme).

As plonk/src/common_preprocessed_input/{cpi_parser,cpi_circuit}.rs:
the same equation parse but witness-free — wires carry only strings, constant
gates are emitted for any token that parses as an i32 (cpi_parser.rs:342-352)
— producing KZG commitments of the five selector polynomials and three sigma
polynomials plus (n, k1, k2, pi_x): a succinct verifier key.

Implementation note: the value-free CPI circuit is realized by building the
ordinary Circuit with zero witness values (CPICircuit's get_assignment only
reads selectors/pi, and its cal_permutation only reads wire positions —
cpi_circuit.rs:90-167 — so the committed polynomials are identical).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.host import FR
from ..kzg.scheme import KzgCommitment, KzgScheme
from ..poly.poly import Poly
from .circuit import Circuit
from .parser import _ADD, _MUL, _Builder, _is_i32, _parse_i32, _split_terms, parse_string


@dataclass
class CommonPreprocessedInput:
    n: int
    k1: int
    k2: int
    com_q_lx: KzgCommitment
    com_q_rx: KzgCommitment
    com_q_mx: KzgCommitment
    com_q_ox: KzgCommitment
    com_q_cx: KzgCommitment
    com_s_sigma_1: KzgCommitment
    com_s_sigma_2: KzgCommitment
    com_s_sigma_3: KzgCommitment
    pi_x: Poly


class CPIGenerator:
    """Witness-free parse -> CommonPreprocessedInput (cpi_parser.rs:113-124)."""

    def compute_common_preprocessed_input(
        self, input_str: str, scheme: KzgScheme
    ) -> CommonPreprocessedInput:
        """The circuit compiles on the SRS's device."""
        string = parse_string(input_str)
        b = _Builder()
        acc = None
        for term in _split_terms(string):
            wires = []
            for tok in (t.strip() for t in term.split("*")):
                if _is_i32(tok):  # check_constant (cpi_parser.rs:342-352)
                    b.constant((tok, None))
                wires.append((tok, None))
            w = wires[0]
            for nxt in wires[1:]:
                w = b.mul(w, nxt)
            acc = w if acc is None else b.add(acc, w)
        circuit = self._gen_circuit(b)
        compiled = circuit.compile(scheme.srs.device)
        gc, cc = compiled.gate_constraints, compiled.copy_constraints
        return CommonPreprocessedInput(
            n=compiled.size,
            k1=cc.k1,
            k2=cc.k2,
            com_q_lx=scheme.commit(gc.q_lx),
            com_q_rx=scheme.commit(gc.q_rx),
            com_q_mx=scheme.commit(gc.q_mx),
            com_q_ox=scheme.commit(gc.q_ox),
            com_q_cx=scheme.commit(gc.q_cx),
            com_s_sigma_1=scheme.commit(cc.s_sigma_1),
            com_s_sigma_2=scheme.commit(cc.s_sigma_2),
            com_s_sigma_3=scheme.commit(cc.s_sigma_3),
            pi_x=gc.pi_x,
        )

    @staticmethod
    def _gen_circuit(b: _Builder) -> Circuit:
        positions = b.take_positions()
        circuit = Circuit()
        for left, right, bottom, kind in b.gate_list:
            lp = positions[left[0]].pop()
            rp = positions[right[0]].pop()
            bp = positions[bottom[0]].pop()
            if kind == _ADD:
                circuit.add_addition_gate((*lp, 0), (*rp, 0), (*bp, 0))
            elif kind == _MUL:
                circuit.add_multiplication_gate((*lp, 0), (*rp, 0), (*bp, 0))
            else:
                # constant value re-parsed from the wire string (cpi_parser.rs:267-273)
                const = _parse_i32(left[0]) % FR.modulus
                circuit.add_constant_gate((*lp, const), (*rp, 0), (*bp, 0))
        return circuit
