"""Constraint containers (counterpart of zktpu/plonk/constraint.py).

Besides the interpolated polynomials, the compiled circuit keeps the raw
evaluation vectors over the circuit domain ((n, 8) Fr Montgomery limb
tensors): the grand product and the quotient work in evaluation form.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..poly.poly import Poly


@dataclass
class GateConstraints:
    f_ax: Poly
    f_bx: Poly
    f_cx: Poly
    q_lx: Poly
    q_rx: Poly
    q_ox: Poly
    q_mx: Poly
    q_cx: Poly
    pi_x: Poly
    # evaluations over the circuit domain, keyed a, b, c, ql, qr, qm, qo, qc, pi
    evals: dict | None = None


@dataclass
class CopyConstraints:
    s_sigma_1: Poly
    s_sigma_2: Poly
    s_sigma_3: Poly
    k1: int
    k2: int
    # sigma evaluations over the circuit domain, keyed s1, s2, s3
    evals: dict | None = None


@dataclass
class CompiledCircuit:
    size: int
    gate_constraints: GateConstraints
    copy_constraints: CopyConstraints
