"""Circuit builder (counterpart of zktpu/plonk/circuit.py).

Gate list + three witness columns -> interpolated selector, witness and
sigma polynomials on a chosen device.  Same parity rules as zktpu: a circuit
of at most one gate raises ValueError (the reference panics); dummy gates add
zero rows but keep identity permutation entries; k1 = 2, k2 = 3.
"""
from __future__ import annotations

from ..fields.host import FR
from .gate import Gate
from ..fields.fp import field
from ..poly.domain import get_domain
from ..poly.poly import poly_from_evals
from .constraint import CompiledCircuit, CopyConstraints, GateConstraints


class Circuit:
    def __init__(self):
        self.gates: list[Gate] = []
        self.vals: list[list[int]] = [[], [], []]

    # -- gate insertion; a/b/c = (column, row, value) --

    def _add_gate(self, a, b, c, kind: str, pi: int):
        self.vals[0].append(a[2] % FR.modulus)
        self.vals[1].append(b[2] % FR.modulus)
        self.vals[2].append(c[2] % FR.modulus)
        pos = ((a[0], a[1]), (b[0], b[1]), (c[0], c[1]))
        if kind == "add":
            gate = Gate.new_add_gate(*pos, pi)
        elif kind == "mul":
            gate = Gate.new_mul_gate(*pos, pi)
        else:
            gate = Gate.new_constant_gate(*pos, a[2], pi)
        self.gates.append(gate)

    def add_addition_gate(self, a, b, c, pi=0):
        self._add_gate(a, b, c, "add", pi)

    def add_multiplication_gate(self, a, b, c, pi=0):
        self._add_gate(a, b, c, "mul", pi)

    def add_constant_gate(self, a, b, c, pi=0):
        self._add_gate(a, b, c, "const", pi)

    # -- compilation --

    def _pad_circuit(self):
        length = len(self.gates)
        if length <= 1:
            raise ValueError("pad_circuit requires at least 2 gates (reference panics)")
        new_len = 1 << (length - 1).bit_length()  # (len - 1).ilog2() + 1
        for _ in range(length, new_len):
            self.gates.append(Gate.new_dummy_gate())

    def get_assignment(self) -> dict[str, list[int]]:
        out = {k: [] for k in ("a", "b", "c", "ql", "qr", "qm", "qo", "qc", "pi")}
        for i, gate in enumerate(self.gates):
            if gate.is_dummy():
                continue
            out["a"].append(self.vals[0][i])
            out["b"].append(self.vals[1][i])
            out["c"].append(self.vals[2][i])
            out["ql"].append(gate.q_l)
            out["qr"].append(gate.q_r)
            out["qm"].append(gate.q_m)
            out["qo"].append(gate.q_o)
            out["qc"].append(gate.q_c)
            out["pi"].append(gate.pi)
        return out

    def compile(self, device=None) -> CompiledCircuit:
        self._pad_circuit()
        n = len(self.gates)
        dom = get_domain(FR, n, device)
        frd = field(FR, device)
        evals, polys = {}, {}
        for key, vec in self.get_assignment().items():
            evals[key] = frd.encode_ints(vec + [0] * (n - len(vec)))
            polys[key] = poly_from_evals(dom, evals[key])
        gate_constraints = GateConstraints(
            f_ax=polys["a"], f_bx=polys["b"], f_cx=polys["c"],
            q_lx=polys["ql"], q_rx=polys["qr"], q_ox=polys["qo"], q_mx=polys["qm"],
            q_cx=polys["qc"], pi_x=polys["pi"], evals=evals,
        )
        copy_constraints = self._cal_permutation(n, dom)
        return CompiledCircuit(size=n, gate_constraints=gate_constraints, copy_constraints=copy_constraints)

    def _cal_permutation(self, n: int, dom) -> CopyConstraints:
        roots = dom.elements_ints()
        k1 = FR.add(roots[0], 1)  # = 2
        k2 = FR.add(k1, 1)  # = 3
        coset1 = [FR.mul(r, k1) for r in roots]
        coset2 = [FR.mul(r, k2) for r in roots]
        sigma = (list(roots), list(coset1), list(coset2))
        cosets = (roots, coset1, coset2)
        for index, gate in enumerate(self.gates):
            if gate.is_dummy():
                continue
            for s, (col, row) in zip(sigma, (gate.a_pos, gate.b_pos, gate.c_pos)):
                s[index] = cosets[col][row]
        e1, e2, e3 = (dom.df.encode_ints(s) for s in sigma)
        return CopyConstraints(
            s_sigma_1=poly_from_evals(dom, e1),
            s_sigma_2=poly_from_evals(dom, e2),
            s_sigma_3=poly_from_evals(dom, e3),
            k1=k1,
            k2=k2,
            evals={"s1": e1, "s2": e2, "s3": e3},
        )
