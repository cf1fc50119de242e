"""PLONK gates (mirrors plonk/src/gate.rs:5-132).

The port's own copy of zktpu/plonk/gate.py.

3-wire gates with selectors (q_l, q_r, q_o, q_m, q_c) and per-gate public
input.  NOTE reference quirk preserved: `pi` is stored NEGATED
(gate.rs:53,73,94) and constant gates store q_c = -constant.
Wire positions (column, row) encode the copy permutation.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.host import FR

DUMMY = None  # Position::Dummy


@dataclass
class Gate:
    a_pos: tuple[int, int] | None
    b_pos: tuple[int, int] | None
    c_pos: tuple[int, int] | None
    q_l: int
    q_r: int
    q_o: int
    q_m: int
    q_c: int
    pi: int

    @classmethod
    def new_add_gate(cls, a_pos, b_pos, c_pos, pi=None):
        return cls(a_pos, b_pos, c_pos, 1, 1, FR.neg(1), 0, 0, FR.neg(pi or 0))

    @classmethod
    def new_mul_gate(cls, a_pos, b_pos, c_pos, pi=None):
        return cls(a_pos, b_pos, c_pos, 0, 0, FR.neg(1), 1, 0, FR.neg(pi or 0))

    @classmethod
    def new_constant_gate(cls, a_pos, b_pos, c_pos, constant, pi=None):
        return cls(a_pos, b_pos, c_pos, 1, 0, 0, 0, FR.neg(constant), FR.neg(pi or 0))

    @classmethod
    def new_dummy_gate(cls):
        return cls(DUMMY, DUMMY, DUMMY, 0, 0, 0, 0, 0, 0)

    def is_dummy(self) -> bool:
        return self.a_pos is DUMMY
