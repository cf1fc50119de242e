"""Equation string -> Circuit (the port's copy of zktpu/plonk/parser.py,
pointed at zktpu_torch's Circuit).

The same semantics as zktpu's parser:
  - `parse_string` normalization: lowercase, strip spaces, expand `a^n` into
    n-1 extra `*a` factors using the single preceding char (`x ^ x`
    raises).
  - term construction: split on '=', LHS terms on '+', the RHS moved to the
    LHS as an extra '-result' term (parser.rs:103-113).
  - per-term '*'-reduction emits multiplication gates; terms are folded with
    addition gates; gates are deduplicated via a seen-set so repeated
    subproducts (e.g. x*y in x*y + x*y*z) are shared (parser.rs:138-172).
  - integer literals insert constant gates at first encounter
    (parser.rs:309-347); missing witnesses raise (parse::<i32>().unwrap()).
  - the final gate's output value is forced to zero (parser.rs:188-191).
  - copy cycles: per-wire position lists are reversed, rotated right by one,
    and popped per use, so each occurrence points at the next occurrence
    (parser.rs:197-246).
"""
from __future__ import annotations

from ..fields.host import FR
from .circuit import Circuit

_ADD, _MUL, _CONST = 0, 1, 2
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _parse_i32(s: str) -> int:
    """Rust `s.parse::<i32>()` equivalent; raises ValueError on failure."""
    if not s or not (s.lstrip("-").isdigit() and s.count("-") <= 1 and not s.startswith("--")):
        raise ValueError(f"invalid digit found in string: {s!r}")
    if s.startswith("-") and len(s) == 1:
        raise ValueError("invalid digit")
    v = int(s)
    if not (_I32_MIN <= v <= _I32_MAX):
        raise ValueError(f"number too large for i32: {s}")
    return v


def _is_i32(s: str) -> bool:
    try:
        _parse_i32(s)
        return True
    except ValueError:
        return False


class _Builder:
    """Shared gate-list/position-map accumulator for Parser and CPIGenerator.

    Wires are (string, value) pairs; the CPI path passes value=None so gate
    identity (the dedup key) degrades to strings only, exactly like
    cpi_parser.rs's value-free ParserWire.
    """

    def __init__(self):
        self.gate_list: list[tuple] = []  # (left, right, bottom, kind)
        self.gate_set: set[tuple] = set()
        self.position_map: dict[str, list[tuple[int, int]]] = {}

    def _push_pos(self, wire_number: int, gate_number: int, value: str) -> None:
        self.position_map.setdefault(value, []).append((wire_number, gate_number))

    def emit(self, left, right, bottom, kind) -> tuple:
        """Append gate unless an identical one exists; returns bottom wire."""
        gate = (left, right, bottom, kind)
        if gate in self.gate_set:
            return bottom
        num = len(self.gate_list)
        self.gate_list.append(gate)
        self.gate_set.add(gate)
        self._push_pos(0, num, left[0])
        self._push_pos(1, num, right[0])
        self._push_pos(2, num, bottom[0])
        return bottom

    def mul(self, left, right):
        value = None if left[1] is None else FR.mul(left[1], right[1])
        return self.emit(left, right, (f"{left[0]}*{right[0]}", value), _MUL)

    def add(self, left, right):
        value = None if left[1] is None else FR.add(left[1], right[1])
        return self.emit(left, right, (f"{left[0]}+{right[0]}", value), _ADD)

    def constant(self, wire):
        zero = ("0", None if wire[1] is None else 0)
        value = wire[1]
        return self.emit(wire, zero, (f"{wire[0]}+0", value), _CONST)

    def take_positions(self) -> dict[str, list[tuple[int, int]]]:
        """reverse + rotate_right(1) per key (parser.rs:202-209); consumers pop
        from the end, yielding the cyclic next-occurrence permutation."""
        out = {}
        for key, vec in self.position_map.items():
            v = vec[::-1]
            out[key] = [v[-1]] + v[:-1] if v else v
        return out


def parse_string(string: str) -> str:
    """Normalizer (parser.rs:373-415): lowercase, drop spaces, expand `^n`."""
    string = string.lower()
    result: list[str] = []
    last_char = " "
    number_buffer = ""
    flag = False
    for ch in string:
        if ch == " ":
            continue
        if ch == "^":
            flag = True
        elif not ch.isdigit():
            if flag:
                if number_buffer:
                    for _ in range(_parse_i32(number_buffer) - 1):
                        result.append("*")
                        result.append(last_char)
                    flag = False
                else:
                    raise ValueError("can't parse polynomial")
            last_char = ch
            result.append(ch)
            number_buffer = ""
        else:
            number_buffer += ch
            if not flag:
                last_char = ch
                result.append(ch)
    if flag and number_buffer:
        for _ in range(_parse_i32(number_buffer) - 1):
            result.append("*")
            result.append(last_char)
    return "".join(result)


def _split_terms(string: str) -> list[str]:
    parts = string.split("=")
    if len(parts) != 2:
        raise ValueError("expected exactly one '=' in equation")
    terms = parts[0].split("+")
    terms.append("-" + parts[1])
    return terms


class Parser:
    """Prover-side parser: equation + witness map -> Circuit."""

    def __init__(self):
        self.witnesses: dict[str, int] = {}

    def add_witness(self, variable: str, value: int) -> None:
        self.witnesses[variable] = value % FR.modulus

    def parse(self, input_str: str) -> Circuit:
        string = parse_string(input_str)
        b = _Builder()
        acc = None
        for term in _split_terms(string):
            wires = [self._token_wire(t.strip(), b) for t in term.split("*")]
            w = wires[0]
            for nxt in wires[1:]:
                w = b.mul(w, nxt)
            acc = w if acc is None else b.add(acc, w)
        # force the final gate's result to 0 (parser.rs:188-191)
        l, r, bot, kind = b.gate_list[-1]
        b.gate_list[-1] = (l, r, (bot[0], 0), kind)
        return self._gen_circuit(b)

    def _token_wire(self, token: str, b: _Builder):
        """Resolve token to (string, value); literals insert constant gates
        (parser.rs:309-347)."""
        if not token:
            raise ValueError("empty factor")
        value = token
        is_negative = value[0] == "-"
        if is_negative:
            value = value[1:]
        if value in self.witnesses:
            result = self.witnesses[value]
        else:
            constant = _parse_i32(value)  # raises on missing witness
            if is_negative:
                b.constant((f"-{constant}", FR.neg(constant)))
            else:
                b.constant((str(constant), constant % FR.modulus))
            result = constant % FR.modulus
        return (token, FR.neg(result) if is_negative else result)

    @staticmethod
    def _gen_circuit(b: _Builder) -> Circuit:
        positions = b.take_positions()
        circuit = Circuit()
        for left, right, bottom, kind in b.gate_list:
            lp = positions[left[0]].pop()
            rp = positions[right[0]].pop()
            bp = positions[bottom[0]].pop()
            a = (lp[0], lp[1], left[1])
            bb = (rp[0], rp[1], right[1])
            c = (bp[0], bp[1], bottom[1])
            if kind == _ADD:
                circuit.add_addition_gate(a, bb, c)
            elif kind == _MUL:
                circuit.add_multiplication_gate(a, bb, c)
            else:
                circuit.add_constant_gate(a, bb, c)
        return circuit
