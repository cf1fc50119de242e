"""Carry state across from zktpu: digit planes -> limb tensors, FRI proofs
and Nova state of either package -> plain ints, and back.

zktpu stores a field element as D base-2^16 digits in u32 lanes; this package
stores L = D/2 little-endian 32-bit limbs, limb i = d[2i] | d[2i+1] << 16,
with the same Montgomery radix, so the words convert without arithmetic.
Inputs are numpy arrays (``np.asarray`` of zktpu's device arrays); nothing
here imports zktpu's JAX modules.
"""
from __future__ import annotations

import numpy as np
import torch

from .curves.host_curve import G1Affine, G2Affine
from .fields.host import FQ, FR, GOLDILOCKS
from .kzg.srs import Srs
from .plonk.constraint import CompiledCircuit, CopyConstraints, GateConstraints
from .poly.poly import Poly


def digits_to_limbs(digits) -> np.ndarray:
    """(..., D) base-2^16 digits -> (..., D/2) int32 limbs (u32 bit patterns)."""
    d = np.asarray(digits, dtype=np.uint32)
    assert d.shape[-1] % 2 == 0, d.shape
    limbs = d[..., 0::2] | (d[..., 1::2] << np.uint32(16))
    return np.ascontiguousarray(limbs).view(np.int32)


def limbs_to_digits(limbs) -> np.ndarray:
    """(..., L) 32-bit limbs -> (..., 2L) base-2^16 digits as uint32."""
    u = np.ascontiguousarray(np.asarray(limbs)).view(np.uint32)
    out = np.empty(u.shape[:-1] + (2 * u.shape[-1],), dtype=np.uint32)
    out[..., 0::2] = u & np.uint32(0xFFFF)
    out[..., 1::2] = u >> np.uint32(16)
    return out


def goldilocks_digits_to_limbs(digits) -> np.ndarray:
    """zktpu's Goldilocks digit arrays ((n, 4) u32, Montgomery or canonical)
    -> the port's (n, 2) int32 limbs (the same words)."""
    d = np.asarray(digits)
    assert d.shape[-1] == GOLDILOCKS.num_digits, d.shape
    return digits_to_limbs(d)


def _merkle_proof_to_ints(p) -> dict:
    return {"index": int(p.index), "leaf_val": int(p.leaf_val), "hash_proof": [int(h) for h in p.hash_proof],
            "root": int(p.root), "spec": p.spec.name}


def fri_proof_to_ints(proof) -> dict:
    """A FRI proof of either package (zktpu.fri.prover.Proof or
    zktpu_torch.fri.prover.Proof) as plain nested ints, lists and dicts with
    the fields of Proof, Decommitment and MerkleProof (a spec by its name),
    so proofs of the two packages compare with ==."""
    return {
        "domain_size": int(proof.domain_size),
        "coset": int(proof.coset),
        "number_of_queries": int(proof.number_of_queries),
        "layers_root": [int(r) for r in proof.layers_root],
        "const_val": int(proof.const_val),
        "decommitment_list": [
            {
                "evaluations": [int(v) for v in d.evaluations],
                "auth_paths": [_merkle_proof_to_ints(p) for p in d.auth_paths],
                "sym_evaluations": [int(v) for v in d.sym_evaluations],
                "sym_auth_paths": [_merkle_proof_to_ints(p) for p in d.sym_auth_paths],
            }
            for d in proof.decommitment_list
        ],
        "spec": proof.spec.name,
    }


def _tensor(digits, device) -> torch.Tensor:
    return torch.from_numpy(digits_to_limbs(digits)).to(device)


def srs_from_numpy(g1_planes, g2: G2Affine, g2s: G2Affine, size: int, device):
    """A zktpu_torch Srs from zktpu's SRS digit planes (X, Y, Z), each (size, 24)."""
    X, Y, Z = (_tensor(p, device) for p in g1_planes)
    assert X.shape == (size, FQ.num_digits // 2), X.shape
    return Srs((X, Y, Z), g2, g2s, size)


_GATE_POLYS = ("f_ax", "f_bx", "f_cx", "q_lx", "q_rx", "q_ox", "q_mx", "q_cx", "pi_x")
_COPY_POLYS = ("s_sigma_1", "s_sigma_2", "s_sigma_3")
_GATE_EVALS = ("a", "b", "c", "ql", "qr", "qm", "qo", "qc", "pi")
_COPY_EVALS = ("s1", "s2", "s3")


def circuit_from_numpy(size: int, coeffs: dict, evals: dict, k1: int, k2: int, device):
    """A zktpu_torch CompiledCircuit from a compiled circuit's digit arrays.

    coeffs: the twelve polynomials' (len, 16) coefficient digits, keyed by the
    GateConstraints / CopyConstraints field names (f_ax ... pi_x, s_sigma_1..3).
    evals: the (n, 16) evaluation digits keyed as in zktpu (a ... pi, s1..s3).
    """
    def poly(name):
        return Poly(FR, _tensor(np.asarray(coeffs[name]).reshape(-1, FR.num_digits), device))

    gate = GateConstraints(
        **{name: poly(name) for name in _GATE_POLYS},
        evals={k: _tensor(evals[k], device) for k in _GATE_EVALS},
    )
    copy = CopyConstraints(
        **{name: poly(name) for name in _COPY_POLYS},
        k1=k1,
        k2=k2,
        evals={k: _tensor(evals[k], device) for k in _COPY_EVALS},
    )
    return CompiledCircuit(size=size, gate_constraints=gate, copy_constraints=copy)


# -- Nova --


def r1cs_from_numpy(a, b, c, num_io: int, num_vars: int, device):
    """A zktpu_torch R1CS from zktpu's (m, n, 16) Montgomery digit matrices."""
    from .nova.r1cs import R1CS

    return R1CS(*(_tensor(x, device) for x in (a, b, c)), num_io=num_io, num_vars=num_vars)


def r1cs_to_numpy(r1cs) -> dict:
    """A zktpu_torch R1CS as zktpu's (m, n, 16) digit arrays and its counts."""
    return {**{k: limbs_to_digits(getattr(r1cs, f"matrix_{k}").cpu().numpy()) for k in "abc"},
            "num_io": int(r1cs.num_io), "num_vars": int(r1cs.num_vars)}


def fwitness_from_numpy(e, w, device):
    """A zktpu_torch FWitness from zktpu's (len, 16) digit arrays of E and W."""
    from .nova.r1cs import FWitness

    return FWitness(e=_tensor(e, device), w=_tensor(w, device))


def _point_to_ints(c) -> list:
    p = c.point
    return [int(p.x), int(p.y), bool(p.infinity)]


def finstance_to_ints(fi) -> dict:
    """An FInstance of either package as plain ints: each commitment as
    [x, y, infinity], u and x."""
    return {"com_e": _point_to_ints(fi.com_e), "u": int(fi.u), "com_w": _point_to_ints(fi.com_w),
            "x": [int(v) for v in fi.x]}


def finstance_from_ints(d: dict):
    from .kzg.scheme import KzgCommitment
    from .nova.r1cs import FInstance

    def com(v):
        return KzgCommitment(G1Affine(int(v[0]), int(v[1]), bool(v[2])))

    return FInstance(com_e=com(d["com_e"]), u=int(d["u"]), com_w=com(d["com_w"]), x=[int(v) for v in d["x"]])


def augmented_state_to_ints(circuit) -> dict:
    """The augmented circuit's state (i, z_0, z_i, h_i) of either package as plain ints (h_i may be None)."""
    return {"i": int(circuit.i), "z_0": int(circuit.z_0.state), "z_i": int(circuit.z_i.state),
            "h_i": None if circuit.h_i is None else int(circuit.h_i)}


def augmented_state_from_ints(circuit, d: dict):
    """Set a zktpu_torch AugmentedCircuit's (i, z_0, z_i, h_i) from plain ints; returns it."""
    from .nova.circuit import State

    circuit.i, circuit.z_0, circuit.z_i = int(d["i"]), State(int(d["z_0"])), State(int(d["z_i"]))
    circuit.h_i = None if d["h_i"] is None else int(d["h_i"])
    return circuit
