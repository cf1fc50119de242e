"""Carry state across from zktpu: digit planes -> limb tensors, and FRI
proofs of either package -> plain ints.

zktpu stores a field element as D base-2^16 digits in u32 lanes; this package
stores L = D/2 little-endian 32-bit limbs, limb i = d[2i] | d[2i+1] << 16,
with the same Montgomery radix, so the words convert without arithmetic.
Inputs are numpy arrays (``np.asarray`` of zktpu's device arrays); nothing
here imports zktpu's JAX modules.
"""
from __future__ import annotations

import numpy as np
import torch

from .curves.host_curve import G2Affine
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
