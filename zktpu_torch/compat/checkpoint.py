"""Checkpoint and resume (JSON and npz), in zktpu/compat/checkpoint.py's formats.

- SRS -> .npz: the G1 powers as complete-projective (X, Y, Z) planes
  (identity (0 : 1 : 0)), each an (N, 24) uint32 array of base-2^16
  Montgomery digits as zktpu stores them (the port's 32-bit limbs split in
  two, convert.limbs_to_digits), with the size and the G2 points as hex
  strings (meta_hex) and the format tag "srs-projective-v2"; a file without
  the tag is rejected.
- PLONK proof -> JSON: the 9 commitments as affine hex ints, the 6
  evaluations, u and the degree.
- FRI proof -> JSON: the roots, const_val and the decommitments with their
  Merkle paths.
- Nova IVC state -> JSON: an AugmentedCircuit between next_step calls:
  (i, z_0, z_i, z_i1, h_i, h_i1) and the trivial instance.

Ints are hex strings.  The dicts are built in zktpu's key order and written
with json.dump's defaults, so the files are byte for byte zktpu's.
"""
from __future__ import annotations

import json

import numpy as np

from ..convert import limbs_to_digits, srs_from_numpy
from ..curves.host_curve import Fq2, G1Affine, G2Affine
from ..fields.fp import norm_device
from ..fields.host import FR, GOLDILOCKS, FieldSpec
from ..kzg.scheme import KzgCommitment
from ..kzg.srs import Srs


def _h(v: int) -> str:
    return hex(int(v))


def _i(s: str) -> int:
    return int(s, 16)


def _point_obj(c: KzgCommitment) -> dict:
    p = c.point
    return {"x": _h(p.x), "y": _h(p.y), "inf": bool(p.infinity)}


def _point_from(obj: dict) -> KzgCommitment:
    if obj["inf"]:
        return KzgCommitment(G1Affine.identity())
    return KzgCommitment(G1Affine(_i(obj["x"]), _i(obj["y"])))


# -- SRS ----------------------------------------------------------------------

# v2 = complete projective (RCB, identity (0 : 1 : 0)).  Files from before
# the tag held Jacobian coordinates, which the projective reader would
# decode to wrong points, so a file without it is rejected.
_SRS_FORMAT = "srs-projective-v2"


def save_srs(path: str, srs: Srs) -> None:
    X, Y, Z = (limbs_to_digits(a.cpu().numpy()) for a in srs.g1_proj)
    g2, g2s = srs.g2(), srs.g2s()
    meta = [
        srs.size,
        g2.x.c0, g2.x.c1, g2.y.c0, g2.y.c1,
        g2s.x.c0, g2s.x.c1, g2s.y.c0, g2s.y.c1,
    ]
    np.savez_compressed(
        path,
        X=X, Y=Y, Z=Z,
        meta_hex=np.array([_h(v) for v in meta]),
        format=np.array([_SRS_FORMAT]),
    )


def load_srs(path: str, device=None) -> Srs:
    """The SRS of a file of either package, on `device` (default: the current CUDA device)."""
    device = norm_device(device)
    with np.load(path, allow_pickle=False) as data:
        if "format" not in data or str(data["format"][0]) != _SRS_FORMAT:
            found = str(data["format"][0]) if "format" in data else "none (pre-versioning Jacobian)"
            raise ValueError(
                f"SRS checkpoint format mismatch: expected {_SRS_FORMAT!r}, found {found!r}; "
                "regenerate the SRS checkpoint with save_srs"
            )
        meta = [_i(s) for s in data["meta_hex"]]
        planes = tuple(data[k] for k in ("X", "Y", "Z"))
    g2 = G2Affine(Fq2(meta[1], meta[2]), Fq2(meta[3], meta[4]))
    g2s = G2Affine(Fq2(meta[5], meta[6]), Fq2(meta[7], meta[8]))
    return srs_from_numpy(planes, g2, g2s, meta[0], device)


# -- PLONK proof ----------------------------------------------------------------

_PLONK_COMMITS = (
    "a_commit", "b_commit", "c_commit", "z_commit",
    "t_lo_commit", "t_mid_commit", "t_hi_commit",
    "w_ev_x_commit", "w_ev_wx_commit",
)
_PLONK_SCALARS = (
    "bar_a", "bar_b", "bar_c", "bar_s_sigma_1", "bar_s_sigma_2", "bar_z_w", "u",
)


def save_plonk_proof(path: str, proof) -> None:
    obj = {k: _point_obj(getattr(proof, k)) for k in _PLONK_COMMITS}
    obj.update({k: _h(getattr(proof, k)) for k in _PLONK_SCALARS})
    obj["degree"] = proof.degree
    with open(path, "w") as f:
        json.dump(obj, f)


def load_plonk_proof(path: str):
    from ..plonk.prover import Proof

    with open(path) as f:
        obj = json.load(f)
    return Proof(
        **{k: _point_from(obj[k]) for k in _PLONK_COMMITS},
        **{k: _i(obj[k]) for k in _PLONK_SCALARS},
        degree=obj["degree"],
    )


# -- FRI proof ------------------------------------------------------------------


def _merkle_proof_obj(mp) -> dict:
    return {
        "index": mp.index,
        "leaf_val": _h(mp.leaf_val),
        "hash_proof": [_h(v) for v in mp.hash_proof],
        "root": _h(mp.root),
    }


def _merkle_proof_from(obj: dict, spec: FieldSpec):
    from ..fri.merkle import MerkleProof

    return MerkleProof(
        obj["index"], _i(obj["leaf_val"]), [_i(v) for v in obj["hash_proof"]],
        _i(obj["root"]), spec,
    )


def save_fri_proof(path: str, proof) -> None:
    obj = {
        "domain_size": proof.domain_size,
        "coset": _h(proof.coset),
        "number_of_queries": proof.number_of_queries,
        "layers_root": [_h(r) for r in proof.layers_root],
        "const_val": _h(proof.const_val),
        "spec": proof.spec.name,
        "decommitments": [
            {
                "evaluations": [_h(v) for v in d.evaluations],
                "sym_evaluations": [_h(v) for v in d.sym_evaluations],
                "auth_paths": [_merkle_proof_obj(m) for m in d.auth_paths],
                "sym_auth_paths": [_merkle_proof_obj(m) for m in d.sym_auth_paths],
            }
            for d in proof.decommitment_list
        ],
    }
    with open(path, "w") as f:
        json.dump(obj, f)


def load_fri_proof(path: str):
    from ..fri.prover import Decommitment, Proof

    with open(path) as f:
        obj = json.load(f)
    spec = {GOLDILOCKS.name: GOLDILOCKS, FR.name: FR}[obj["spec"]]
    return Proof(
        domain_size=obj["domain_size"],
        coset=_i(obj["coset"]),
        number_of_queries=obj["number_of_queries"],
        layers_root=[_i(r) for r in obj["layers_root"]],
        const_val=_i(obj["const_val"]),
        decommitment_list=[
            Decommitment(
                [_i(v) for v in d["evaluations"]],
                [_merkle_proof_from(m, spec) for m in d["auth_paths"]],
                [_i(v) for v in d["sym_evaluations"]],
                [_merkle_proof_from(m, spec) for m in d["sym_auth_paths"]],
            )
            for d in obj["decommitments"]
        ],
        spec=spec,
    )


# -- Nova IVC state -------------------------------------------------------------


def _instance_obj(inst) -> dict:
    return {
        "com_e": _point_obj(inst.com_e),
        "u": _h(inst.u),
        "com_w": _point_obj(inst.com_w),
        "x": [_h(v) for v in inst.x],
    }


def _instance_from(obj: dict):
    from ..nova.r1cs import FInstance

    return FInstance(
        com_e=_point_from(obj["com_e"]),
        u=_i(obj["u"]),
        com_w=_point_from(obj["com_w"]),
        x=[_i(v) for v in obj["x"]],
    )


def save_ivc_state(path: str, circuit) -> None:
    """Checkpoint an AugmentedCircuit between next_step calls."""
    obj = {
        "i": circuit.i,
        "z_0": _h(circuit.z_0.state),
        "z_i": _h(circuit.z_i.state),
        "z_i1": None if circuit.z_i1 is None else _h(circuit.z_i1.state),
        "h_i": None if circuit.h_i is None else _h(circuit.h_i),
        "h_i1": None if circuit.h_i1 is None else _h(circuit.h_i1),
        "trivial_instance": _instance_obj(circuit.trivial_instance),
    }
    with open(path, "w") as f:
        json.dump(obj, f)


def load_ivc_state(path: str, f_circuit):
    """A fresh AugmentedCircuit over `f_circuit` in the checkpointed state."""
    from ..nova.circuit import AugmentedCircuit, State

    with open(path) as f:
        obj = json.load(f)
    circuit = AugmentedCircuit(
        f_circuit, _instance_from(obj["trivial_instance"]), State(_i(obj["z_0"]))
    )
    circuit.i = obj["i"]
    circuit.z_i = State(_i(obj["z_i"]))
    circuit.z_i1 = None if obj["z_i1"] is None else State(_i(obj["z_i1"]))
    circuit.h_i = None if obj["h_i"] is None else _i(obj["h_i"])
    circuit.h_i1 = None if obj["h_i1"] is None else _i(obj["h_i1"])
    return circuit
