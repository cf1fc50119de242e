"""FRI verifier (counterpart of zktpu/fri/verifier.py, which mirrors
fri/src/verifier.rs:14-113).

Replays the transcript over the layer roots, regenerates the query indices,
checks Merkle paths and the per-layer fold identity

    q_fold = (r + w_i) e / (2 w_i) - (r - w_i) e_sym / (2 w_i)

(verifier.rs:93-96) against the next layer's evaluation / the final constant.
Host ints throughout; w_i is the domain element of Radix2Domain.element,
computed without building the domain's tables.
"""
from __future__ import annotations

from ..fields.host import FieldSpec
from ..transcript.transcripts import FriTranscript
from .merkle import verify_merkle_proof
from .prover import Decommitment, Proof


def verify(proof: Proof) -> None:
    """Raises FriVerificationError on failure (Result<(), String> analogue)."""
    spec = proof.spec
    transcript = FriTranscript(spec, 0)
    random_r_list = []
    for root in proof.layers_root:
        transcript.digest(root)
        random_r_list.append(transcript.generate_a_challenge())
    transcript.digest(proof.const_val)

    new_challenge_list = [
        v % proof.domain_size
        for v in transcript.generate_challenge_list_usize(proof.number_of_queries)
    ]

    for challenge, decommitment in zip(new_challenge_list, proof.decommitment_list):
        _verify_query(
            spec,
            challenge,
            decommitment,
            random_r_list,
            proof.domain_size,
            proof.const_val,
            proof.coset,
        )


class FriVerificationError(Exception):
    pass


def _domain_element(spec: FieldSpec, size: int, i: int) -> int:
    """get_domain(spec, size).element(i): w^i for the size's root of unity w."""
    return spec.pow(spec.root_of_unity(size), i % size)


def _verify_query(
    spec: FieldSpec,
    challenge: int,
    decommitment: Decommitment,
    random_r_list: list[int],
    domain_size: int,
    const_val: int,
    coset: int,
) -> None:
    cur_domain_size = domain_size
    cur_coset = coset
    two_inv = spec.inv(2)

    items = zip(
        decommitment.evaluations,
        decommitment.auth_paths,
        decommitment.sym_evaluations,
        decommitment.sym_auth_paths,
        random_r_list,
    )
    num_layers = len(decommitment.evaluations)
    for i, (ev, path, sym_ev, sym_path, r) in enumerate(items):
        index = challenge % cur_domain_size
        sym_index = (index + cur_domain_size // 2) % cur_domain_size

        if index != path.index or sym_index != sym_path.index:
            raise FriVerificationError("wrong index!")
        if ev != path.leaf_val or sym_ev != sym_path.leaf_val:
            raise FriVerificationError("the evaluation does not correspond to given path!")
        if not verify_merkle_proof(path) or not verify_merkle_proof(sym_path):
            raise FriVerificationError("verify Merkle path failed!")

        w_i = spec.mul(_domain_element(spec, cur_domain_size, index), cur_coset)
        inv_2w = spec.mul(two_inv, spec.inv(w_i))
        q_fold = spec.sub(
            spec.mul(spec.mul(spec.add(r, w_i), ev), inv_2w),
            spec.mul(spec.mul(spec.sub(r, w_i), sym_ev), inv_2w),
        )

        if i != num_layers - 1:
            if q_fold != decommitment.evaluations[i + 1]:
                raise FriVerificationError("folding wrong!")
            cur_domain_size //= 2
            cur_coset = spec.mul(cur_coset, cur_coset)
            continue
        if q_fold != const_val:
            raise FriVerificationError("folding wrong!")
