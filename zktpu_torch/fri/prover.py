"""FRI prover: folding phase + query phase (counterpart of zktpu/fri/prover.py,
which mirrors fri/src/prover.rs).

Protocol shape is identical to the reference:
  - domain_size = next_pow2(len(coeffs) * blowup), coset = F::GENERATOR,
    #layers = log2(domain_size)  (prover.rs:141-168)
  - per layer: coset-NTT evaluate + Merkle commit, digest root, draw the fold
    challenge, fold even/odd, square the coset, halve the domain
    (prover.rs:47-75)
  - queries: usize challenges mod domain, with symmetric indices and Merkle
    paths per layer (prover.rs:81-134)

On the device each layer is the Goldilocks NTT with ``from_mont`` fused
into its last store (kernel 1g), one hash launch per tree level (kernel 6),
one root read, and the fold in one launch (fri/fold_kernel.py).  The query
phase reads each layer's queried evaluations and paths in one copy.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.fp import limbs_to_ints
from ..fields.host import GOLDILOCKS, FieldSpec
from ..poly.poly import Poly
from ..transcript.transcripts import FriTranscript
from .fold_kernel import fold
from .layer import FriLayer, timed
from .merkle import MerkleProof


@dataclass
class Decommitment:
    evaluations: list[int]
    auth_paths: list[MerkleProof]
    sym_evaluations: list[int]
    sym_auth_paths: list[MerkleProof]


@dataclass
class Proof:
    domain_size: int
    coset: int
    number_of_queries: int
    layers_root: list[int]
    const_val: int
    decommitment_list: list[Decommitment]
    spec: FieldSpec = GOLDILOCKS


def fold_polynomial(poly: Poly, random_r: int) -> Poly:
    """new_coeff = even_coeff + r * odd_coeff (prover.rs:34-42): one launch of
    the fold kernel on the card."""
    coeffs = poly.coeffs
    if coeffs.shape[0] <= 1:  # no odd half
        return Poly(poly.spec, coeffs[0::2])
    return Poly(poly.spec, fold(poly.spec, coeffs, random_r))


def folding_phase(poly: Poly, coset: int, domain_size: int, number_layers: int, force_device: bool | None = None,
                  timings: dict | None = None):
    """timings: if given, gets the seconds of the layers' coset NTTs ("ntt"),
    trees ("hash"), root reads and challenges ("root") and folds ("fold"),
    summed over the layers, the card synchronized around each."""
    spec = poly.spec
    transcript = FriTranscript(spec, 0)
    fri_layers: list[FriLayer] = []
    for _ in range(number_layers):
        layer = FriLayer.from_poly(poly, coset, domain_size, force_device, timings)
        with timed(timings, "root", poly.device):
            transcript.digest(layer.merkle_tree.root())
            r = transcript.generate_a_challenge()
        fri_layers.append(layer)
        with timed(timings, "fold", poly.device):
            poly = fold_polynomial(poly, r)
        coset = spec.mul(coset, coset)
        domain_size //= 2
    assert len(poly) == 1, "final polynomial must be constant"
    constant = spec.from_mont(limbs_to_ints(poly.coeffs.cpu().numpy())[0])  # one copy, no launch
    transcript.digest(constant)
    return constant, transcript, fri_layers


def query_phase(number_of_queries: int, domain_size: int, transcript: FriTranscript, fri_layers: list[FriLayer]):
    if not fri_layers:
        return [], []
    challenge_list = [
        v % domain_size
        for v in transcript.generate_challenge_list_usize(number_of_queries)
    ]
    q = len(challenge_list)
    decommitment_list = [Decommitment([], [], [], []) for _ in challenge_list]
    for layer in fri_layers:
        ds = layer.domain_size
        index = [c % ds for c in challenge_list]
        sym_index = [(i + ds // 2) % ds for i in index]
        proofs = layer.merkle_tree.generate_proofs(index + sym_index)  # one read: leaves and paths
        for d, path, sym_path in zip(decommitment_list, proofs[:q], proofs[q:]):
            d.evaluations.append(path.leaf_val)  # the leaf is the layer's evaluation at the index
            d.auth_paths.append(path)
            d.sym_evaluations.append(sym_path.leaf_val)
            d.sym_auth_paths.append(sym_path)
    return decommitment_list, challenge_list


def generate_proof(poly: Poly, blowup_factor: int, number_of_queries: int, force_device: bool | None = None,
                   timings: dict | None = None) -> Proof:
    """The FRI proof of `poly` on its device.  force_device: the NTT and the
    hash on tensors at every size (the default on a CUDA device); otherwise
    zktpu's size tiers.  timings: as folding_phase's, plus "query"."""
    spec = poly.spec
    n = len(poly) * blowup_factor
    domain_size = 1 << (n - 1).bit_length() if n > 1 else 1
    coset = spec.generator
    number_of_layers = domain_size.bit_length() - 1

    const_val, transcript, fri_layers = folding_phase(
        poly, coset, domain_size, number_of_layers, force_device, timings
    )
    with timed(timings, "query", poly.device):
        decommitment_list, _ = query_phase(
            number_of_queries, domain_size, transcript, fri_layers
        )
    return Proof(
        domain_size=domain_size,
        coset=coset,
        number_of_queries=number_of_queries,
        layers_root=[l.merkle_tree.root() for l in fri_layers],
        const_val=const_val,
        decommitment_list=decommitment_list,
        spec=spec,
    )
