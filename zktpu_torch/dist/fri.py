"""The FRI layer over a mesh: coset evaluation and Merkle commitment
(counterpart of zktpu/dist/fri.py).

- The coset evaluations come from the four-step NTT (each rank scales and
  transforms its rows; three all_to_alls);
- every Merkle level is hashed in shards (hash_field: the field-hash kernel
  on a card), each rank its share of the values or pairs, then gathered
  (all_gather), so every rank holds the whole level;
- the levels too short to share (the top log2 P or so: the frontier) are
  hashed on the host, as zktpu does.
The evaluations, levels, root and proofs are the single-device
FriLayer.from_poly's.
"""
from __future__ import annotations

import torch

from ..fields.fp import field, ints_to_limbs, limbs_to_ints
from ..fields.host import GOLDILOCKS, FieldSpec
from ..fri.layer import FriLayer
from ..fri.merkle import MerkleTree
from ..hash.host_hash import hash_slice
from ..hash.sha256_kernel import hash_field
from ..poly.poly import Poly
from .mesh import Mesh
from .ntt import get_four_step


def _hash_sharded(level: torch.Tensor, pairs: bool, mesh: Mesh) -> torch.Tensor:
    """hash (pairs False) or hash of consecutive pairs of a whole level of
    canonical values, (n, 2) limbs, each rank hashing its share: the whole
    result on every rank."""
    width = 2 if pairs else 1
    m = level.shape[0] // width
    per = -(-m // mesh.size)
    lo = min(mesh.rank * per, m)
    hi = min(lo + per, m)
    mine = torch.zeros((per, 2), dtype=torch.int32, device=level.device)
    if hi > lo:
        mine[: hi - lo] = hash_field(level[lo * width:hi * width], pairs)
    return mesh.all_gather(mine)[:m]


def dist_merkle_tree(values, spec: FieldSpec, mesh: Mesh) -> MerkleTree:
    """MerkleTree(values, spec) with every level of at least 2P values hashed
    in shards (the reference's quirks kept: unpadded level 0, a trailing
    singleton hashed alone, zero-padded `leaves`).  values: the whole list
    of canonical values, an (n, 2) limb tensor or ints."""
    assert spec is GOLDILOCKS, "the sharded Merkle tree is Goldilocks-only"
    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(ints_to_limbs([int(v) % spec.modulus for v in values], 2)).to(mesh.device)
    levels = [_hash_sharded(values, False, mesh)]
    while len(levels[-1]) > 1:
        prev = levels[-1]
        if len(prev) % 2 == 0 and len(prev) >= 2 * mesh.size:
            if not isinstance(prev, torch.Tensor):
                prev = torch.from_numpy(ints_to_limbs(prev, 2)).to(mesh.device)
            nxt = _hash_sharded(prev, True, mesh)
        else:  # the frontier, on the host
            vals = limbs_to_ints(prev.cpu().numpy()) if isinstance(prev, torch.Tensor) else prev
            nxt = [hash_slice(spec, vals[j:j + 2]) for j in range(0, len(vals), 2)]
        levels.append(nxt)
    return MerkleTree.from_levels(values, levels, spec)


def dist_coset_evals(poly: Poly, coset: int, domain_size: int, mesh: Mesh) -> torch.Tensor:
    """This rank's n/P values of [p(coset w^i)]_(i < n), Montgomery limbs: the
    rows of Radix2Domain.coset_fft's output, word for word."""
    spec = poly.spec
    df = field(spec, mesh.device)
    fs = get_four_step(spec, domain_size, mesh)
    rows = domain_size // mesh.size
    start = mesh.rank * rows
    coeffs = poly._padded(domain_size)[start:start + rows].to(mesh.device)
    scale = df.mont_mul(df.powers(coset, rows), df.encode_int(spec.pow(coset, start)))  # coset^(start + t)
    return fs.fft(df.mont_mul(coeffs, scale))


def dist_fri_layer(poly: Poly, coset: int, domain_size: int, mesh: Mesh) -> FriLayer:
    """FriLayer.from_poly over the mesh: the whole layer on every rank."""
    assert poly.spec is GOLDILOCKS
    df = field(poly.spec, mesh.device)
    evals = dist_coset_evals(poly, coset, domain_size, mesh)
    vals = mesh.all_gather(df.from_mont(evals))  # canonical values, (n, 2)
    return FriLayer(vals, dist_merkle_tree(vals, poly.spec, mesh), coset, domain_size)
