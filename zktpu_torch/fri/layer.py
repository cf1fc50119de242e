"""FRI layer: coset evaluation + Merkle commitment (counterpart of
zktpu/fri/layer.py; the reference is fri/src/fri_layer.rs).

The reference evaluates the polynomial pointwise at every domain element
(O(n d), fri_layer.rs:40-46); zktpu and the port take one coset NTT, which
yields the same evaluations [p(coset w^i)]_{i<n} in natural order.  In the
port the NTT is kernel 1g (poly/ntt_kernel.py, the Goldilocks design),
whose last store multiplies by the raw 1 (``from_mont``) so that it yields
canonical values, and the tree hashes those values where they are
(fri/merkle.py): nothing goes to the host but the root.
"""
from __future__ import annotations

import contextlib
import time

import torch

from ..poly.domain import get_domain
from ..poly.poly import Poly
from .merkle import MerkleTree


class FriLayer:
    def __init__(self, evaluations: torch.Tensor, merkle_tree: MerkleTree, coset: int, domain_size: int):
        self.evaluations = evaluations  # canonical values, (n, L) int32 limbs on the poly's device
        self.merkle_tree = merkle_tree
        self.coset = coset
        self.domain_size = domain_size

    @classmethod
    def from_poly(cls, poly: Poly, coset: int, domain_size: int, force_device: bool | None = None,
                  timings: dict | None = None) -> "FriLayer":
        """force_device: the tensor NTT and the vector hash at every size (the
        default on a CUDA device); otherwise the domain's and the tree's size
        tiers, as zktpu runs them.  timings: adds the seconds of the NTT with
        its fused from_mont ("ntt") and of the tree ("hash")."""
        force = poly.device.type == "cuda" if force_device is None else force_device
        with timed(timings, "ntt", poly.device):
            dom = get_domain(poly.spec, domain_size, poly.device)
            assert dom.size == domain_size
            # the raw 1 as the output factor: x * 1 * R^-1, canonical values
            vals = dom.coset_fft(poly._padded(dom.size), coset, force_device=force, out_factor=poly.df._one_raw)
        with timed(timings, "hash", poly.device):
            tree = MerkleTree(vals, poly.spec, force_device=force)
        return cls(vals, tree, coset, domain_size)


@contextlib.contextmanager
def timed(timings: dict | None, key: str, device: torch.device):
    """Add the seconds of the block to timings[key], synchronizing the card
    at both ends (nothing when timings is None)."""
    if timings is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0

