"""Merkle tree over field elements (counterpart of zktpu/fri/merkle.py, which
mirrors fri/src/merkle_tree.rs:7-132).

Reference quirks preserved:
  - level 0 hashes the *unpadded* evaluation list; only ``leaves`` is padded
    to the next power of two with zeros (merkle_tree.rs:42-62);
  - inner levels hash chunks of two (a trailing singleton chunk is hashed
    alone);
  - generate_proof takes the neighbour at cur + 1 or cur - 1 and raises
    IndexError for an out-of-range neighbour, as the reference's list
    indexing does.

Where the levels live.  The reference keeps every level as a list of Python
ints.  Here a Goldilocks level hashed on the vector path is a tensor of
canonical values ((n, 2) int32 limbs, not Montgomery form) on the device of
the evaluations, and stays there: ``root`` reads one value,
``generate_proofs`` reads the leaves and path entries its queries need in
one copy, and ``internal_nodes`` turns the levels into ints only when asked.

Which path hashes a level: the reference's tiers, the vector path
(hash/sha256_vec.py) for level 0 of at least _VEC_THRESHOLD values and for an
inner level of an even length of at least that many, per-element host
hashing otherwise.  ``force_device`` sends every level to the vector path,
and it is the default for evaluations on a CUDA device: there a small level
costs one launch, while host hashing would copy it to the host.  Both paths
give the same values.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields.fp import limbs_to_ints
from ..fields.host import GOLDILOCKS, FieldSpec
from ..hash.host_hash import hash_elem, hash_slice
from ..hash.sha256_vec import hash_elems_vec, hash_pairs_vec

_VEC_THRESHOLD = 1 << 12


@dataclass
class MerkleProof:
    index: int
    leaf_val: int
    hash_proof: list[int]
    root: int
    spec: FieldSpec = GOLDILOCKS


def _padded_len(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _ints(level) -> list[int]:
    """A level or a value list as Python ints (a tensor is copied to the host)."""
    if isinstance(level, torch.Tensor):
        if level.shape[-1] == 2:
            return np.ascontiguousarray(level.cpu().numpy()).view("<u8")[:, 0].tolist()
        return limbs_to_ints(level.cpu().numpy())
    return [int(v) for v in level]


class MerkleTree:
    """evaluations: canonical values, an (n, L) int32 limb tensor or a
    sequence of ints; device: where a sequence of Goldilocks values goes for
    the vector path (default: the current CUDA device)."""

    def __init__(self, evaluations, spec: FieldSpec = GOLDILOCKS, force_device: bool | None = None, device=None):
        self.spec = spec
        if isinstance(evaluations, torch.Tensor):
            self._values, self._device = evaluations, evaluations.device
            force = evaluations.is_cuda if force_device is None else force_device
        else:
            self._values, self._device = [int(v) for v in evaluations], device
            force = bool(force_device)
        n = len(self._values)
        self.depth = _padded_len(n).bit_length() - 1
        if force or n >= _VEC_THRESHOLD:
            first = hash_elems_vec(spec, self._values, self._device)
        else:
            first = [hash_elem(spec, v) for v in _ints(self._values)]
        levels = [first]
        for i in range(self.depth):
            prev = levels[i]
            if force or (len(prev) >= _VEC_THRESHOLD and len(prev) % 2 == 0):
                nxt = hash_pairs_vec(spec, prev, self._device)
            else:
                vals = _ints(prev)
                nxt = [hash_slice(spec, vals[j : j + 2]) for j in range(0, len(vals), 2)]
            levels.append(nxt)
        self._levels = levels
        self._nodes = None
        self._root = None

    @classmethod
    def from_levels(cls, evaluations, internal_nodes, spec: FieldSpec = GOLDILOCKS) -> "MerkleTree":
        """Assemble a tree whose level hashes were computed elsewhere (ints or
        (n, 2) tensors, e.g. a sharded hasher); same layout as __init__."""
        obj = cls.__new__(cls)
        obj.spec = spec
        if isinstance(evaluations, torch.Tensor):
            obj._values, obj._device = evaluations, evaluations.device
        else:
            obj._values, obj._device = [int(v) for v in evaluations], None
        obj.depth = _padded_len(len(obj._values)).bit_length() - 1
        assert len(internal_nodes) == obj.depth + 1, (len(internal_nodes), obj.depth)
        obj._levels = [lvl if isinstance(lvl, torch.Tensor) else [int(v) for v in lvl] for lvl in internal_nodes]
        obj._nodes = None
        obj._root = None
        return obj

    @property
    def levels(self) -> list:
        """The levels as stored: (n, 2) tensors of canonical values or int lists."""
        return self._levels

    @property
    def internal_nodes(self) -> list[list[int]]:
        """Every level as Python ints (copied from the device once, on first use)."""
        if self._nodes is None:
            self._nodes = [_ints(lvl) for lvl in self._levels]
        return self._nodes

    @property
    def leaves(self) -> list[int]:
        vals = _ints(self._values)
        return vals + [0] * (_padded_len(len(vals)) - len(vals))

    def root(self) -> int:
        if self._root is None:
            top = self._levels[-1]
            self._root = _ints(top[:1])[0] if isinstance(top, torch.Tensor) else top[0]
        return self._root

    def generate_proof(self, index: int) -> MerkleProof:
        return self.generate_proofs([index])[0]

    def generate_proofs(self, indices) -> list[MerkleProof]:
        """The proofs of several leaves, with one copy from the device for all
        of their leaf values and path entries."""
        indices = [int(i) for i in indices]
        n = len(self._values)
        for i in indices:
            if not 0 <= i < _padded_len(n):
                raise IndexError(f"leaf index {i} out of range for {_padded_len(n)} leaves")
        paths, cur = [], list(indices)
        for lvl in self._levels[: self.depth]:
            nb = [c + 1 if c % 2 == 0 else c - 1 for c in cur]
            if max(nb) >= len(lvl):
                raise IndexError(f"neighbour index out of range for a level of {len(lvl)}")
            paths.append(nb)
            cur = [c // 2 for c in cur]
        real = [i for i in indices if i < n]
        reads = [(lvl, pos) for lvl, pos in zip(self._levels, paths) if isinstance(lvl, torch.Tensor)]
        if isinstance(self._values, torch.Tensor):
            reads.append((self._values, real))
        got = iter(self._gather(reads))
        path_vals = [next(got) if isinstance(lvl, torch.Tensor) else [lvl[j] for j in pos]
                     for lvl, pos in zip(self._levels, paths)]
        leaf_vals = next(got) if isinstance(self._values, torch.Tensor) else [self._values[i] for i in real]
        leaf_of = dict(zip(real, leaf_vals))
        root = self.root()
        return [MerkleProof(i, leaf_of.get(i, 0), [vals[q] for vals in path_vals], root, self.spec)
                for q, i in enumerate(indices)]

    @staticmethod
    def _gather(reads) -> list[list[int]]:
        """[(tensor, positions)] -> the rows at those positions as ints, read
        from the device in one copy (every tensor has the same row width:
        Goldilocks levels and values, or the values alone)."""
        if not reads:
            return []
        dev = reads[0][0].device
        flat = torch.tensor([j for _, pos in reads for j in pos], dtype=torch.int64, device=dev)
        parts, start = [], 0
        for t, pos in reads:
            parts.append(t.index_select(0, flat[start : start + len(pos)]))
            start += len(pos)
        vals = _ints(torch.cat(parts))
        out, start = [], 0
        for _, pos in reads:
            out.append(vals[start : start + len(pos)])
            start += len(pos)
        return out


def verify_merkle_proof(proof: MerkleProof) -> bool:
    spec = proof.spec
    cur_index = proof.index
    cur_hash = hash_elem(spec, proof.leaf_val)
    for neighbour in proof.hash_proof:
        if cur_index % 2 == 0:
            cur_hash = hash_slice(spec, [cur_hash, neighbour])
        else:
            cur_hash = hash_slice(spec, [neighbour, cur_hash])
        cur_index //= 2
    return cur_hash == proof.root
