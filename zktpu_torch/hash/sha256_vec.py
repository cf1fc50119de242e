"""Bulk field hashing for Merkle trees (counterpart of zktpu/hash/sha256_vec.py).

``hash_elems_vec`` hashes each value and ``hash_pairs_vec`` each consecutive
pair, as the reference's functions of the same names (:205-225).  Over
Goldilocks they take and return values on the device: (n, 2) int32 limbs of
canonical values (not Montgomery form), through kernel 6
(hash/sha256_kernel.py: the CUDA kernel for a CUDA tensor, its plain
version for a CPU one).  A sequence of Python ints is first placed on
`device`.  Other fields hash on the host with hashlib and return Python
ints, as the reference does (:207-210, :218-221): that is the reference's
own semantics for them, not a device fallback.
"""
from __future__ import annotations

import torch

from ..fields.fp import ints_to_limbs, limbs_to_ints, norm_device
from ..fields.host import GOLDILOCKS, FieldSpec
from .host_hash import hash_elem, hash_slice
from .sha256_kernel import hash_field


def _canonical(values, device) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values
    p = GOLDILOCKS.modulus
    return torch.from_numpy(ints_to_limbs([int(v) % p for v in values], 2)).to(norm_device(device))


def _ints(values) -> list[int]:
    if isinstance(values, torch.Tensor):
        return limbs_to_ints(values.cpu().numpy())
    return [int(v) for v in values]


def hash_elems_vec(spec: FieldSpec, values, device=None):
    """hash(x) for each x: (n, 2) limbs in, (n, 2) out (Goldilocks), else ints."""
    if spec is not GOLDILOCKS:
        return [hash_elem(spec, v) for v in _ints(values)]
    return hash_field(_canonical(values, device), pairs=False)


def hash_pairs_vec(spec: FieldSpec, level, device=None):
    """hash_slice([a, b]) over consecutive pairs of `level` (a trailing
    singleton hashed alone): (n, 2) limbs in, (ceil(n / 2), 2) out
    (Goldilocks), else ints."""
    if spec is not GOLDILOCKS:
        vals = _ints(level)
        return [hash_slice(spec, vals[i : i + 2]) for i in range(0, len(vals), 2)]
    return hash_field(_canonical(level, device), pairs=True)
