"""Reference-exact field-element hashing (fri/src/hasher.rs).

The port's own copy of zktpu/hash/host_hash.py.

hash(x)        = SHA256(decimal_string(x))          -> field element
hash_slice(xs) = SHA256(concat decimal strings)     -> field element
where the digest is mapped into the field via from_le_bytes_mod_order.
"""
from __future__ import annotations

import hashlib

from ..fields.host import FieldSpec


def hash_elem(spec: FieldSpec, x: int) -> int:
    h = hashlib.sha256(str(x % spec.modulus).encode()).digest()
    return spec.from_le_bytes_mod_order(h)


def hash_slice(spec: FieldSpec, xs) -> int:
    h = hashlib.sha256()
    for x in xs:
        h.update(str(int(x) % spec.modulus).encode())
    return spec.from_le_bytes_mod_order(h.digest())
