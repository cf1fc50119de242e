"""Numbers drawn from a run's seed: the same seed gives the same inputs."""
from __future__ import annotations

import hashlib

import numpy as np


def u64(seed: int, tag: str, i: int) -> int:
    """A 64-bit number for the i-th draw of `tag` under `seed`."""
    h = hashlib.blake2b(f"{seed}/{tag}/{i}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little")


def field_element(rng: np.random.Generator, modulus: int) -> int:
    """A nonzero element below `modulus`, from four 64-bit draws."""
    while True:
        v = 0
        for w in rng.integers(0, 1 << 63, size=4, dtype=np.int64).tolist():
            v = (v << 63) | w
        v %= modulus
        if v:
            return v


def sample(seed: int, done: list[int], count: int) -> list[int]:
    """`count` of the indices `done` (all of them if fewer), drawn from the seed."""
    k = min(count, len(done))
    return sorted(done[j] for j in np.random.default_rng([seed, 1]).choice(len(done), size=k, replace=False))
