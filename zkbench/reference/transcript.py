"""The PLONK prover's randomness and Fiat-Shamir transcript, for the reference.

- StdRng: Rust rand 0.8's StdRng (ChaCha12), seeded by rand_core's
  seed_from_u64 (PCG32 XSH-RR expansion of a u64 into a 32-byte key).
- fp_rand: arkworks 0.4's UniformRand for an Fr element: four u64 words,
  the top one masked to 255 bits, rejected when not below r, and read as a
  Montgomery form (times 2^-256).
- Transcript: the challenge generator of sota-zk-labs/zkp-implementation's
  plonk/src/challenge.rs: each commitment is fed as SHA-256(previous digest ||
  the point's 96-byte uncompressed arkworks encoding); a challenge round seeds
  a StdRng with the digest's first 8 bytes (little-endian) and draws field
  elements from it.
"""
from __future__ import annotations

import hashlib

from .curve import Q, R

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _rotl(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _M32


def _chacha_block(key: list[int], counter: int, rounds: int = 12) -> list[int]:
    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574, *key, counter & _M32, counter >> 32, 0, 0]
    w = list(state)
    quarters = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
                (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))
    for _ in range(rounds // 2):
        for a, b, c, d in quarters:
            w[a] = (w[a] + w[b]) & _M32
            w[d] = _rotl(w[d] ^ w[a], 16)
            w[c] = (w[c] + w[d]) & _M32
            w[b] = _rotl(w[b] ^ w[c], 12)
            w[a] = (w[a] + w[b]) & _M32
            w[d] = _rotl(w[d] ^ w[a], 8)
            w[c] = (w[c] + w[d]) & _M32
            w[b] = _rotl(w[b] ^ w[c], 7)
    return [(x + s) & _M32 for x, s in zip(w, state)]


class StdRng:
    def __init__(self, seed_u64: int):
        state, key = seed_u64 & _M64, []
        for _ in range(8):
            state = (state * 6364136223846793005 + 11634580027462260723) & _M64
            xs = (((state >> 18) ^ state) >> 27) & _M32
            rot = state >> 59
            key.append(((xs >> rot) | (xs << ((32 - rot) & 31))) & _M32)
        self._key, self._counter, self._buf = key, 0, []

    def next_u32(self) -> int:
        if not self._buf:
            self._buf = _chacha_block(self._key, self._counter)[::-1]
            self._counter += 1
        return self._buf.pop()

    def next_u64(self) -> int:
        lo = self.next_u32()
        return lo | (self.next_u32() << 32)


def fp_rand(rng: StdRng) -> int:
    r_inv = pow(1 << 256, -1, R)
    while True:
        words = [rng.next_u64() for _ in range(4)]
        words[3] &= (1 << 63) - 1
        v = words[0] | words[1] << 64 | words[2] << 128 | words[3] << 192
        if v < R:
            return v * r_inv % R


def g1_bytes(point) -> bytes:
    """arkworks 0.4 serialize_uncompressed of a G1 affine point (None: the identity)."""
    if point is None:
        x, y, flag = 0, 0, 1 << 6
    else:
        x, y = point
        flag = (1 << 7) if y > Q - y else 0
    yb = bytearray(y.to_bytes(48, "little"))
    yb[-1] |= flag
    return x.to_bytes(48, "little") + bytes(yb)


class Transcript:
    def __init__(self):
        self._digest = b""

    def feed(self, point) -> None:
        self._digest = hashlib.sha256(self._digest + g1_bytes(point)).digest()

    def challenges(self, count: int) -> list[int]:
        rng = StdRng(int.from_bytes(self._digest[:8], "little"))
        return [fp_rand(rng) for _ in range(count)]
