"""Bit-exact replication of Rust `rand::rngs::StdRng` (rand 0.8 = ChaCha12).

The port's own copy of zktpu/transcript/chacha.py.

The reference derives every Fiat-Shamir challenge by seeding `StdRng` from the
first 8 LE bytes of a SHA-256 digest (fri/src/fiat_shamir/transcript.rs:90-99,
plonk/src/challenge.rs:60-71, nova/src/transcript.rs:91-99) and then sampling
field elements.  Challenge bit-exactness therefore requires an exact ChaCha12
keystream plus rand_core's `seed_from_u64` seed-expansion (a PCG32 XSH-RR
generator filling the 32-byte seed).

Pure-Python host implementation: challenge derivation is O(1) per round and
never on the device hot path.
"""
from __future__ import annotations

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _MASK32


def _quarter_round(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & _MASK32
    s[d] = _rotl32(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] = _rotl32(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _MASK32
    s[d] = _rotl32(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] = _rotl32(s[b] ^ s[c], 7)


def chacha_block(key_words, counter: int, stream_words, rounds: int):
    """One ChaCha block (rand_chacha layout: 64-bit counter in words 12-13,
    64-bit stream id in words 14-15).  Returns 16 output u32 words."""
    state = [
        0x61707865,
        0x3320646E,
        0x79622D32,
        0x6B206574,
        *key_words,
        counter & _MASK32,
        (counter >> 32) & _MASK32,
        stream_words[0],
        stream_words[1],
    ]
    w = list(state)
    for _ in range(rounds // 2):
        _quarter_round(w, 0, 4, 8, 12)
        _quarter_round(w, 1, 5, 9, 13)
        _quarter_round(w, 2, 6, 10, 14)
        _quarter_round(w, 3, 7, 11, 15)
        _quarter_round(w, 0, 5, 10, 15)
        _quarter_round(w, 1, 6, 11, 12)
        _quarter_round(w, 2, 7, 8, 13)
        _quarter_round(w, 3, 4, 9, 14)
    return [(w[i] + state[i]) & _MASK32 for i in range(16)]


class ChaChaRng:
    """ChaCha-based RNG with rand_core BlockRng word-stream semantics."""

    def __init__(self, seed: bytes, rounds: int = 12, stream: int = 0):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[4 * i : 4 * i + 4], "little") for i in range(8)]
        self.rounds = rounds
        self.stream = [stream & _MASK32, (stream >> 32) & _MASK32]
        self.counter = 0
        self.buf: list[int] = []
        self.idx = 0

    def _refill(self):
        self.buf = chacha_block(self.key, self.counter, self.stream, self.rounds)
        self.counter += 1
        self.idx = 0

    def next_u32(self) -> int:
        if self.idx >= len(self.buf):
            self._refill()
        v = self.buf[self.idx]
        self.idx += 1
        return v

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)


def seed_from_u64(state: int) -> bytes:
    """rand_core::SeedableRng::seed_from_u64 — PCG32 (XSH-RR) seed expansion."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    out = bytearray()
    for _ in range(8):  # 32-byte seed, 4 bytes per PCG output
        state = (state * MUL + INC) & _MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & _MASK32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _MASK32
        out += x.to_bytes(4, "little")
    return bytes(out)


class StdRng(ChaChaRng):
    """rand 0.8 StdRng = ChaCha12Rng."""

    def __init__(self, seed: bytes):
        super().__init__(seed, rounds=12)

    @classmethod
    def from_seed_u64(cls, seed: int) -> "StdRng":
        return cls(seed_from_u64(seed & _MASK64))

    def gen_u128(self) -> int:
        """rand Rng::gen::<u128> — low u64 then high u64."""
        lo = self.next_u64()
        hi = self.next_u64()
        return lo | (hi << 64)
