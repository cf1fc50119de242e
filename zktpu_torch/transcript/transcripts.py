"""The three Fiat-Shamir transcript variants of the reference, bit-exact.

The port's own copy of zktpu/transcript/transcripts.py.

1. `FriTranscript`  — fri/src/fiat_shamir/transcript.rs:40-139.
   digest = SHA256(prev_digest || index_le_u64 || decimal_string(message));
   challenges = Fp::rand(StdRng::seed_from_u64(LE-u64(digest[0..8]))).

2. `PlonkChallengeGenerator` — plonk/src/challenge.rs:16-107.
   feed = SHA256(prev_digest || serialize_uncompressed(G1 point)); same
   seed->StdRng scheme; no index counter.

3. `NovaTranscript` — nova/src/transcript.rs:17-115.
   Same as PLONK's plus `feed_scalar_num` (uncompressed Fr bytes).

All three panic ("I'm hungry! ...") when challenged twice without feeding;
we raise TranscriptError with the same meaning.
"""
from __future__ import annotations

import hashlib

from ..fields.host import FR, FieldSpec
from .ark_rand import fp_rand
from .chacha import StdRng
from .serialize import fr_bytes, g1_uncompressed, fp_display


class TranscriptError(RuntimeError):
    pass


class FriTranscript:
    """Indexed SHA-256 chain over decimal-printed field elements."""

    def __init__(self, spec: FieldSpec, init_message: int | None = 0):
        self.spec = spec
        self.data: bytes | None = None
        self.index = 0
        self.generated = False  # Rust Default for bool
        if init_message is not None:
            self.digest(init_message)

    def digest(self, message: int) -> None:
        h = hashlib.sha256()
        h.update(self.data or b"")
        h.update(self.index.to_bytes(8, "little"))
        h.update(fp_display(self.spec, message).encode())
        self.data = h.digest()
        self.index += 1
        self.generated = False

    def _rng(self) -> StdRng:
        if self.generated:
            raise TranscriptError("I'm hungry! Feed me something first")
        self.generated = True
        if self.data is None:
            # Rust: unwrap_or_default()[0..8] on an empty vec panics
            raise TranscriptError("transcript has no data")
        seed = int.from_bytes(self.data[:8], "little")
        return StdRng.from_seed_u64(seed)

    def generate_a_challenge(self) -> int:
        return fp_rand(self.spec, self._rng())

    def generate_challenges(self, number: int) -> list[int]:
        rng = self._rng()
        return [fp_rand(self.spec, rng) for _ in range(number)]

    def generate_challenge_list_usize(self, number: int) -> list[int]:
        # field.into_bigint().as_ref()[0]: low 64 bits of the canonical value
        return [c & 0xFFFFFFFFFFFFFFFF for c in self.generate_challenges(number)]


class _G1FeedTranscript:
    """Shared core of PLONK's ChallengeGenerator and Nova's Transcript."""

    def __init__(self):
        self.data: bytes | None = None
        self.generated = False  # Rust Default; generating with no data panics

    def _update(self, payload: bytes) -> None:
        h = hashlib.sha256()
        h.update(self.data or b"")
        h.update(payload)
        self.data = h.digest()
        self.generated = False

    def feed_point(self, point) -> None:
        """point: object with .x, .y canonical ints and .infinity bool."""
        self._update(g1_uncompressed(point.x, point.y, point.infinity))

    def _rng(self) -> StdRng:
        if self.generated:
            raise TranscriptError("I'm hungry! Feed me something first")
        if self.data is None:
            raise TranscriptError("No data to generate seed from")
        self.generated = True
        seed = int.from_bytes(self.data[:8], "little")
        return StdRng.from_seed_u64(seed)

    def generate_challenges(self, number: int) -> list[int]:
        rng = self._rng()
        return [fp_rand(FR, rng) for _ in range(number)]

    def generate_challenge(self) -> int:
        return self.generate_challenges(1)[0]


class PlonkChallengeGenerator(_G1FeedTranscript):
    """plonk/src/challenge.rs — feeds G1 commitments only."""

    feed = _G1FeedTranscript.feed_point

    @classmethod
    def from_commitments(cls, commitments) -> "PlonkChallengeGenerator":
        gen = cls()
        for c in commitments:
            gen.feed(c)
        return gen


class NovaTranscript(_G1FeedTranscript):
    """nova/src/transcript.rs — feeds G1 commitments and Fr scalars."""

    feed = _G1FeedTranscript.feed_point

    def feed_scalar_num(self, num: int) -> None:
        self._update(fr_bytes(num))

    @classmethod
    def from_commitment(cls, commitments) -> "NovaTranscript":
        t = cls()
        for c in commitments:
            t.feed(c)
        return t

    @classmethod
    def from_scalar_number(cls, numbers) -> "NovaTranscript":
        t = cls()
        for n in numbers:
            t.feed_scalar_num(n)
        return t
