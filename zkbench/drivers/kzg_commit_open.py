"""Driver of a KZG commit-and-open stream.

Inputs from the run's seed: the SRS secret (numpy's default_rng(seed)), a
pool of polynomials whose coefficients are drawn on the device by a
torch.Generator seeded from the seed (8 words of 32 bits each, the top word
cut to 30 bits, so every coefficient is below 2^254 < r), and for request i
an opening point drawn from the seed.  Request i commits polynomial i mod
pool and opens it at its point.  The check recomputes every finished
request with the plain reference (../reference/kzg.py) and counts the
commitments, opening witnesses and evaluations that differ.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from zkbench import seeds
from zkbench.reference.curve import R


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.length = int(config["coefficients"])
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        rng = np.random.default_rng([seed, 0])
        self.secret = seeds.field_element(rng, R)
        self.pool = int(traffic["poly_pool"])
        self.scheme = self.polys = None

    def words(self, k: int) -> torch.Tensor:
        """Polynomial k's coefficients as (length, 8) canonical little-endian
        32-bit words (int32 bit patterns), made on the device."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seeds.u64(self.seed, "poly", k))
        w = torch.randint(0, 1 << 32, (self.length, 8), generator=g, device=self.device, dtype=torch.int64)
        w[:, 7] &= (1 << 30) - 1
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)

    def point(self, i: int) -> int:
        return seeds.u64(self.seed, "point", i) * seeds.u64(self.seed, "point-hi", i) % R

    def build(self) -> None:
        """The program's state: the SRS, the scheme and the pool's polynomials."""
        from zktpu_torch.fields.fp import field
        from zktpu_torch.fields.host import FR
        from zktpu_torch.kzg.scheme import KzgScheme
        from zktpu_torch.kzg.srs import Srs
        from zktpu_torch.poly.poly import Poly

        self.scheme = KzgScheme(Srs.new_from_secret(self.secret, self.length, device=self.device))
        df = field(FR, self.device)
        self.polys = [Poly(FR, df.to_mont(self.words(k))) for k in range(self.pool)]

    def _commit_open(self, k: int, z: int):
        poly = self.polys[k % self.pool]
        return self.scheme.commit(poly), self.scheme.open(poly, z)

    def warm(self) -> None:
        self._commit_open(0, seeds.u64(self.seed, "warm", 0) % R)

    def request(self, i: int):
        return self._commit_open(i, self.point(i))

    def free(self) -> None:
        self.scheme = self.polys = None
        gc.collect()

    def picks(self, answers: list) -> list[int]:
        return [i for i, a in enumerate(answers) if a is not None]

    def reference(self, indices: list[int], scalar_bits: int = 256) -> dict:
        """{i: the reference's answer to request i}; scalar_bits below 256: the control's."""
        from zkbench.reference.kzg import KzgReference

        ref = KzgReference(self.secret, self.length, self.device, scalar_bits=scalar_bits)
        out = {}
        for k in range(self.pool):
            mine = [i for i in indices if i % self.pool == k]
            if mine:
                coeffs = ref.poly(k, self.words(k))
                for i in mine:
                    out[i] = ref.commit_open(k, coeffs, self.point(i))
                del coeffs
        return out

    def check(self, answers: list) -> tuple[dict, int]:
        """({number: (value, limit)}, requests checked): every finished request
        against the reference."""
        picks = self.picks(answers)
        wrong = {"commitments_wrong": 0, "witnesses_wrong": 0, "evaluations_wrong": 0}
        for i, want in self.reference(picks).items():
            got = answers[i] if isinstance(answers[i], dict) else answer_fields(answers[i])
            wrong["commitments_wrong"] += got["commitment"] != want["commitment"]
            wrong["witnesses_wrong"] += got["witness"] != want["witness"]
            wrong["evaluations_wrong"] += got["evaluation"] != want["evaluation"]
        return {k: (v, 0) for k, v in wrong.items()}, len(picks)


def answer_fields(answer) -> dict:
    commitment, opening = answer
    c, w = commitment.point, opening.point
    return {"commitment": None if c.infinity else (c.x, c.y), "witness": None if w.infinity else (w.x, w.y),
            "evaluation": opening.evaluation}


def setup(config: dict, traffic: dict, seed: int, device) -> Cell:
    return Cell(config, traffic, seed, device)
