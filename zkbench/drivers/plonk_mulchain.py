"""Driver of a PLONK prove stream over the multiplication-chain circuit.

Inputs from the run's seed (numpy's default_rng(seed)): the SRS secret, the
witness seeds of a pool of circuits (each preprocessed once in set-up, as a
proving service does with its fixed circuit), and for request i a blinding
seed; request i proves witness i mod pool.  The check proves a sample of the
finished requests again with the plain reference (../reference/plonk.py) and
counts the proof's fields that differ.
"""
from __future__ import annotations

import gc

import numpy as np

from zkbench import seeds
from zkbench.reference.curve import R

COMMITMENTS = ("a", "b", "c", "z", "t_lo", "t_mid", "t_hi", "w_ev_x", "w_ev_wx")
EVALUATIONS = ("bar_a", "bar_b", "bar_c", "bar_s_sigma_1", "bar_s_sigma_2", "bar_z_w")


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.log_n = int(config["log_gates"])
        self.traffic = traffic
        self.seed = seed
        self.device = device
        rng = np.random.default_rng([seed, 0])
        self.secret = seeds.field_element(rng, R)
        self.witness_seeds = [int(x) for x in rng.integers(1, 1 << 62, size=int(traffic["witness_pool"]))]
        self.srs = self.circuits = None

    def build(self) -> None:
        """The program's state: the SRS and the preprocessed circuits."""
        from zktpu_torch.kzg.srs import Srs
        from zktpu_torch.plonk.synthetic import synthetic_mul_chain

        self.srs = Srs.new_from_secret(self.secret, 1 << self.log_n, device=self.device)
        self.circuits = [synthetic_mul_chain(self.log_n, ws, device=self.device) for ws in self.witness_seeds]

    def blind_seed(self, i: int) -> int:
        return seeds.u64(self.seed, "blind", i)

    def _prove(self, i: int, blind: int):
        from zktpu_torch.plonk.prover import generate_proof
        from zktpu_torch.transcript.chacha import StdRng

        circuit = self.circuits[i % len(self.circuits)]
        return generate_proof(circuit, self.srs, StdRng.from_seed_u64(blind))

    def warm(self) -> None:
        self._prove(0, seeds.u64(self.seed, "warm", 0))

    def request(self, i: int):
        return self._prove(i, self.blind_seed(i))

    def free(self) -> None:
        self.circuits = self.srs = None
        gc.collect()

    def picks(self, answers: list) -> list[int]:
        """The requests the check compares: as many finished ones as the traffic's
        check_sample says, drawn from the seed."""
        done = [i for i, a in enumerate(answers) if a is not None]
        return seeds.sample(self.seed, done, int(self.traffic["check_sample"]))

    def reference(self, indices: list[int], scalar_bits: int = 256) -> dict:
        """{i: the reference's proof of request i}; scalar_bits below 256: the control's."""
        from zkbench.reference.plonk import MulChainReference

        ref = MulChainReference(self.log_n, self.secret, self.device, scalar_bits=scalar_bits)
        return {i: ref.prove(self.witness_seeds[i % len(self.witness_seeds)], self.blind_seed(i)) for i in indices}

    def check(self, answers: list) -> tuple[dict, int]:
        """({number: (value, limit)}, proofs checked): the fields of each
        sampled proof that differ from the reference's proof."""
        picks = self.picks(answers)
        wrong = {"commitments_wrong": 0, "evaluations_wrong": 0, "challenges_wrong": 0}
        for i, want in self.reference(picks).items():
            got = answers[i] if isinstance(answers[i], dict) else proof_fields(answers[i])
            for group, key in (("commitments", "commitments_wrong"), ("evaluations", "evaluations_wrong"),
                               ("challenges", "challenges_wrong")):
                wrong[key] += sum(got[group][k] != v for k, v in want[group].items())
        return {k: (v, 0) for k, v in wrong.items()}, len(picks)


def proof_fields(proof) -> dict:
    """A proof of the program as the reference's dict of plain values."""
    def point(c):
        return None if c.point.infinity else (c.point.x, c.point.y)

    return {
        "commitments": {k: point(getattr(proof, f"{k}_commit")) for k in COMMITMENTS},
        "evaluations": {k: getattr(proof, k) for k in EVALUATIONS},
        "challenges": {"u": proof.u, "degree": proof.degree},
    }


def setup(config: dict, traffic: dict, seed: int, device) -> Cell:
    return Cell(config, traffic, seed, device)

