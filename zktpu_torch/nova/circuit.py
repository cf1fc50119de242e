"""The augmented circuit F' and the IVC state hash (counterpart of
zktpu/nova/circuit.py).

hash_io is SHA-256 over the arkworks uncompressed serialisations of
(i, z_0, z_i, U_i), read into the base field; base_to_scalar moves a base
field element into the scalar field by its little-endian bytes mod r, as
zktpu does.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..fields.host import FQ, FR
from ..kzg.scheme import KzgCommitment
from ..transcript.serialize import fq_bytes, fr_bytes, g1_uncompressed
from ..transcript.transcripts import NovaTranscript
from .nifs import NIFS
from .r1cs import FInstance, FWitness, NovaError


@dataclass
class State:
    state: int  # a base field element


class FCircuit:
    """The step function z_(i+1) = F(z_i, w_i)."""

    def run(self, z_i: State, w_i: FWitness) -> State:  # pragma: no cover
        raise NotImplementedError


def _point_bytes(c: KzgCommitment) -> bytes:
    p = c.point
    return g1_uncompressed(p.x, p.y, p.infinity)


def hash_io(i: int, z_0: State, z_i: State, big_u_i: FInstance) -> int:
    h = hashlib.sha256()
    h.update(fq_bytes(i))
    h.update(fq_bytes(z_0.state))
    h.update(fq_bytes(z_i.state))
    h.update(_point_bytes(big_u_i.com_e))
    h.update(fr_bytes(big_u_i.u))
    h.update(_point_bytes(big_u_i.com_w))
    for x in big_u_i.x:
        h.update(fr_bytes(x))
    return FQ.from_le_bytes_mod_order(h.digest())


def base_to_scalar(v: int) -> int:
    """ScalarField::from_le_bytes_mod_order(base.into_bigint().to_bytes_le())."""
    return FR.from_le_bytes_mod_order(fq_bytes(v))


class AugmentedCircuit:
    def __init__(self, f_circuit: FCircuit, trivial_instance: FInstance, z_0: State):
        self.f_circuit = f_circuit
        self.i = 0  # a base field counter
        self.trivial_instance = trivial_instance
        self.z_0 = z_0
        self.z_i = z_0
        self.z_i1: State | None = None
        self.h_i: int | None = None
        self.h_i1: int | None = None

    def run(self, u_i: FInstance, big_u_i: FInstance | None, w_i: FWitness, com_t: KzgCommitment | None) -> int:
        if self.i != 0:
            if big_u_i is None or com_t is None:
                raise NovaError("Wrong parameters.")
            if self.h_i is None:
                raise NovaError("The hash public IO must exist")
            if u_i.x[0] != base_to_scalar(self.h_i):
                raise NovaError("Public IO is wrong ")
            if u_i.com_e != self.trivial_instance.com_e:
                raise NovaError("Commitment of E is wrong")
            if u_i.u != 1:
                raise NovaError("Scalar u is wrong")

            transcript = NovaTranscript()
            transcript.feed_scalar_num(u_i.u)
            transcript.feed_scalar_num(big_u_i.u)
            transcript.feed(com_t)
            (r,) = transcript.generate_challenges(1)

            big_u_i1 = NIFS.verifier(r, u_i, big_u_i, com_t)
            z_i1 = self.f_circuit.run(self.z_i, w_i)
            self.h_i1 = hash_io((self.i + 1) % FQ.modulus, self.z_0, z_i1, big_u_i1)
        else:
            z_i1 = self.f_circuit.run(self.z_i, w_i)
            self.h_i1 = hash_io(1, self.z_0, z_i1, self.trivial_instance)
        self.z_i1 = z_i1
        return self.h_i1

    def next_step(self):
        self.z_i = self.z_i1
        self.z_i1 = None
        self.i = (self.i + 1) % FQ.modulus
        self.h_i = self.h_i1
        self.h_i1 = None
