"""The NIFS folding scheme (counterpart of zktpu/nova/nifs.py).

compute_t: T = AZ1 o BZ2 + AZ2 o BZ1 - u1 CZ2 - u2 CZ1 (six matrix-vector
products on the device, then one field_lincomb); fold_witness: E <- E1 + r T
+ r^2 E2, W <- W1 + r W2 (one field_lincomb each);
fold_instance: the same on the commitments (host G1 scalar multiplications),
u and x.  prove opens the folded E and W at a transcript challenge; verify
checks the challenge and both openings.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields.fp import field
from ..fields.host import FR
from ..kzg.scheme import KzgCommitment, KzgOpening, KzgScheme
from ..poly.poly import Poly
from ..transcript.transcripts import NovaTranscript
from .r1cs import R1CS, FInstance, FWitness, NovaError, _trim, z_vector
from .utils import matrix_vector_product, to_f_matrix


@dataclass
class NIFSProof:
    r: int
    opening_point: int
    opening_e: KzgOpening
    opening_w: KzgOpening


class NIFS:
    @staticmethod
    def compute_t(r1cs: R1CS, u1: int, u2: int, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        az1 = matrix_vector_product(r1cs.matrix_a, z1)
        bz1 = matrix_vector_product(r1cs.matrix_b, z1)
        cz1 = matrix_vector_product(r1cs.matrix_c, z1)
        az2 = matrix_vector_product(r1cs.matrix_a, z2)
        bz2 = matrix_vector_product(r1cs.matrix_b, z2)
        cz2 = matrix_vector_product(r1cs.matrix_c, z2)

        # t = az1 o bz2 + az2 o bz1 - u1 cz2 - u2 cz1: one field_lincomb in place of zktpu's chain of four
        # products, an add and two subs (the same words: csrc/lincomb.cuh)
        f = field(FR, az1.device)
        u = f.encode_ints([u1, u2])
        return f.lincomb([(az1, bz2, 1), (az2, bz1, 1), (cz2, u[:1], -1), (cz1, u[1:], -1)])

    @staticmethod
    def fold_witness(r: int, fw1: FWitness, fw2: FWitness, t: torch.Tensor) -> FWitness:
        """E1 + r T + r^2 E2 and W1 + r W2, one field_lincomb each (zktpu's chain: three products, three adds)."""
        for x, y in ((fw1.e, t), (fw1.e, fw2.e), (fw1.w, fw2.w)):
            if x.shape != y.shape:  # the chain's adds broadcast nothing here
                raise ValueError(f"fold_witness: operand shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
        f = field(FR, t.device)
        rr = f.encode_ints([r, FR.mul(r, r)])
        new_e = f.lincomb([(t, rr[:1], 1), (fw2.e, rr[1:], 1)], [(fw1.e, 1)])
        new_w = f.lincomb([(fw2.w, rr[:1], 1)], [(fw1.w, 1)])
        return FWitness(e=new_e, w=new_w)

    @staticmethod
    def fold_instance(r: int, fi1: FInstance, fi2: FInstance, com_t: KzgCommitment) -> FInstance:
        r2 = FR.mul(r, r)
        new_com_e = KzgCommitment(fi1.com_e.point + com_t.point.mul(r) + fi2.com_e.point.mul(r2))
        new_com_w = KzgCommitment(fi1.com_w.point + fi2.com_w.point.mul(r))
        new_u = FR.add(fi1.u, FR.mul(fi2.u, r))
        new_x = [FR.add(a, FR.mul(b, r)) for a, b in zip(fi1.x, fi2.x)]
        return FInstance(com_e=new_com_e, u=new_u, com_w=new_com_w, x=new_x)

    # -- prover side --

    @classmethod
    def prover(cls, r1cs: R1CS, fw1: FWitness, fw2: FWitness, fi1: FInstance, fi2: FInstance,
               scheme: KzgScheme, transcript: NovaTranscript):
        z1 = z_vector(fw1, fi1.x, fi1.u)
        z2 = z_vector(fw2, fi2.x, fi2.u)
        t = cls.compute_t(r1cs, fi1.u, fi2.u, z1, z2)
        com_t = scheme.commit_coeffs(_trim(t))

        transcript.feed_scalar_num(fi1.u)
        transcript.feed_scalar_num(fi2.u)
        transcript.feed(com_t)
        (r,) = transcript.generate_challenges(1)

        new_witness = cls.fold_witness(r, fw1, fw2, t)
        new_instance = cls.fold_instance(r, fi1, fi2, com_t)
        return new_witness, new_instance, com_t, r

    @classmethod
    def prove(cls, r: int, fw: FWitness, fi: FInstance, scheme: KzgScheme, transcript: NovaTranscript) -> NIFSProof:
        transcript.feed(fi.com_e)
        transcript.feed(fi.com_w)
        (opening_point,) = transcript.generate_challenges(1)
        opening_e = scheme.open(Poly(FR, fw.e), opening_point)
        opening_w = scheme.open(Poly(FR, fw.w), opening_point)
        return NIFSProof(r, opening_point, opening_e, opening_w)

    # -- verifier side --

    @classmethod
    def verifier(cls, r: int, fi1: FInstance, fi2: FInstance, com_t: KzgCommitment) -> FInstance:
        return cls.fold_instance(r, fi1, fi2, com_t)

    @classmethod
    def verify(cls, proof: NIFSProof, fi1: FInstance, fi2: FInstance, fi3: FInstance, com_t: KzgCommitment,
               scheme: KzgScheme, transcript: NovaTranscript) -> None:
        cls.verify_challenge(proof.r, fi1.u, fi2.u, com_t, transcript)
        cls.verify_opening(proof, fi3, scheme, transcript)

    @classmethod
    def verify_challenge(cls, r: int, fi1_u: int, fi2_u: int, com_t: KzgCommitment,
                         transcript: NovaTranscript) -> None:
        transcript.feed_scalar_num(fi1_u)
        transcript.feed_scalar_num(fi2_u)
        transcript.feed(com_t)
        (new_r,) = transcript.generate_challenges(1)
        if new_r != r:
            raise NovaError("Verify: Error in computing random r")

    @classmethod
    def verify_opening(cls, proof: NIFSProof, fi3: FInstance, scheme: KzgScheme, transcript: NovaTranscript) -> None:
        transcript.feed(fi3.com_e)
        transcript.feed(fi3.com_w)
        (opening_point,) = transcript.generate_challenges(1)
        if opening_point != proof.opening_point:
            raise NovaError("Verify: Error in computing random opening point")
        if not scheme.verify(fi3.com_w, proof.opening_w, opening_point):
            raise NovaError("Verify: Folding wrong at W")
        if not scheme.verify(fi3.com_e, proof.opening_e, opening_point):
            raise NovaError("Verify: Folding wrong at E")


def gen_test_values(inputs: list[int], device=None):
    """The R1CS of x^3 + x + 5 = y over Z = [x, x^2, x^3, x^3 + x, y, 1], and
    each input's witness and public output."""
    a = to_f_matrix([[1, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0], [1, 0, 1, 0, 0, 0], [0, 0, 0, 1, 0, 5]], device)
    b = to_f_matrix([[1, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 1], [0, 0, 0, 0, 0, 1]], device)
    c = to_f_matrix([[0, 1, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0], [0, 0, 0, 1, 0, 0], [0, 0, 0, 0, 1, 0]], device)
    w, x = [], []
    for inp in inputs:
        w.append([inp, inp * inp, inp**3, inp**3 + inp])
        x.append([inp**3 + inp + 5])
    return R1CS(matrix_a=a, matrix_b=b, matrix_c=c, num_io=1, num_vars=4), w, x
