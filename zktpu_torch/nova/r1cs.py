"""Relaxed R1CS (counterpart of zktpu/nova/r1cs.py).

Z = [W || x || u]; an instance is satisfied when (A Z) o (B Z) = u (C Z) + E
and its commitments are those of E and W.  W and E are (len, 8) Fr
Montgomery limb tensors on one device; u and x are host ints.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields.fp import field
from ..fields.host import FR
from ..kzg.scheme import KzgCommitment, KzgScheme
from ..poly.poly import Poly
from .utils import matrix_vector_product


@dataclass
class R1CS:
    matrix_a: torch.Tensor  # (m, n, 8)
    matrix_b: torch.Tensor
    matrix_c: torch.Tensor
    num_io: int
    num_vars: int


@dataclass
class FInstance:
    com_e: KzgCommitment
    u: int
    com_w: KzgCommitment
    x: list[int]


@dataclass
class FWitness:
    e: torch.Tensor  # (m, 8)
    w: torch.Tensor  # (num_vars, 8)

    @classmethod
    def new(cls, w: list[int], length: int, device=None) -> "FWitness":
        f = field(FR, device)
        return cls(e=torch.zeros((length, f.num_limbs), dtype=torch.int32, device=f.device), w=f.encode_ints(w))

    @classmethod
    def new_trivial_witness(cls, length: int, device=None) -> "FWitness":
        f = field(FR, device)
        zero = torch.zeros((length, f.num_limbs), dtype=torch.int32, device=f.device)
        return cls(e=zero, w=zero)

    def commit(self, scheme: KzgScheme, x: list[int]) -> FInstance:
        com_e = scheme.commit_coeffs(_trim(self.e))
        com_w = scheme.commit_coeffs(_trim(self.w))
        return FInstance(com_e=com_e, u=1, com_w=com_w, x=list(x))


def _trim(arr: torch.Tensor) -> torch.Tensor:
    """commit_vector semantics: trailing zero rows dropped (all of them for a zero vector)."""
    return Poly._trim(arr)


def z_vector(witness: FWitness, instance_x: list[int], u: int) -> torch.Tensor:
    """Z = [w || x || u]."""
    tail = field(FR, witness.w.device).encode_ints(list(instance_x) + [u])
    return torch.cat([witness.w, tail], dim=0)


def create_trivial_pair(x_len: int, w_len: int, scheme: KzgScheme, device=None):
    """The all-zero witness (E and W of w_len rows) and its instance:
    identity commitments, u = 1, x = 0."""
    trivial_witness = FWitness.new_trivial_witness(w_len, device)
    return trivial_witness, trivial_witness.commit(scheme, [0] * x_len)


def is_r1cs_satisfied(r1cs: R1CS, f_instance: FInstance, f_witness: FWitness, scheme: KzgScheme) -> None:
    """Raises NovaError unless the pair satisfies the relaxed R1CS."""
    if r1cs.num_vars != f_witness.w.shape[0]:
        raise NovaError("Witness does not match with matrices")
    if r1cs.num_io != len(f_instance.x):
        raise NovaError("Instance does not match with matrices")

    z = z_vector(f_witness, f_instance.x, f_instance.u)
    az = matrix_vector_product(r1cs.matrix_a, z)
    bz = matrix_vector_product(r1cs.matrix_b, z)
    cz = matrix_vector_product(r1cs.matrix_c, z)
    # (A Z) o (B Z) == u (C Z) + E, shapes first (as vec_equal compares them), then
    # (A Z) o (B Z) - u (C Z) - E == 0 in one field_lincomb
    f = field(FR, z.device)
    res_eq = az.shape == bz.shape == cz.shape == f_witness.e.shape and not bool(
        f.lincomb([(az, bz, 1), (cz, f.encode_int(f_instance.u), -1)], [(f_witness.e, -1)]).any())

    res_com = f_instance.com_w == scheme.commit_coeffs(_trim(f_witness.w)) and (
        f_instance.com_e == scheme.commit_coeffs(_trim(f_witness.e))
    )
    if not (res_com and res_eq):
        raise NovaError("Instance does not satisfy the Witness.")


class NovaError(Exception):
    pass
