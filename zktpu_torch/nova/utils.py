"""Dense linear algebra for Nova (counterpart of zktpu/nova/utils.py).

R1CS matrices are dense (m, n, 8) Fr Montgomery limb tensors and vectors are
(n, 8), on one device.  A matrix-vector product is one launch of the matvec
kernel (nova/matvec_kernel.py: each row's products summed in registers,
with no (m, n, 8) temporary) for CUDA tensors, and its plain version, the
batched product against z[None] and the axis-1 sum, for CPU tensors.
"""
from __future__ import annotations

import torch

from ..fields.fp import field
from ..fields.host import FR
from .matvec_kernel import matvec, matvec_plain


def to_f_matrix(rows: list[list[int]], device=None) -> torch.Tensor:
    """Rows of ints -> (m, n, 8) Montgomery limbs on `device`."""
    f = field(FR, device)
    flat = [x for row in rows for x in row]
    return f.encode_ints(flat).reshape(len(rows), len(rows[0]), f.num_limbs)


def to_f_vec(vals: list[int], device=None) -> torch.Tensor:
    return field(FR, device).encode_ints(vals)


def matrix_vector_product(matrix: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(m, n, 8) x (n, 8) -> (m, 8)."""
    if matrix.device.type == "cpu" and z.device.type == "cpu":
        return matvec_plain(field(FR, "cpu"), matrix, z)
    return matvec(matrix, z)


def hadamard_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return field(FR, a.device).mont_mul(a, b)


def vector_elem_product(a: torch.Tensor, u: int) -> torch.Tensor:
    f = field(FR, a.device)
    return f.mont_mul(a, f.encode_int(u))


def vec_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return field(FR, a.device).add(a, b)


def vec_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return field(FR, a.device).sub(a, b)


def vec_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a, b)
