"""Nova's matrix-vector product in one kernel (matvec_fr, csrc/matvec.cu) and
its plain PyTorch version.

out = A z over Fr for a dense (m, n, 8) int32 Montgomery matrix A and an
(n, 8) vector z, (m, 8) canonical.  It replaces the pair the port ran for
zktpu/nova/utils.py::matrix_vector_product (:28-31): kernel 1's product of
A against z[None] (zktpu/fields/pallas_mont.py:363) and kernel A's axis-1
sum (zktpu/fields/fp.py:309), which wrote and re-read an (m, n, 8) product.
The kernel reads A once, sums each row's exact products in registers and
reduces once per partial sum (csrc/matvec.cuh says how, and why the words
equal the plain version's).

``matvec`` launches the kernel for CUDA tensors and raises on anything
else; ``nova/utils.py`` runs ``matvec_plain`` for CPU tensors.  ``run``
launches through a given library: the CUDA one, or the host build of the
same code that the CPU tests drive.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_lib
from ..fields.field_kernel import sum_plain
from ..fields.host import FR
from ..fields.mont_kernel import mont_mul_plain

L = FR.num_digits // 2


def matvec_plain(f, A: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The plain product and the plain tree of adds along axis 1."""
    return sum_plain(f, mont_mul_plain(FR, A, z[None]), 1)


@functools.lru_cache(maxsize=1)
def _k() -> np.ndarray:
    """2^32 R mod p as u32 limbs: the reduction's last factor."""
    v = (1 << 32) * FR.mont_r % FR.modulus
    return np.frombuffer(v.to_bytes(4 * L, "little"), dtype="<u4").copy()


def run(lib, A: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """One launch of zk_matvec through `lib` on contiguous, 16-byte aligned
    int32 operands (the caller checks their device)."""
    if A.dim() != 3 or z.dim() != 2 or A.shape[2] != L or z.shape[1] != L or A.shape[1] != z.shape[0]:
        raise ValueError(f"matvec: expected (m, n, {L}) x (n, {L}), got {tuple(A.shape)} x {tuple(z.shape)}")
    m, n = A.shape[0], A.shape[1]
    if m < 1 or not 1 <= n < 1 << 31:
        raise ValueError(f"matvec: needs 1 <= m and 1 <= n < 2^31, got m={m}, n={n}")
    for t in (A, z):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("matvec: operands must be contiguous, 16-byte aligned int32 limbs")
    out = torch.empty((m, L), dtype=torch.int32, device=A.device)
    p, pinv = cuda_lib.field_consts(FR)
    stream = cuda_lib.stream_of(out) if out.is_cuda else 0
    rc = lib.zk_matvec(A.device.index or 0, p, pinv, _k().ctypes.data, A.data_ptr(), z.data_ptr(),
                       out.data_ptr(), m, n, stream)
    cuda_lib.check(rc, "matvec")
    return out


def matvec(A: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """A z for an (m, n, 8) matrix and an (n, 8) vector on one CUDA device."""
    cuda_lib.check_cuda_operands("matvec", (A, z), L)
    out = run(cuda_lib.load(), A, z)
    matvec.launches += 1
    return out


matvec.launches = 0


def kernel_attrs() -> dict:
    """Registers per thread, local-memory bytes (spills), static shared
    memory per block, and the design's rows and threads a block."""
    out = (ctypes.c_int * 5)()
    cuda_lib.check(cuda_lib.load().zk_matvec_attrs(out), "matvec attributes")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "rows", "threads"), out))
