"""The FRI fold kernel (csrc/fri_fold.cu) and its plain PyTorch version.

Replaces the jnp graph of zktpu/fri/prover.py::fold_polynomial around the
Montgomery product kernel (zktpu/fields/pallas_mont.py:363): for (n, 2)
Goldilocks Montgomery coefficients c and a challenge r,

    out[i] = c[2i] + r * c[2i+1],   i < ceil(n / 2),

the last odd term taken as 0 when n is odd.  The kernel reads the
coefficients in place and takes r by value, so a fold is one launch with no
copy to the card; its output length is known on the host.  ``fold`` launches
it for CUDA tensors and runs ``fold_plain`` for CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib
from ..fields.field_kernel import add_plain
from ..fields.fp import field
from ..fields.host import GOLDILOCKS, FieldSpec
from ..fields.mont_kernel import mont_mul_plain


def fold_plain(spec: FieldSpec, coeffs: torch.Tensor, r: int) -> torch.Tensor:
    """even + r * odd, the odd half padded with zeros: the plain product and add."""
    f = field(spec, coeffs.device)
    even, odd = coeffs[0::2], coeffs[1::2]
    odd_r = mont_mul_plain(spec, odd, f.encode_int(r))
    if odd_r.shape[0] < even.shape[0]:
        pad = torch.zeros((even.shape[0] - odd_r.shape[0], f.num_limbs), dtype=odd_r.dtype, device=odd_r.device)
        odd_r = torch.cat([odd_r, pad])
    return add_plain(f, even, odd_r)


def fold(spec: FieldSpec, coeffs: torch.Tensor, r: int) -> torch.Tensor:
    """The fold of (n, L) Montgomery coefficients by the challenge r (an int):
    the kernel for a CUDA tensor (Goldilocks), fold_plain for a CPU one."""
    if coeffs.device.type == "cpu":
        return fold_plain(spec, coeffs, r)
    if spec != GOLDILOCKS:
        raise ValueError(f"fri fold: the kernel is built for {GOLDILOCKS.name}, not {spec.name}")
    if coeffs.dim() != 2:
        raise ValueError(f"fri fold: expected (n, 2) coefficients, got {tuple(coeffs.shape)}")
    c = coeffs.contiguous()
    cuda_lib.check_cuda_operands("fri fold", (c,), 2)
    if c.data_ptr() % 16:
        c = c.clone()
    n = c.shape[0]
    out = torch.empty(((n + 1) // 2, 2), dtype=torch.int32, device=c.device)
    if n == 0:
        return out
    rm = spec.to_mont(int(r) % spec.modulus)
    rc = cuda_lib.load().zk_fri_fold(c.device.index, c.data_ptr(), n, rm & 0xFFFFFFFF, rm >> 32, out.data_ptr(),
                                     cuda_lib.stream_of(out))
    cuda_lib.check(rc, "fri fold")
    fold.launches += 1
    return out


fold.launches = 0


def kernel_attrs() -> dict:
    """Registers per thread, local-memory bytes (spills) and static shared
    memory per block of the fold kernel."""
    out = (ctypes.c_int * 3)()
    cuda_lib.check(cuda_lib.load().zk_fri_fold_attrs(out), "fri fold attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2]}
