"""Kernel 1: the batched Montgomery product, kernel 5: the chained product,
and their plain PyTorch versions.

Replaces zktpu/fields/pallas_mont.py::_mont_mul_call (entry point
mont_mul_pallas): out = a * b * R^{-1} mod p, canonical, for Fq (12 limbs),
Fr (8) and Goldilocks (2), with operands that broadcast over leading axes.

The CUDA kernel is csrc/mont_mul.cu.  On the H100 it is bound by 32-bit
integer multiply throughput (a CIOS product over L limbs issues about 2 L^2
wide multiply-adds: 288 for Fq, 128 for Fr) and by registers (the L + 2 word
accumulator and both operands stay in registers).  The simple design runs one
thread per element (the product as PTX carry chains for Fq and Fr, 64-bit
sums for Goldilocks; csrc/field.cuh), so memory traffic is just the operands
and the result, and every block is independent.

The plain version computes in int64 on base-2^16 digits: a schoolbook column
sum, m = t * (-p^{-1}) mod R and t + m p as products with constant Toeplitz
matrices, and carry resolution in a fixed number of ops (fields/limbs.py).
It runs for CPU tensors; the wrapper launches the kernel for CUDA tensors and
never falls back.

Kernel 5 (``mont_mul_chain``, also csrc/mont_mul.cu) replaces the base
variant of tools/prof_mulkernels.py::make_chain, a profiling-only kernel: it
runs a = a * b * R^{-1} `chain` times per element in registers, so its time
is the multiply body's alone (zktpu_torch/tools/prof_mulkernels.py).
"""
from __future__ import annotations

import functools

import torch

from .host import FieldSpec, FQ, FR, GOLDILOCKS
from .. import cuda_lib
from .limbs import MASK16, digits16_to_limbs, limbs_to_digits16, normalize16, resolve


def _broadcast_operand(t: torch.Tensor, shape: torch.Size):
    """Contiguous operand plus its row count for the kernel's modulo indexing.

    An operand whose batch shape is a suffix of the output's (e.g. one
    constant, or a table repeated over a leading batch axis) is passed as is;
    any other broadcast is materialised."""
    limbs = t.shape[-1]
    tb = list(t.shape[:-1])
    while tb and tb[0] == 1:
        tb.pop(0)
    if tuple(tb) == tuple(shape[len(shape) - len(tb):]):
        return t.contiguous(), max(t.numel() // limbs, 1)
    return t.expand(tuple(shape) + (limbs,)).contiguous(), None


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of (..., L) int32 limb tensors (broadcasting)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    limbs = spec.num_digits // 2
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    n = 1
    for s in shape:
        n *= s
    a, na = _broadcast_operand(a, shape)
    b, nb = _broadcast_operand(b, shape)
    cuda_lib.check_cuda_operands("mont_mul", (a, b), limbs)
    out = torch.empty(tuple(shape) + (limbs,), dtype=torch.int32, device=a.device)
    if n:
        lib = cuda_lib.load()
        p, pinv = cuda_lib.field_consts(spec)
        rc = lib.zk_mont_mul(
            a.device.index, limbs, p.ctypes.data, pinv,
            a.data_ptr(), na or n, b.data_ptr(), nb or n, out.data_ptr(), n,
            cuda_lib.stream_of(out),
        )
        cuda_lib.check(rc, "mont_mul")
        mont_mul.launches[spec.name] += 1
    return out


mont_mul.launches = {FR.name: 0, FQ.name: 0, GOLDILOCKS.name: 0}


class _PlainConsts:
    def __init__(self, spec: FieldSpec, device: torch.device):
        D = spec.num_digits

        def digits(v):
            return torch.tensor([(v >> (16 * i)) & MASK16 for i in range(D)], dtype=torch.int64)

        p, pinv = digits(spec.modulus), digits(spec.mont_pinv_full)
        i = torch.arange(D)
        diff = i[None, :] - i[:, None]  # [row i, col k] -> k - i
        # m_k = sum_i t_i pinv_{k-i} (low D columns only)
        self.pinv_toep = torch.where(diff >= 0, pinv[diff.clamp(0, D - 1)], 0).to(device)
        # (m p)_k = sum_i m_i p_{k-i} over all 2D columns
        k2 = torch.arange(2 * D)
        diff2 = k2[None, :] - i[:, None]
        ok = (diff2 >= 0) & (diff2 < D)
        self.p_toep = torch.where(ok, p[diff2.clamp(0, D - 1)], 0).to(device)
        # column index i + j of each schoolbook partial product a_i b_j
        self.col = (i[:, None] + i[None, :]).flatten().to(device)
        # two's-complement digits of -p over D + 1 digits, for r - p
        self.neg_p = torch.cat([MASK16 - p, torch.tensor([MASK16])]).to(device)
        self.neg_p[0] += 1
        self.D = D


@functools.lru_cache(maxsize=None)
def _plain_consts(spec: FieldSpec, device: torch.device) -> _PlainConsts:
    return _PlainConsts(spec, device)


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch Montgomery product: same result as the kernel."""
    c = _plain_consts(spec, a.device)
    D = c.D
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    ad = limbs_to_digits16(a).expand(tuple(shape) + (D,)).reshape(-1, D)
    bd = limbs_to_digits16(b).expand(tuple(shape) + (D,)).reshape(-1, D)
    n = ad.shape[0]
    prod = (ad[:, :, None] * bd[:, None, :]).reshape(n, D * D)
    T = torch.zeros(n, 2 * D, dtype=torch.int64, device=a.device)
    T.index_add_(1, c.col, prod)  # schoolbook columns, each < D 2^32
    # m = T (-p^{-1}) mod R straight from the unnormalised columns: each
    # product is < 2^53 and each column sum < 2^58, exact in int64
    m = normalize16((T[:, :D, None] * c.pinv_toep).sum(1), D, 58)
    S = T + (m[:, :, None] * c.p_toep).sum(1)  # T + m p, low D digits vanish
    r = normalize16(S, 2 * D + 1, 38)[:, D:]  # (T + m p) / R < 2p, D + 1 digits
    d, ge_p = resolve(r + c.neg_p, 16)  # r - p, and whether r >= p
    out = torch.where(ge_p[:, None], d, r)[:, :D]
    return digits16_to_limbs(out).reshape(tuple(shape) + (D // 2,))


def mont_mul_chain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """a * b^chain * R^{-chain} mod p, i.e. `chain` Montgomery products by b,
    for equal-shape (..., L) int32 limb tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_chain_plain(spec, a, b, chain)
    limbs = spec.num_digits // 2
    if a.shape != b.shape:
        raise ValueError(f"mont_mul_chain: operand shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    cuda_lib.check_cuda_operands("mont_mul_chain", (a, b), limbs)
    out = torch.empty_like(a)
    n = a.numel() // limbs
    if n:
        lib = cuda_lib.load()
        p, pinv = cuda_lib.field_consts(spec)
        rc = lib.zk_mont_mul_chain(
            a.device.index, limbs, p.ctypes.data, pinv,
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, int(chain), cuda_lib.stream_of(out),
        )
        cuda_lib.check(rc, "mont_mul_chain")
        mont_mul_chain.launches += 1
    return out


mont_mul_chain.launches = 0


def mont_mul_chain_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """The plain chained product: `chain` plain Montgomery products."""
    for _ in range(chain):
        a = mont_mul_plain(spec, a, b)
    return a
