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

Kernel 5 (``mont_mul_chain``) replaces tools/prof_mulkernels.py::make_chain,
a profiling-only kernel: it runs a = a * b * R^{-1} `chain` times per element
in one launch, so its time is the multiply body's alone
(zktpu_torch/tools/prof_mulkernels.py).  Its three bodies, as the
reference's: "base" (csrc/mont_mul.cu, the CIOS carry chain of every other
kernel), "mxu" (csrc/mont_mma.cu: the two constant convolutions
t * (-p^{-1}) mod R and m * p as u8 wgmma products of a warpgroup, the
constant matrices staged once a block in shared memory, the variable one
on the integer pipe) and "f32" (the same, with the variable convolution as
FP32 FMAs over 8-bit digits); "mxu" and "f32" for Fr and Fq only
(fields/mont_mats.py: MXU_MIN_DIGITS).  Their plain versions follow
RowOpsMXU.mul and RowOpsF32.conv_full step by step in int64 and expose the
intermediates (``parts``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .host import FieldSpec, FQ, FR, GOLDILOCKS
from .. import cuda_lib
from .limbs import MASK16, digits16_to_limbs, limbs_to_digits16, normalize16, resolve
from .mont_mats import check_mxu_field, kernel_mats_on, mont_matmats


def _broadcast_operand(t: torch.Tensor, shape: tuple):
    """Contiguous operand plus its row count for the kernel's row indexing.

    An operand whose batch shape is a suffix of the output's (e.g. one
    constant, or a table repeated over a leading batch axis) is passed as is;
    any other broadcast is materialised."""
    limbs = t.shape[-1]
    tb = tuple(t.shape[:-1])
    if tb == shape and t.is_contiguous():
        return t, None
    while tb and tb[0] == 1:
        tb = tb[1:]
    if tb == shape[len(shape) - len(tb):]:
        return t.contiguous(), max(t.numel() // limbs, 1)
    return t.expand(shape + (limbs,)).contiguous(), None


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of (..., L) int32 limb tensors (broadcasting)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    limbs = spec.num_digits // 2
    sa, sb = tuple(a.shape[:-1]), tuple(b.shape[:-1])
    shape = sa if sa == sb else cuda_lib.broadcast_shapes(sa, sb)
    n = 1
    for s in shape:
        n *= s
    a, na = _broadcast_operand(a, shape)
    b, nb = _broadcast_operand(b, shape)
    cuda_lib.check_cuda_operands("mont_mul", (a, b), limbs)
    out = torch.empty(shape + (limbs,), dtype=torch.int32, device=a.device)
    if n:
        p, pinv = cuda_lib.field_consts(spec)
        rc = cuda_lib.load().zk_mont_mul(
            a.device.index, limbs, p, pinv, a.data_ptr(), na or n, b.data_ptr(), nb or n, out.data_ptr(), n,
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


CHAIN_VARIANTS = ("base", "mxu", "f32")


def mont_mul_chain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, chain: int,
                   variant: str = "base") -> torch.Tensor:
    """a * b^chain * R^{-chain} mod p, i.e. `chain` Montgomery products by b,
    for equal-shape (..., L) int32 limb tensors, computed by one of
    CHAIN_VARIANTS (the same function)."""
    if variant not in CHAIN_VARIANTS:
        raise ValueError(f"mont_mul_chain: unknown variant {variant!r}; one of {CHAIN_VARIANTS}")
    if variant != "base":
        check_mxu_field(spec)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return PLAIN_CHAINS[variant](spec, a, b, chain)
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
        stream = cuda_lib.stream_of(out)
        if variant == "base":
            rc = lib.zk_mont_mul_chain(a.device.index, limbs, p, pinv,
                                       a.data_ptr(), b.data_ptr(), out.data_ptr(), n, int(chain), stream)
        else:
            qmat, pmat = kernel_mats_on(spec, a.device)
            rc = lib.zk_mont_mma_chain(a.device.index, limbs, p, pinv, int(variant == "f32"),
                                       qmat.data_ptr(), pmat.data_ptr(), a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), n, int(chain), stream)
        cuda_lib.check(rc, f"mont_mul_chain ({variant})")
        mont_mul_chain.launches[variant] += 1
    return out


mont_mul_chain.launches = {v: 0 for v in CHAIN_VARIANTS}


MMA_DESIGN_KEYS = ("tiles", "psplit", "min_blocks")


def mont_mma_design(spec: FieldSpec, variant: str) -> dict:
    """The design of the mxu or f32 chain kernel for `spec` in the loaded
    library (csrc/mont_mma.cuh MmaDesign: tiles in flight, parts of the m p
    product; min_blocks 0: no launch bound)."""
    check_mxu_field(spec)
    out = (ctypes.c_int * len(MMA_DESIGN_KEYS))()
    cuda_lib.check(cuda_lib.load().zk_mont_mma_design(spec.num_digits // 2, int(variant == "f32"), out),
                   f"mont_mul_chain ({variant}) design")
    return dict(zip(MMA_DESIGN_KEYS, out))


def mont_mma_attrs(spec: FieldSpec, variant: str) -> dict:
    """Registers per thread, local-memory bytes (spills) and shared memory
    per block (the staged matrices, operand rows and column rows) of the mxu or
    f32 chain kernel for `spec`."""
    check_mxu_field(spec)
    out = (ctypes.c_int * 3)()
    cuda_lib.check(cuda_lib.load().zk_mont_mma_attrs(spec.num_digits // 2, int(variant == "f32"), out),
                   f"mont_mul_chain ({variant}) attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2]}


def mont_mul_chain_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """The plain chained product: `chain` plain Montgomery products."""
    for _ in range(chain):
        a = mont_mul_plain(spec, a, b)
    return a


# ---------------------------------------------------------------------------
# The plain versions of the mxu and f32 bodies: zktpu's RowOps helpers over
# (N, D) int64 base-2^16 digits (the reference's (D, T) planes transposed).

def _carry_rows(cols: torch.Tensor, num_out: int):
    """zktpu's _carry_rows: column sums (N, k <= num_out), each < 2^33, ->
    (num_out digits, top) with value = digits + top * 2^(16 num_out)."""
    d = normalize16(cols, num_out + 2, 34)
    return d[:, :num_out], d[:, num_out] + (d[:, num_out + 1] << 16)


def _conv_full(ad: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
    """RowOps.conv_full: the 2D schoolbook columns of a b, each digit product
    split into its low 16 bits (column i + j) and high 16 bits (i + j + 1)."""
    n, D = ad.shape
    prod = (ad[:, :, None] * bd[:, None, :]).reshape(n, D * D)
    idx = (torch.arange(D, device=ad.device)[:, None] + torch.arange(D, device=ad.device)[None, :]).flatten()
    cols = torch.zeros(n, 2 * D, dtype=torch.int64, device=ad.device)
    cols.index_add_(1, idx, prod & MASK16)
    cols.index_add_(1, idx + 1, prod >> 16)
    return cols


def _conv_f32(ad: torch.Tensor, bd: torch.Tensor):
    """RowOpsF32.conv_full's two accumulators over 8-bit digits: accA holds
    lo*lo at offset i + j and hi*hi at i + j + 1, accB lo*hi + hi*lo at
    i + j (weight 256).  Each sum is an integer below 2^24, so the
    reference's f32 values are these int64 ones."""
    n, D = ad.shape
    alo, ahi, blo, bhi = ad & 0xFF, ad >> 8, bd & 0xFF, bd >> 8
    idx = (torch.arange(D, device=ad.device)[:, None] + torch.arange(D, device=ad.device)[None, :]).flatten()

    def outer(x, y):
        return (x[:, :, None] * y[:, None, :]).reshape(n, D * D)

    acc_a = torch.zeros(n, 2 * D, dtype=torch.int64, device=ad.device)
    acc_b = torch.zeros_like(acc_a)
    acc_a.index_add_(1, idx, outer(alo, blo))
    acc_a.index_add_(1, idx + 1, outer(ahi, bhi))
    acc_b.index_add_(1, idx, outer(alo, bhi) + outer(ahi, blo))
    return acc_a, acc_b


def _to8(x16: torch.Tensor) -> torch.Tensor:
    """(N, D) 16-bit digits -> (N, 2D) block-order 8-bit digits (low bytes, then high)."""
    return torch.cat([x16 & 0xFF, x16 >> 8], dim=1)


def _const_mat(x16: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """RowOps._const_mxu: cols16 = A x8 + 256 (B x8).  The products run in
    float64: every partial sum is an integer below 2^22, so they are exact."""
    x8 = _to8(x16).to(torch.float64)
    ca = (x8 @ A.T).to(torch.int64)
    cb = (x8 @ B.T).to(torch.int64)
    return ca + (cb << 8)


@functools.lru_cache(maxsize=None)
def _plain_mats(spec: FieldSpec, device: torch.device):
    D = spec.num_digits
    m = mont_matmats(spec, device).to(torch.float64)
    return m[0, :D], m[1, :D], m[2], m[3]


def _cond_sub_p(spec: FieldSpec, res: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """RowOps.cond_sub_p: top * R + res (< 2p) reduced into [0, p)."""
    c = _plain_consts(spec, res.device)
    r = torch.cat([res, top[:, None]], dim=1)
    d, ge_p = resolve(r + c.neg_p, 16)  # r - p, and whether r >= p
    return torch.where(ge_p[:, None], d, r)[:, : c.D]


def mont_mul_mxu_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, variant: str = "mxu",
                       parts: dict | None = None) -> torch.Tensor:
    """One plain product of the mxu or f32 body (RowOpsMXU.mul): the
    variable convolution (RowOps.conv_full, or RowOpsF32.conv_full for
    "f32"), m = t_lo (-p^{-1}) mod R and m p as constant-matrix products,
    the carries and the conditional subtraction.  parts: a dict that
    receives the intermediates as (N, columns) int64 tensors: m_cols,
    mp_cols and, for "f32", accA and accB."""
    check_mxu_field(spec)
    D = spec.num_digits
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    ad = limbs_to_digits16(a).expand(tuple(shape) + (D,)).reshape(-1, D)
    bd = limbs_to_digits16(b).expand(tuple(shape) + (D,)).reshape(-1, D)
    pinv_A, pinv_B, p_A, p_B = _plain_mats(spec, a.device)
    if variant == "f32":
        acc_a, acc_b = _conv_f32(ad, bd)
        cols = acc_a + (acc_b << 8)
    else:
        cols = _conv_full(ad, bd)
    t_lo, _ = _carry_rows(cols[:, :D], D)
    m_cols = _const_mat(t_lo, pinv_A, pinv_B)
    m, _ = _carry_rows(m_cols, D)
    mp_cols = _const_mat(m, p_A, p_B)
    _, c_low_total = _carry_rows(cols[:, :D] + mp_cols[:, :D], D)
    hi = cols[:, D:] + mp_cols[:, D:]
    hi[:, 0] += c_low_total
    res, carry_top = _carry_rows(hi, D)
    out = _cond_sub_p(spec, res, carry_top)
    if parts is not None:
        parts.update(m_cols=m_cols, mp_cols=mp_cols)
        if variant == "f32":
            parts.update(accA=acc_a, accB=acc_b)
    return digits16_to_limbs(out).reshape(tuple(shape) + (D // 2,))


def mont_mul_chain_mxu_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """The plain chain of the mxu body: `chain` products by b."""
    for _ in range(chain):
        a = mont_mul_mxu_plain(spec, a, b, "mxu")
    return a


def mont_mul_chain_f32_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """The plain chain of the f32 body: `chain` products by b."""
    for _ in range(chain):
        a = mont_mul_mxu_plain(spec, a, b, "f32")
    return a


# the plain chain of each body, by variant
PLAIN_CHAINS = {"base": mont_mul_chain_plain, "mxu": mont_mul_chain_mxu_plain, "f32": mont_mul_chain_f32_plain}
