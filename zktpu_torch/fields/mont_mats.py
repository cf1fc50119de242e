"""The constant matrices of the matrix-unit Montgomery product.

The port's copy of zktpu/fields/pallas_mont.py::mont_matmats (and its twin
tools/prof_mulkernels.py::const_matmats, which builds the same matrices).
With x split into 8-bit digits, the two constant convolutions of a
Montgomery product, m = t * (-p^{-1}) mod R and m * p, become integer
matrix products with 8-bit entries:

    cols16[s] = (A @ x8)[s] + 256 * (B @ x8)[s],

where cols16[s] is the s-th base-2^16 column sum of x times the constant,
A carries the digit products of weight 1 (true 8-bit column 2s) and B those
of weight 256 (column 2s + 1).  Every entry is an 8-bit digit of the
constant and every x8 entry is at most 255, so each sum of 2D products is
at most 2D * 255^2 (3,121,200 for Fq): exact in s32, in f32, and in bf16
products summed in f32.

``mont_matmats`` keeps the reference's layout: rows r of x8 in block order
(the low bytes of the D digits, then the high bytes).  ``kernel_mats`` is
the same matrices as the CUDA kernel reads them (csrc/mont_mma.cuh): x8 in
natural byte order (byte r of the little-endian limbs, so one 32-bit limb
is four consecutive k of an mma fragment), the weight-1 and weight-256
columns interleaved (n = 2 s + w), one row of 32 KS bytes per n.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .host import FieldSpec

MXU_MIN_DIGITS = 16  # zktpu's rule (pallas_mont.py): Goldilocks (D = 4) stays on the integer path


def check_mxu_field(spec: FieldSpec) -> None:
    """Raise ValueError for a field too small for the matrix path."""
    if spec.num_digits < MXU_MIN_DIGITS:
        raise ValueError(
            f"the mxu and f32 Montgomery products need at least MXU_MIN_DIGITS = {MXU_MIN_DIGITS} "
            f"16-bit digits; {spec.name} has {spec.num_digits}"
        )


def _digits8(value: int, n8: int) -> np.ndarray:
    return np.array([(value >> (8 * i)) & 0xFF for i in range(n8)], dtype=np.int64)


def _true_idx(D: int) -> np.ndarray:
    """Block-order row r -> true 8-bit digit index (lo block then hi block)."""
    t = np.zeros(2 * D, dtype=np.int64)
    t[:D] = 2 * np.arange(D)
    t[D:] = 2 * np.arange(D) + 1
    return t


def _build(dig8: np.ndarray, S: int, D: int) -> tuple[np.ndarray, np.ndarray]:
    """(S, 2D) matrices A and B of a constant's 8-bit digits, block-order columns."""
    t = _true_idx(D)
    s = np.arange(S)[:, None]
    ia, ib = 2 * s - t[None, :], 2 * s + 1 - t[None, :]
    A = np.where((ia >= 0) & (ia < 2 * D), dig8[np.clip(ia, 0, 2 * D - 1)], 0)
    B = np.where((ib >= 0) & (ib < 2 * D), dig8[np.clip(ib, 0, 2 * D - 1)], 0)
    return A, B


@functools.lru_cache(maxsize=None)
def _matmats(spec: FieldSpec) -> np.ndarray:
    check_mxu_field(spec)
    D = spec.num_digits
    pinv_A, pinv_B = _build(_digits8(spec.mont_pinv_full, 2 * D), D, D)
    p_A, p_B = _build(_digits8(spec.modulus, 2 * D), 2 * D, D)
    out = np.zeros((4, 2 * D, 2 * D), dtype=np.int64)
    out[0, :D] = pinv_A
    out[1, :D] = pinv_B
    out[2] = p_A
    out[3] = p_B
    out.setflags(write=False)
    return out


def mont_matmats(spec: FieldSpec, device="cpu") -> torch.Tensor:
    """(4, 2D, 2D) int64: pinv_A, pinv_B (rows < D; the rest 0), p_A, p_B."""
    return torch.from_numpy(_matmats(spec).copy()).to(device)


def kernel_mats(spec: FieldSpec) -> tuple[np.ndarray, np.ndarray]:
    """The two matrices in the kernel's layout, as (2S, 32 KS) uint8: the
    pinv matrix (S = D columns, the product mod R) and the p matrix (S = 2D).
    Row n = 2 s + w holds column s of A (w = 0) or B (w = 1) over the bytes
    of x in natural order, zero past byte 2D."""
    mats = _matmats(spec)
    D = spec.num_digits
    kpad = 32 * -(-2 * D // 32)
    # natural byte r of x is block-order row r // 2 (low byte) or D + r // 2 (high byte)
    r = np.arange(2 * D)
    block = np.where(r % 2 == 0, r // 2, D + r // 2)
    out = []
    for A, B, S in ((mats[0], mats[1], D), (mats[2], mats[3], 2 * D)):
        m = np.zeros((2 * S, kpad), dtype=np.uint8)
        m[0::2, : 2 * D] = A[:S, block]
        m[1::2, : 2 * D] = B[:S, block]
        out.append(m)
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def kernel_mats_on(spec: FieldSpec, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """kernel_mats as int32 words (four bytes of k each) on `device`, cached."""
    return tuple(torch.from_numpy(m.view(np.int32).copy()).to(device) for m in kernel_mats(spec))


def used_blocks(spec: FieldSpec, S: int) -> list[tuple[int, int]]:
    """The (n-tile, k-step) blocks of a kernel matrix with S columns that the
    kernel multiplies (csrc/mont_mma.cuh ConstConv::used): tile j holds
    columns 4j..4j+3, which meet only the bytes r in [8j - 2D + 1, 8j + 7];
    the other blocks are all zero and skipped."""
    k8 = 2 * spec.num_digits
    return [(j, ks) for j in range(S // 4) for ks in range(-(-k8 // 32))
            if 32 * ks <= 8 * j + 7 and 32 * ks + 31 >= 8 * j - k8 + 1]


def mma_products(spec: FieldSpec) -> int:
    """m16n8k32 products per m-tile of 16 elements in one Montgomery product:
    the used blocks of the pinv matrix (S = D) and the p matrix (S = 2D)."""
    D = spec.num_digits
    return len(used_blocks(spec, D)) + len(used_blocks(spec, 2 * D))
