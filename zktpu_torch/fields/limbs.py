"""Plain PyTorch helpers for multi-limb integers.

Limbs are stored as int32 tensors holding u32 bit patterns; arithmetic widens
them to int64 (torch has no add, shift or compare for uint32 on the CPU).
Carries are resolved in a constant number of tensor ops rather than a loop
over limbs: after folding, every position holds at most one pending carry,
and the carry into position i is set exactly when the last "generate"
position below i comes after the last "kill" position below i, which two
cumulative maxima find.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> int64 holding the unsigned values."""
    return x.to(torch.int64) & MASK32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 values < 2^32 -> int32 limbs with the same bit pattern."""
    return x.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _positions(k: int, ndim: int, dim: int, device: torch.device):
    shape = [1] * ndim
    shape[dim] = k
    idx = torch.arange(k, device=device).view(shape)
    return idx, torch.full((), -1, dtype=idx.dtype, device=device)


def resolve(v: torch.Tensor, bits: int, outer: bool | None = None):
    """Propagate binary carries through positions v[..., i] <= 2^(bits+1) - 1.

    Returns (digits, carry_out): digits < 2^bits with the same value mod
    2^(bits * K), and the carry out of the top position (bool).

    outer: scan with the positions moved to the outer dim (default: on CUDA,
    where a scan over a short innermost dim runs one row per thread and took
    89% of a 2^14-gate prove's device time).  Both layouts give equal results.
    """
    if v.is_cuda:
        resolve.cuda_calls += 1
    mask = (1 << bits) - 1
    outer = v.is_cuda if outer is None else outer
    dim = 0 if outer else -1
    t = v.movedim(-1, 0).contiguous() if outer else v
    k = t.shape[dim]
    idx, none = _positions(k, t.dim(), dim, t.device)
    last_gen = torch.cummax(torch.where(t > mask, idx, none), dim=dim).values
    last_kill = torch.cummax(torch.where(t < mask, idx, none), dim=dim).values
    carry = last_gen > last_kill  # carry out of position i
    carry_in = torch.cat([torch.zeros_like(carry.narrow(dim, 0, 1)), carry.narrow(dim, 0, k - 1)], dim=dim)
    out = (t + carry_in) & mask
    return (out.movedim(0, -1) if outer else out), carry.select(dim, k - 1)


resolve.cuda_calls = 0  # calls on CUDA tensors: the plain versions' carry scans on the card


def normalize16(cols: torch.Tensor, width: int, bits: int) -> torch.Tensor:
    """Column sums (each < 2^bits, bits <= 62) -> `width` base-2^16 digits of
    their value mod 2^(16 width)."""
    k = cols.shape[-1]
    v = F.pad(cols, (0, width - k)) if width > k else cols[..., :width]
    bound = (1 << bits) - 1
    while bound > (1 << 16):  # each fold: v <= 2^16 - 1 + v_max / 2^16
        v = (v & MASK16) + F.pad((v >> 16)[..., :-1], (1, 0))
        bound = MASK16 + (bound >> 16)
    return resolve(v, 16)[0]


def limbs_to_digits16(x: torch.Tensor) -> torch.Tensor:
    """(..., L) int32 limbs -> (..., 2L) int64 base-2^16 digits."""
    w = widen(x)
    return torch.stack([w & MASK16, w >> 16], dim=-1).flatten(-2)


def digits16_to_limbs(d: torch.Tensor) -> torch.Tensor:
    """(..., 2L) int64 base-2^16 digits -> (..., L) int32 limbs."""
    return narrow(d[..., 0::2] | (d[..., 1::2] << 16))
