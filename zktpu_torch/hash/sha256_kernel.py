"""Kernel 6: the field hash of FRI's Merkle trees, and its plain PyTorch version.

Replaces zktpu/hash/sha256_vec.py (the numpy block building :81-144, the
jitted compression ``sha256_single_block`` :53 and the Montgomery digest
fold ``_digest_to_field_traced`` :159-179).  Over canonical Goldilocks
values ((n, 2) int32 limbs, little-endian u32 bit patterns, not Montgomery
form) it computes

- ``pairs=False``: hash(x) = SHA256(decimal(x)) mod p for each value;
- ``pairs=True``: hash_slice([a, b]) = SHA256(decimal(a) || decimal(b)) mod p
  for each consecutive pair, a trailing singleton hashed alone (the
  reference's hash_slice of one element),

as canonical values ((n or ceil(n / 2), 2) int32 limbs).  Every message fits
one SHA-256 block (at most 40 bytes).

The CUDA kernel is csrc/sha256.cu (per-thread code in csrc/sha256.cuh): one
thread per hash, the decimal layout, the 64 rounds and the fold mod p in
registers, one launch per tree level (two for a level of odd length: the
trailing singleton alone).  On the H100 it is bound by 32-bit integer
operations.

The plain version builds the same blocks in torch from the decimal digits
(long division by 10 over two 32-bit halves), runs the compression in int64
lanes masked to 32 bits, and folds the digest as the reference does:
to Montgomery form, products by 2^(32 i), a field sum, from Montgomery form
(the plain field ops).  It runs for CPU tensors; the wrapper launches the
kernel for CUDA tensors and never falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_lib
from ..fields.fp import field, ints_to_limbs
from ..fields.field_kernel import sum_plain
from ..fields.host import GOLDILOCKS
from ..fields.limbs import MASK32, narrow, widen
from ..fields.mont_kernel import mont_mul_plain

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
MAX_DIGITS = 20  # decimal digits of a value below 2^64


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def decimal_digits(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, 2) limbs -> (digits (n, 20) int64, least significant first; lengths (n,))."""
    lo, hi = widen(values[:, 0]), widen(values[:, 1])
    digits, length = [], torch.ones_like(lo)
    for k in range(MAX_DIGITS):
        q_hi = hi // 10
        t = ((hi - 10 * q_hi) << 32) | lo  # < 10 * 2^32
        q_lo = t // 10
        digits.append(t - 10 * q_lo)
        hi, lo = q_hi, q_lo
        if k + 1 < MAX_DIGITS:
            length = length + ((hi | lo) != 0).to(length.dtype)
    return torch.stack(digits, dim=1), length


def _place(block: torch.Tensor, digits: torch.Tensor, length: torch.Tensor, offset: torch.Tensor) -> None:
    """ASCII digits of each row at byte `offset` of its block (n, 65); byte 64
    takes the masked-off digits."""
    k = torch.arange(MAX_DIGITS, device=digits.device)
    cols = torch.where(k < length[:, None], offset[:, None] + length[:, None] - 1 - k, 64)
    block.scatter_(1, cols, 48 + digits)


def message_words(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """The padded block of decimal(a) (b None) or decimal(a) || decimal(b),
    row by row: (n, 16) int64 big-endian words (zktpu's _blocks_single and
    _blocks_pairs)."""
    n = a.shape[0]
    block = torch.zeros((n, 65), dtype=torch.int64, device=a.device)
    da, la = decimal_digits(a)
    _place(block, da, la, torch.zeros_like(la))
    total = la
    if b is not None:
        db, lb = decimal_digits(b)
        _place(block, db, lb, la)
        total = la + lb
    block.scatter_(1, total[:, None], 0x80)
    bits = 8 * total
    block[:, 62] = bits >> 8
    block[:, 63] = bits & 0xFF
    by = block[:, :64].reshape(n, 16, 4)
    return (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & MASK32


def compress_plain(words: torch.Tensor) -> torch.Tensor:
    """(n, 16) int64 message words -> (n, 8) int64 digest words: one SHA-256
    compression from the initial state."""
    w = [words[:, i] for i in range(16)]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK32)
    zero = torch.zeros_like(words[:, 0])
    a, b, c, d, e, f, g, h = (zero + v for v in _H0)
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ MASK32) & g)
        t1 = (h + S1 + ch + _K[t] + w[t]) & MASK32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + S0 + maj) & MASK32, a, b, c, (d + t1) & MASK32, e, f, g
    return torch.stack([(x + v) & MASK32 for x, v in zip((a, b, c, d, e, f, g, h), _H0)], dim=1)


@functools.lru_cache(maxsize=None)
def _fold_consts(device: torch.device) -> torch.Tensor:
    """2^(32 i) mod p for i < 8 in Montgomery form, (8, 2) limbs."""
    p = GOLDILOCKS.modulus
    return torch.from_numpy(ints_to_limbs([GOLDILOCKS.to_mont(pow(2, 32 * i, p)) for i in range(8)], 2)).to(device)


def digest_to_field_plain(digest: torch.Tensor) -> torch.Tensor:
    """(n, 8) digest words -> (n, 2) canonical limbs of from_le_bytes_mod_order:
    sum_i bswap(h_i) 2^(32 i) mod p, through Montgomery form as the reference folds."""
    f = field(GOLDILOCKS, digest.device)
    sw = ((digest & 0xFF) << 24) | (((digest >> 8) & 0xFF) << 16) | (((digest >> 16) & 0xFF) << 8) | (digest >> 24)
    raw = narrow(torch.stack([sw, torch.zeros_like(sw)], dim=-1))  # (n, 8, 2): each word < 2^32 < p
    mont = mont_mul_plain(GOLDILOCKS, raw, f._r2)
    terms = mont_mul_plain(GOLDILOCKS, mont, _fold_consts(digest.device))
    return mont_mul_plain(GOLDILOCKS, sum_plain(f, terms, axis=1), f._one_raw)


def hash_field_plain(values: torch.Tensor, pairs: bool) -> torch.Tensor:
    """The plain field hash: (n, 2) canonical limbs -> (n or ceil(n / 2), 2)."""
    if not pairs:
        return digest_to_field_plain(compress_plain(message_words(values)))
    m = values.shape[0] // 2
    out = digest_to_field_plain(compress_plain(message_words(values[0:2 * m:2], values[1:2 * m:2])))
    if values.shape[0] % 2:  # a trailing singleton: hash_slice of one element
        out = torch.cat([out, hash_field_plain(values[-1:], False)])
    return out


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------


def hash_field(values: torch.Tensor, pairs: bool) -> torch.Tensor:
    """hash (pairs False) or hash_slice of consecutive pairs (pairs True) of
    canonical Goldilocks values (n, 2): the kernel for a CUDA tensor, the
    plain version for a CPU one."""
    if values.device.type == "cpu":
        return hash_field_plain(values, pairs)
    if values.dim() != 2:
        raise ValueError(f"hash_field: expected (n, 2) limbs, got {tuple(values.shape)}")
    cuda_lib.check_cuda_operands("hash_field", (values,), 2, contiguous=False)
    x = values.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    n = x.shape[0]
    out = torch.empty(((n + 1) // 2 if pairs else n, 2), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    launched = ctypes.c_int(0)
    rc = cuda_lib.load().zk_sha256_field(x.device.index, x.data_ptr(), out.data_ptr(), n, int(pairs),
                                         cuda_lib.stream_of(out), ctypes.byref(launched))
    hash_field.launches += launched.value
    cuda_lib.check(rc, "hash_field")
    return out


hash_field.launches = 0


def kernel_attrs() -> dict:
    """Registers per thread, local-memory bytes (spills) and static shared memory per block."""
    out = (ctypes.c_int * 3)()
    cuda_lib.check(cuda_lib.load().zk_sha256_attrs(out), "sha256 attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2]}
