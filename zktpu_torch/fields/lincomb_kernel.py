"""The field linear combination over Fr in one kernel (field_lincomb,
csrc/lincomb.cu) and its plain PyTorch version.

    out[i] = sum_k (+-) a_k[i] b_k[i] + sum_j (+-) c_j[i]

in Montgomery form and canonical.  ``products`` is a sequence of (a, b,
sign) and ``addends`` of (c, sign), sign +1 or -1; each a and c is an
(n_k, 8) int32 operand (a single row may be given as (8,)) whose rows at
n_k and beyond read as 0, so polynomials of unequal lengths need no padding
and a length-1 constant is an addend at row 0 only; each b is one row (a
scalar) or as long as its a.  The result has as many rows as the longest a
or c.  It replaces the chains of Montgomery products and adds/subs that the
reference runs as separate calls (zktpu/nova/nifs.py:31-52,
zktpu/plonk/prover.py:184-191 and :493-): one launch of up to MAX_TERMS
terms, where the chain took one a link (csrc/lincomb.cuh says why the words
are the chain's).

``lincomb`` launches the kernel for CUDA tensors (more than MAX_TERMS terms
take further launches, each adding the last launch's result as a term) and
never falls back; for CPU tensors it runs ``lincomb_plain``, the chain of
plain products and adds.  ``run`` launches through a given library: the
CUDA one, or the host build of the same code that the CPU tests drive.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_lib
from .field_kernel import add_plain, sub_plain
from .host import FR
from .mont_kernel import mont_mul_plain

L = FR.num_digits // 2
MAX_TERMS = 8


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as (rows, L)."""
    if t.shape[-1] != L:
        raise ValueError(f"field_lincomb: expected operands of {L} limbs in the last dim, got {tuple(t.shape)}")
    return t if t.dim() == 2 else t.reshape(-1, L)


def _terms(f, products, addends) -> tuple[list, int]:
    """[(a, b or None, sign)] with (rows, L) operands, and the result's rows."""
    if f.spec.name != FR.name:
        raise ValueError(f"field_lincomb: Fr only, got {f.spec.name}")
    terms = [(_rows(a), _rows(b), sign) for a, b, sign in products] + [(_rows(c), None, sign) for c, sign in addends]
    n = 0
    for a, b, sign in terms:
        if sign != 1 and sign != -1:
            raise ValueError(f"field_lincomb: a term's sign is +1 or -1, got {sign!r}")
        if b is not None and b.shape[0] != 1 and b.shape[0] != a.shape[0]:
            raise ValueError(f"field_lincomb: b has {b.shape[0]} rows; one or its a's {a.shape[0]}")
        n = max(n, a.shape[0])
    return terms, n


def _padded(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.shape[0] == n:
        return t
    return torch.cat([t, torch.zeros((n - t.shape[0], L), dtype=t.dtype, device=t.device)])


def lincomb_plain(f, products, addends=()) -> torch.Tensor:
    """The chain the kernel replaces: from 0, each term's plain product (or
    its addend) added or subtracted in turn."""
    return _chain(f, *_terms(f, products, addends))


def _chain(f, terms, n: int) -> torch.Tensor:
    out = torch.zeros((n, L), dtype=torch.int32, device=f.device)
    for a, b, sign in terms:
        if a.shape[0] == 0:
            continue
        x = a if b is None else mont_mul_plain(FR, a, b)
        out = (add_plain if sign > 0 else sub_plain)(f, out, _padded(x, n))
    return out


@functools.lru_cache(maxsize=1)
def _k() -> tuple[np.ndarray, int]:
    """2^32 R mod p as u32 limbs (the reduction's last factor), and its address."""
    v = (1 << 32) * FR.mont_r % FR.modulus
    k = np.frombuffer(v.to_bytes(4 * L, "little"), dtype="<u4").copy()
    return k, k.ctypes.data


def run(lib, terms, n: int, out: torch.Tensor) -> None:
    """One launch of zk_lincomb through `lib` over at most MAX_TERMS terms
    [(a, b or None, negate)] of contiguous, 16-byte aligned int32 rows into
    out (n, 8) (the caller checks their device)."""
    words = []
    for a, b, sign in terms:
        words += (a.data_ptr(), a.shape[0], 0, 0, sign < 0) if b is None else (
            a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0], sign < 0)
    desc = (ctypes.c_int64 * len(words))(*words)
    p, pinv = cuda_lib.field_consts(FR)
    stream = cuda_lib.stream_of(out) if out.is_cuda else 0
    rc = lib.zk_lincomb(out.device.index or 0, p, pinv, _k()[1], desc, len(terms), out.data_ptr(), n, stream)
    cuda_lib.check(rc, "field_lincomb")


def _ready(t: torch.Tensor) -> torch.Tensor:
    """A contiguous operand on a 16-byte boundary (the kernel's 16-byte loads)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def lincomb(f, products, addends=()) -> torch.Tensor:
    """The combination (module docstring) on f's device: one launch of
    field_lincomb a MAX_TERMS terms for CUDA operands, the plain chain for
    CPU ones."""
    terms, n = _terms(f, products, addends)
    ops = [t for a, b, _ in terms for t in ((a,) if b is None else (a, b))]
    if all(t.device.type == "cpu" for t in ops):
        return _chain(f, terms, n)
    cuda_lib.check_cuda_operands("field_lincomb", ops, L, contiguous=False)
    terms = [(_ready(a), None if b is None else _ready(b), sign) for a, b, sign in terms if a.shape[0]]
    out = torch.empty((n, L), dtype=torch.int32, device=ops[0].device)
    if n == 0:
        return out
    lib = cuda_lib.load()
    while True:
        run(lib, terms[:MAX_TERMS], n, out)
        lincomb.launches += 1
        terms = terms[MAX_TERMS:]
        if not terms:
            return out
        terms.insert(0, (out, None, 1))
        out = torch.empty_like(out)


lincomb.launches = 0


def kernel_attrs() -> dict:
    """Registers per thread, local-memory bytes (spills), static shared
    memory per block and threads a block."""
    out = (ctypes.c_int * 4)()
    cuda_lib.check(cuda_lib.load().zk_lincomb_attrs(out), "field_lincomb attributes")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads"), out))
