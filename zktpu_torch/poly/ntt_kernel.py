"""The NTT kernel (csrc/ntt.cu) over Fr and Goldilocks, and its plain
PyTorch version.

Replaces the stage loop of zktpu/poly/domain.py::_transform, a jnp graph of
log n radix-2 stages around the Montgomery product kernel
(zktpu/fields/pallas_mont.py::_mont_mul_call).  Both compute, for rows of n
elements ((..., n, L) Montgomery limbs; L = 8 over Fr, 2 over Goldilocks),

    out = out_factor * DIT(in_factor * values),

DIT being the bit-reverse gather and the log n butterfly stages
(u + w v, u - w v) with stage s taking every (n / 2^s)-th entry of `table`
(gen^i, i < n/2).  A factor is an (n, L) table or one (L,) value; with
``inverse`` and no out_factor the output factor is n^-1 (a caller that
merges n^-1 into its own table, as coset_ifft does, passes that table).

On the H100 the Fr transform is bound by 32-bit integer multiply-adds and
the Goldilocks one by its bytes.  The kernels run the stages in 1-4 launches
of shared-memory tiles, a thread running radix steps in registers on its
elements between barriers, the twiddles staged once a block (Fr:
csrc/ntt.cuh, radix-4 steps, radix-2 for calls of at most 2^16 elements,
on lazy values in [0, 2p) with the transform's own even/odd Montgomery
product, two launches from 2^11 to 2^18 points; Goldilocks:
csrc/ntt_gl.cuh, radix-8 steps, two launches from 2^12 to 2^20 points),
with the permutation and both factors fused into the loads and stores
(csrc/ntt.cu says how).  ``ntt`` launches them for CUDA tensors and runs
``ntt_plain`` for CPU tensors only (``KERNEL_FIELDS``); ``stage_loop`` is
the stage loop over any product, which Fq's two-point domains use.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_lib
from ..fields.field_kernel import add_plain, sub_plain
from ..fields.fp import field, ints_to_limbs
from ..fields.host import FR, GOLDILOCKS, FieldSpec
from ..fields.mont_kernel import mont_mul_plain

# The fields the kernel is built for (its instances L = 8 and L = 2).
KERNEL_FIELDS = (FR, GOLDILOCKS)


def bit_reverse_perm(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _perm(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bit_reverse_perm(n)).to(device)


@functools.lru_cache(maxsize=None)
def _n_inv(spec: FieldSpec, n: int, device: torch.device) -> torch.Tensor:
    """n^-1 as (L,) Montgomery limbs."""
    return torch.from_numpy(ints_to_limbs([spec.to_mont(spec.inv(n))], spec.num_digits // 2)[0]).to(device)


def stage_loop(spec: FieldSpec, mul, values, table, inverse: bool, in_factor=None, out_factor=None, plain=False):
    """The transform as log n tensor stages: `mul` (a Montgomery product of
    two broadcastable limb tensors) by the stage twiddles, then a field add
    and sub (kernel B, or with `plain` their plain versions) and a
    concatenation per stage."""
    df = field(spec, values.device)
    add, sub = (functools.partial(add_plain, df), functools.partial(sub_plain, df)) if plain else (df.add, df.sub)
    n, L = values.shape[-2], values.shape[-1]
    x = values if in_factor is None else mul(values, in_factor)
    x = x.index_select(-2, _perm(n, values.device))
    lead = x.shape[:-2]
    for s in range(1, n.bit_length()):
        m = 1 << s
        half = m // 2
        xr = x.reshape(lead + (n // m, m, L))
        even, odd = xr[..., :half, :], xr[..., half:, :]
        t = mul(odd, table[:: n // m][:half])
        x = torch.cat([add(even, t), sub(even, t)], dim=-2).reshape(lead + (n, L))
    if out_factor is None and inverse:
        out_factor = _n_inv(spec, n, values.device)
    return x if out_factor is None else mul(x, out_factor)


def ntt_plain(values, table, inverse: bool, in_factor=None, out_factor=None, spec: FieldSpec = FR):
    """The plain version: the stage loop over the plain Montgomery product."""
    return stage_loop(spec, functools.partial(mont_mul_plain, spec), values, table, inverse, in_factor, out_factor,
                      plain=True)


def _factor(name: str, t, n: int, limbs: int):
    """(pointer, row stride) of a factor: an (n, L) table or one (L,) value."""
    if t is None:
        return None, 0
    rows = t.reshape(-1, limbs)
    if rows.shape[0] not in (1, n) or t.shape[-1] != limbs:
        raise ValueError(f"ntt: {name} must be ({n}, {limbs}) or ({limbs},), got {tuple(t.shape)}")
    return rows.contiguous(), int(rows.shape[0] == n and n > 1)


def ntt(values, table, inverse: bool, in_factor=None, out_factor=None, spec: FieldSpec = FR):
    """out_factor * DIT(in_factor * values) over `spec` (module docstring)
    for (..., n, L) limbs: the kernel for CUDA tensors, ntt_plain for CPU ones."""
    ts = [t for t in (values, table, in_factor, out_factor) if t is not None]
    if all(t.device.type == "cpu" for t in ts):
        return ntt_plain(values, table, inverse, in_factor, out_factor, spec)
    if spec not in KERNEL_FIELDS:
        raise ValueError(f"ntt: the kernel is built for {[f.name for f in KERNEL_FIELDS]}, not {spec.name}")
    limbs = spec.num_digits // 2
    n = values.shape[-2]
    log_n = n.bit_length() - 1
    if n != 1 << log_n:
        raise ValueError(f"ntt: the transform length must be a power of two, got {n}")
    if table.shape[0] < max(n // 2, 1):
        raise ValueError(f"ntt: the twiddle table has {table.shape[0]} rows, the transform needs {n // 2}")
    if out_factor is None and inverse:
        out_factor = _n_inv(spec, n, values.device)
    x = values.contiguous()
    tw = table.contiguous()
    fin, fin_s = _factor("in_factor", in_factor, n, limbs)
    fout, fout_s = _factor("out_factor", out_factor, n, limbs)
    ops = [t for t in (x, tw, fin, fout) if t is not None]
    cuda_lib.check_cuda_operands("ntt", ops, limbs)
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("ntt: operands must be 16-byte aligned")
    out = torch.empty_like(x)
    batch = x.numel() // (n * limbs)
    if batch == 0:
        return out
    if batch > 65535:
        raise ValueError(f"ntt: at most 65535 rows per call, got {batch}")
    lib = cuda_lib.load()
    p, pinv = cuda_lib.field_consts(spec)
    launched = ctypes.c_int(0)
    rc = lib.zk_ntt(
        x.device.index, limbs, p, pinv, x.data_ptr(), out.data_ptr(), batch, log_n, tw.data_ptr(),
        0 if fin is None else fin.data_ptr(), fin_s, 0 if fout is None else fout.data_ptr(), fout_s,
        cuda_lib.stream_of(out), ctypes.byref(launched),
    )
    ntt.launches[spec.name] += launched.value
    cuda_lib.check(rc, "ntt")
    return out


ntt.launches = {f.name: 0 for f in KERNEL_FIELDS}


_PLAN_KEYS = ("s0", "ns", "cols", "threads", "shared_bytes", "steps")


def _plan(entry: str, args: tuple, keys: tuple, name: str) -> list[dict]:
    out = (ctypes.c_int * (len(keys) * 32))()
    np_ = getattr(cuda_lib.load(), entry)(*args, out)
    if np_ < 0:
        raise ValueError(f"ntt: no {name} plan for 2^{args[0]}")
    w = len(keys)
    return [dict(zip(keys, out[w * k : w * k + w])) for k in range(np_)]


def gl_plan(log_n: int) -> list[dict]:
    """The Goldilocks kernel's passes for a 2^log_n transform, as the library
    plans them: s0, ns, cols, threads, shared bytes and radix steps of each."""
    return _plan("zk_ntt_gl_plan", (log_n,), _PLAN_KEYS, "Goldilocks")


def fr_plan(log_n: int, batch: int = 1) -> list[dict]:
    """The Fr kernel's passes for `batch` transforms of 2^log_n, the same
    keys and the log2 radix of their steps (radix_log: 1 for calls of at
    most 2^radix2_work elements in all, else 2)."""
    return _plan("zk_ntt_fr_plan", (log_n, batch), (*_PLAN_KEYS, "radix_log"), "Fr")


def fr_design() -> dict:
    """The Fr kernel's build: the largest call (batch x n elements) in
    radix-2 steps, its largest tile, the columns of a multi-pass tile, the
    largest one-pass transform (log2 each), the blocks per SM its launch
    bound asks for, and log2 of a multi-pass block's fewest threads."""
    out = (ctypes.c_int * 6)()
    cuda_lib.check(cuda_lib.load().zk_ntt_fr_design(out), "ntt design")
    keys = ("radix2_work", "log_tile", "log_cols", "one_pass", "min_blocks", "log_min_threads")
    return dict(zip(keys, out))


def fr_products(log_n: int, batch: int, factors: int) -> int:
    """The Montgomery products the Fr kernel issues for `batch` transforms of
    2^log_n with `factors` fused factors: a product a butterfly, less those
    by 1 that the first pass's first step skips ((n/2) (1 + 1/2 + ...) over
    the step's stages), plus n a factor."""
    n = 1 << log_n
    plan = fr_plan(log_n, batch)
    first = plan[0]
    total = factors * n + (n // 2) * log_n
    total -= sum((n // 2) >> s for s in range(min(first["ns"], first["radix_log"])))
    return batch * total


def kernel_attrs(spec: FieldSpec = FR, radix_log: int = 2) -> dict:
    """Registers per thread, local-memory bytes (spills) and the shared
    memory per block of the largest tile, for the kernel of `spec` (Fr: the
    one of radix-2^radix_log steps, 1 or 2)."""
    out = (ctypes.c_int * 3)()
    cuda_lib.check(cuda_lib.load().zk_ntt_attrs(spec.num_digits // 2, radix_log, out), "ntt attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2]}
