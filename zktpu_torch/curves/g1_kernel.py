"""Kernels 2, 3 and 4: the fused complete projective G1 add, double and
mixed add; the MSM's Horner combine in one launch; and their plain PyTorch
versions.

Replace zktpu/curves/pallas_g1.py::_proj_add_call, _proj_double_call and
_proj_madd_call (entry points proj_add_pallas, proj_double_pallas and
proj_madd_pallas).  Points are homogeneous projective triples of (..., 12)
Fq Montgomery limb tensors; the identity is (0 : 1 : 0).  The formulas are
RCB 2015/1060 Alg. 7 (add, 12M), Alg. 8 (mixed add, 11M: projective plus
affine with Z2 = 1) and Alg. 9 (double, 6M + 2S) for a = 0, complete, with
no branch.  The mixed add's affine identity is (0, 0), off the curve, which
its final select handles; zero-padded rows therefore come out as P1.

The CUDA kernels are csrc/g1.cu (formulas in csrc/g1.cuh).  On the H100 they
are bound by 32-bit integer multiply-adds issued as long dependent carry
chains, so they need many warps per SM; one thread holds its point's
intermediates in registers, which caps how many fit.  The add and the mixed
add are written for that (carry-chain products, lazy reduction, operands
re-read from memory, a budget of 168 registers for 3 blocks per SM; see
g1.cu); ``kernel_attrs`` reads the registers and spills ptxas gave each
kernel.

``horner_combine`` replaces the loop of doubles and adds that combines the
MSM's window sums (zktpu/curves/msm.py:139-148): one launch runs the whole
serial chain, four lanes per point running each formula step's independent
products at once (csrc/g1.cu says why).  ``fixed_base_mul`` replaces the
loop of gathers and adds of zktpu/curves/g1.py:300-320 (fixed_base_mul_u32):
one launch, one thread per scalar walking its windows in step with its
block, each window's rows staged in shared memory.

The wrappers take strided operands without copying them: any broadcast of
the batch shape whose rows are 16-byte aligned, with limbs contiguous and
the batch dims collapsible to an (outer, inner) pair of strides (a slice
``a[:, lo:hi]`` of a (B, N, 12) plane, a broadcast constant).  Another
layout is copied once.  ``out=`` takes three planes of the batch shape to
write into; they must not overlap the inputs or each other.

The plain versions run the same operation sequence with the plain Montgomery
product; the wrappers use them for CPU tensors only, through the same
signatures.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields.host import FQ
from .. import cuda_lib
from ..fields.field_kernel import add_plain, sub_plain
from ..fields.fp import field
from ..fields.limbs import widen
from ..fields.mont_kernel import mont_mul_plain

LIMBS = FQ.num_digits // 2


class _PlainOps:
    """Fq ops for the plain group law: the plain product and the plain tensor
    add/sub (fields/field_kernel.py), on any device."""

    def __init__(self, device: torch.device):
        f = field(FQ, device)
        self.add = functools.partial(add_plain, f)
        self.sub = functools.partial(sub_plain, f)
        self.dbl = lambda a: add_plain(f, a, a)

    @staticmethod
    def mul(a, b):
        return mont_mul_plain(FQ, a, b)


def _mul12(ops, a):
    """12 a = 3b a for BLS12-381 G1 (b = 4) as a double/add chain."""
    a4 = ops.dbl(ops.dbl(a))
    return ops.add(ops.dbl(a4), a4)


def proj_add_formula(ops, P1, P2):
    """RCB Alg. 7 (a = 0): complete projective addition, 12M + 2 x (3b)."""
    X1, Y1, Z1 = P1
    X2, Y2, Z2 = P2
    mul, add, sub = ops.mul, ops.add, ops.sub
    t0 = mul(X1, X2)
    t1 = mul(Y1, Y2)
    t2 = mul(Z1, Z2)
    t3 = sub(mul(add(X1, Y1), add(X2, Y2)), add(t0, t1))  # X1Y2 + X2Y1
    t4 = sub(mul(add(Y1, Z1), add(Y2, Z2)), add(t1, t2))  # Y1Z2 + Y2Z1
    t5 = sub(mul(add(X1, Z1), add(X2, Z2)), add(t0, t2))  # X1Z2 + X2Z1
    t0 = add(ops.dbl(t0), t0)  # 3 X1X2
    t2 = _mul12(ops, t2)  # 3b Z1Z2
    Zc = add(t1, t2)  # Y1Y2 + 3b Z1Z2
    t1 = sub(t1, t2)  # Y1Y2 - 3b Z1Z2
    t5 = _mul12(ops, t5)  # 3b (X1Z2 + X2Z1)
    X3 = sub(mul(t3, t1), mul(t4, t5))
    Y3 = add(mul(t1, Zc), mul(t5, t0))
    Z3 = add(mul(Zc, t4), mul(t0, t3))
    return X3, Y3, Z3


def proj_madd_formula(ops, P1, A2):
    """RCB Alg. 8 (a = 0, Z2 = 1): 11M mixed add, the same operation
    sequence as zktpu/curves/g1.py::_proj_madd_jnp."""
    X1, Y1, Z1 = P1
    X2, Y2 = A2
    mul, add, sub = ops.mul, ops.add, ops.sub
    t0 = mul(X1, X2)
    t1 = mul(Y1, Y2)
    t3 = sub(mul(add(X1, Y1), add(X2, Y2)), add(t0, t1))  # X1Y2 + X2Y1
    t4 = add(Y1, mul(Y2, Z1))  # Y1 + Y2Z1
    t5 = add(X1, mul(X2, Z1))  # X1 + X2Z1
    t0 = add(ops.dbl(t0), t0)  # 3 X1X2
    t2 = _mul12(ops, Z1)  # 3b Z1
    Zc = add(t1, t2)
    t1 = sub(t1, t2)
    t5 = _mul12(ops, t5)
    X3 = sub(mul(t3, t1), mul(t4, t5))
    Y3 = add(mul(t1, Zc), mul(t5, t0))
    Z3 = add(mul(Zc, t4), mul(t0, t3))
    inf2 = ((X2 == 0).all(-1) & (Y2 == 0).all(-1))[..., None]  # the affine identity (0, 0)
    return torch.where(inf2, X1, X3), torch.where(inf2, Y1, Y3), torch.where(inf2, Z1, Z3)


def proj_double_formula(ops, P):
    """RCB Alg. 9 (a = 0): complete projective doubling, 6M + 2S + 1 x (3b)."""
    X, Y, Z = P
    mul, add, sub = ops.mul, ops.add, ops.sub
    t0 = mul(Y, Y)
    Z3 = ops.dbl(ops.dbl(ops.dbl(t0)))  # 8 Y^2
    t1 = mul(Y, Z)
    t2 = _mul12(ops, mul(Z, Z))  # 3b Z^2
    X3 = mul(t2, Z3)
    Y3 = add(t0, t2)
    Z3 = mul(t1, Z3)
    t2 = add(ops.dbl(t2), t2)  # 9b Z^2
    t0 = sub(t0, t2)  # Y^2 - 9b Z^2
    Y3 = add(mul(t0, Y3), X3)
    X3 = ops.dbl(mul(t0, mul(X, Y)))
    return X3, Y3, Z3


def proj_add_plain(P1, P2):
    return proj_add_formula(_PlainOps(P1[0].device), P1, P2)


def proj_double_plain(P):
    return proj_double_formula(_PlainOps(P[0].device), P)


def proj_madd_plain(P1, A2):
    return proj_madd_formula(_PlainOps(P1[0].device), P1, A2)


def fixed_base_mul_plain(tables, scalars_u32, window: int, add=proj_add_plain):
    """acc = O, then acc += T[w][digit_w(s)] for each window w: the gathers and
    adds of zktpu/curves/g1.py:300-320, with the plain add or `add` (proj_add:
    a launch a window, the loop the port ran before fixed_base_mul).  tables:
    X, Y, Z of T, (windows, 2^window, 12) each, T[w][0] = O."""
    TX, TY, TZ = tables
    sc = widen(scalars_u32)
    acc = tuple(t[0, 0].expand(sc.shape[0], LIMBS) for t in tables)  # O = (0 : 1 : 0)
    for w in range(TX.shape[0]):
        limb, off = divmod(w * window, 32)
        ids = (sc[:, limb] >> off) & ((1 << window) - 1)
        acc = add(acc, (TX[w][ids], TY[w][ids], TZ[w][ids]))
    return acc


def horner_combine_plain(parts, c: int):
    """The Horner combine as a loop of plain doubles and adds (module
    docstring of horner_combine)."""
    W = parts[0].shape[0]
    acc = tuple(a[W - 1] for a in parts)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = proj_double_plain(acc)
        acc = proj_add_plain(acc, tuple(a[w] for a in parts))
    return acc


_KIND = {"proj_add": 0, "proj_madd": 1, "proj_double": 2, "horner_combine": 3, "fixed_base_mul": 4}


def kernel_attrs(name: str) -> dict:
    """Registers per thread, local-memory bytes (spills) and shared memory
    per block of a kernel (the fixed-base kernel's dynamic shared memory at
    window 8 included)."""
    out = (ctypes.c_int * 3)()
    cuda_lib.check(cuda_lib.load().zk_g1_kernel_attrs(_KIND[name], out), f"{name} attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2]}


def fixed_base_design() -> dict:
    """The fixed-base kernel as built: threads a block and its launch bound's minimum blocks a SM."""
    out = (ctypes.c_int * 2)()
    cuda_lib.check(cuda_lib.load().zk_fixed_base_design(out), "fixed_base design")
    return {"threads": out[0], "min_blocks": out[1]}


def _plane(t: torch.Tensor, shape):
    """(pointer, outer stride, inner stride), strides in rows, of t read as
    the (outer, inner) flattening of batch `shape` (t broadcasts to it), or
    None where the strides cannot say it (the kernels need 16-byte aligned
    rows of contiguous limbs)."""
    ptr, sh, st = t.data_ptr(), t.shape, t.stride()
    if ptr % 16 or st[-1] != 1:
        return None
    k = len(shape)
    off = k - len(sh) + 1  # t's batch dims sit right-aligned under shape's
    strides = [0 if d < off or sh[d - off] == 1 else st[d - off] for d in range(k)]
    if not k:
        return ptr, 0, 0
    si = strides[-1] if shape[-1] != 1 else 0
    outer = [(s, x) for s, x in zip(shape[:-1], strides[:-1]) if s != 1]
    for (_, x0), (s1, x1) in zip(outer, outer[1:]):
        if x0 != x1 * s1:
            return None
    so = outer[-1][1] if outer else 0
    if so % LIMBS or si % LIMBS:
        return None
    so, si = so // LIMBS, si // LIMBS
    if (shape[-1] - 1) * si + sum((s - 1) * x for s, x in outer) // LIMBS >= 1 << 31:
        return None  # the kernels index rows in 32 bits
    return ptr, so, si


def _span(t: torch.Tensor):
    """The bytes [start, end) that t's elements lie in."""
    if t.numel() == 0:
        return t.data_ptr(), t.data_ptr()
    last = sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def _check_out(name: str, out, full, ins) -> None:
    if len(out) != 3:
        raise ValueError(f"{name}: out= takes three planes")
    for o in out:
        if tuple(o.shape) != full or o.dtype != torch.int32 or o.device != ins[0].device:
            raise ValueError(f"{name}: out= planes must be int32 {full} on {ins[0].device}, "
                             f"got {o.dtype} {tuple(o.shape)} on {o.device}")
        if any(st == 0 and s > 1 for s, st in zip(o.shape, o.stride())):
            raise ValueError(f"{name}: out= planes must not broadcast")
    spans = [_span(t) for t in out]
    others = spans + [_span(t) for t in ins]
    for k, (a0, a1) in enumerate(spans):
        if any(a0 < b1 and b0 < a1 for b0, b1 in others[k + 1:]):
            raise ValueError(f"{name}: out= planes must not overlap the inputs or each other")


def _run(name: str, plain, ins, out):
    """The group operation `name` on input coordinates `ins` (the first three
    are P1).  Returns (the three output planes, launched)."""
    full = tuple(ins[0].shape)
    if any(t.shape != full for t in ins):
        full = cuda_lib.broadcast_shapes(*[t.shape for t in ins])
    shape = full[:-1]
    if out is not None:
        _check_out(name, out, full, ins)
    if all(t.device.type == "cpu" for t in (*ins, *(out or ()))):
        res = plain(tuple(ins[:3]), tuple(ins[3:]))
        if out is None:
            return res, False
        for o, r in zip(out, res):
            o.copy_(r)
        return out, False
    cuda_lib.check_cuda_operands(name, (*ins, *(out or ())), LIMBS, contiguous=False)
    if out is None:
        out = tuple(torch.empty(full, dtype=torch.int32, device=ins[0].device) for _ in range(3))
    descs, keep = [], []  # keep: any copies, alive until the launch is enqueued
    for t in ins:
        d = _plane(t, shape)
        if d is None:  # a layout the strides cannot express: one contiguous copy
            t = t.expand(full).contiguous()
            keep.append(t)
            d = _plane(t, shape)
        descs.append(d)
    for o in out:
        d = _plane(o, shape)
        if d is None:
            raise ValueError(f"{name}: out= planes need contiguous limbs, 16-byte aligned rows "
                             f"and batch strides that collapse to (outer, inner)")
        descs.append(d)
    n = 1
    for s in shape:
        n *= s
    if n == 0:
        return out, False
    lib = cuda_lib.load()
    p, pinv = cuda_lib.field_consts(FQ)
    planes = np.array(descs, dtype=np.int64)
    rc = getattr(lib, f"zk_{name}")(
        ins[0].device.index, p, pinv, planes.ctypes.data, n, shape[-1] if shape else 1,
        cuda_lib.stream_of(out[0]),
    )
    cuda_lib.check(rc, name)
    return out, True


def proj_add(P1, P2, out=None):
    """Complete projective add of broadcastable (..., 12) triples; out=:
    three planes of the batch shape to write into."""
    res, launched = _run("proj_add", proj_add_plain, (*P1, *P2), out)
    proj_add.launches += launched
    return res


proj_add.launches = 0


def proj_double(P, out=None):
    """Complete projective doubling of a (..., 12) triple."""
    res, launched = _run("proj_double", lambda P1, _: proj_double_plain(P1), tuple(P), out)
    proj_double.launches += launched
    return res


proj_double.launches = 0


def proj_madd(P1, A2, out=None):
    """Mixed add of a projective (..., 12) triple and an affine (..., 12)
    pair, broadcastable; (0, 0) is the affine identity."""
    res, launched = _run("proj_madd", proj_madd_plain, (*P1, *A2), out)
    proj_madd.launches += launched
    return res


proj_madd.launches = 0


def horner_combine(parts, c: int):
    """sum_w 2^(c w) part_w of the MSM's window sums, three (W, K, 12)
    planes (W >= 1), as (K, 12) x 3: acc = part_{W-1}, then for w = W-2 .. 0
    c doublings and one add of part_w (MSB window first).  One launch of
    csrc/g1.cu's horner_combine_kernel for CUDA tensors, the plain loop for
    CPU tensors."""
    if all(t.device.type == "cpu" for t in parts):
        return horner_combine_plain(parts, c)
    W, K = parts[0].shape[:2]
    if any(t.shape != parts[0].shape for t in parts) or parts[0].ndim != 3 or W < 1:
        raise ValueError(f"horner_combine: parts must be three (W >= 1, K, 12) planes, "
                         f"got {[tuple(t.shape) for t in parts]}")
    ins = [t.contiguous() for t in parts]
    cuda_lib.check_cuda_operands("horner_combine", ins, LIMBS)
    out = tuple(torch.empty((K, LIMBS), dtype=torch.int32, device=ins[0].device) for _ in range(3))
    if K == 0:
        return out
    if any(t.data_ptr() % 16 for t in (*ins, *out)):
        raise ValueError("horner_combine: planes must be 16-byte aligned")
    lib = cuda_lib.load()
    p, pinv = cuda_lib.field_consts(FQ)
    ptrs = np.array([t.data_ptr() for t in (*ins, *out)], dtype=np.int64)
    rc = lib.zk_horner_combine(ins[0].device.index, p, pinv, ptrs.ctypes.data, W, K, int(c),
                               cuda_lib.stream_of(out[0]))
    cuda_lib.check(rc, "horner_combine")
    horner_combine.launches += 1
    return out


horner_combine.launches = 0


def fixed_base_mul(tables, scalars_u32, window: int):
    """[s_i] B for (N, 8) canonical u32-limb scalars from B's window table
    (fixed_base_mul_plain's tables; window divides 32) -> (N, 12) x 3
    projective.  One launch of csrc/g1.cu's fixed_base_kernel for CUDA
    tensors, the plain loop for CPU tensors.  The kernel takes windows of at
    most 8 bits and reads only the tables' X and Y planes: it needs each
    window's row 0 to be O and every other row affine (Z the Montgomery
    one), as fixed_base_tables builds them."""
    if 32 % window or window > 16 or tables[0].shape[:2] != (256 // window, 1 << window):
        raise ValueError(f"fixed_base_mul: window {window} with tables {tuple(tables[0].shape)}: the window must "
                         f"divide 32 and the tables be (256 / window, 2^window, 12)")
    if all(t.device.type == "cpu" for t in (*tables, scalars_u32)):
        return fixed_base_mul_plain(tables, scalars_u32, window)
    if scalars_u32.ndim != 2 or scalars_u32.shape[1] != 8 or scalars_u32.dtype != torch.int32:
        raise ValueError(f"fixed_base_mul: scalars must be (N, 8) int32 limbs, got {scalars_u32.dtype} "
                         f"{tuple(scalars_u32.shape)}")
    if window > 8:
        raise ValueError(f"fixed_base_mul: the kernel stages windows of at most 8 bits in shared memory, got {window}")
    sc = scalars_u32.contiguous()
    ins = [t.contiguous() for t in tables]
    cuda_lib.check_cuda_operands("fixed_base_mul", ins, LIMBS)
    if sc.device != ins[0].device:
        raise ValueError(f"fixed_base_mul: scalars on {sc.device}, tables on {ins[0].device}")
    n = sc.shape[0]
    out = tuple(torch.empty((n, LIMBS), dtype=torch.int32, device=sc.device) for _ in range(3))
    if n == 0:
        return out
    if sc.data_ptr() % 16:
        sc = sc.clone()
    if any(t.data_ptr() % 16 for t in (*ins, *out)):
        raise ValueError("fixed_base_mul: planes must be 16-byte aligned")
    lib = cuda_lib.load()
    p, pinv = cuda_lib.field_consts(FQ)
    ptrs = np.array([t.data_ptr() for t in (*ins[:2], sc, *out)], dtype=np.int64)
    rc = lib.zk_fixed_base_mul(sc.device.index, p, pinv, ptrs.ctypes.data, n, int(window),
                               cuda_lib.stream_of(out[0]))
    cuda_lib.check(rc, "fixed_base_mul")
    fixed_base_mul.launches += 1
    return out


fixed_base_mul.launches = 0
