"""Kernels 2, 3 and 4: the fused complete projective G1 add, double and
mixed add, and their plain PyTorch versions.

Replace zktpu/curves/pallas_g1.py::_proj_add_call, _proj_double_call and
_proj_madd_call (entry points proj_add_pallas, proj_double_pallas and
proj_madd_pallas).  Points are homogeneous projective triples of (..., 12)
Fq Montgomery limb tensors; the identity is (0 : 1 : 0).  The formulas are
RCB 2015/1060 Alg. 7 (add, 12M), Alg. 8 (mixed add, 11M: projective plus
affine with Z2 = 1) and Alg. 9 (double, 6M + 2S) for a = 0, complete, with
no branch.  The mixed add's affine identity is (0, 0), off the curve, which
its final select handles; zero-padded rows therefore come out as P1.

The CUDA kernels are csrc/g1.cu (formulas in csrc/g1.cuh).  On the H100 they
are bound by registers and occupancy: one thread holds about 15 live Fq
values of 12 limbs each, near the 255-register ceiling, so few warps fit on
an SM.  The simple design accepts that: one thread per point, the whole
formula fused so intermediates never touch device memory, and a launch bound
of 128 threads so that no value has to spill.

The plain versions run the same operation sequence with the plain Montgomery
product; the wrappers use them for CPU tensors only.
"""
from __future__ import annotations

import torch

from ..fields.host import FQ
from .. import cuda_lib
from ..fields.fp import field
from ..fields.mont_kernel import mont_mul_plain

LIMBS = FQ.num_digits // 2


class _PlainOps:
    """Fq ops for the plain group law: the plain product and tensor add/sub."""

    def __init__(self, device: torch.device):
        f = field(FQ, device)
        self.add, self.sub, self.dbl = f.add, f.sub, f.double

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


def _flatten(name: str, coords):
    shape = torch.broadcast_shapes(*[t.shape[:-1] for t in coords])
    flat = [t.expand(tuple(shape) + (LIMBS,)).contiguous() for t in coords]
    cuda_lib.check_cuda_operands(name, flat, LIMBS)
    n = 1
    for s in shape:
        n *= s
    outs = tuple(torch.empty_like(flat[0]) for _ in range(3))
    return flat, outs, n


def proj_add(P1, P2):
    """Complete projective add of broadcastable (..., 12) triples."""
    if all(t.device.type == "cpu" for t in (*P1, *P2)):
        return proj_add_plain(P1, P2)
    flat, outs, n = _flatten("proj_add", (*P1, *P2))
    if n:
        lib = cuda_lib.load()
        p, pinv = cuda_lib.field_consts(FQ)
        rc = lib.zk_proj_add(
            flat[0].device.index, p.ctypes.data, pinv,
            *(t.data_ptr() for t in flat), *(t.data_ptr() for t in outs), n,
            cuda_lib.stream_of(outs[0]),
        )
        cuda_lib.check(rc, "proj_add")
        proj_add.launches += 1
    return outs


proj_add.launches = 0


def proj_double(P):
    """Complete projective doubling of a (..., 12) triple."""
    if all(t.device.type == "cpu" for t in P):
        return proj_double_plain(P)
    flat, outs, n = _flatten("proj_double", P)
    if n:
        lib = cuda_lib.load()
        p, pinv = cuda_lib.field_consts(FQ)
        rc = lib.zk_proj_double(
            flat[0].device.index, p.ctypes.data, pinv,
            *(t.data_ptr() for t in flat), *(t.data_ptr() for t in outs), n,
            cuda_lib.stream_of(outs[0]),
        )
        cuda_lib.check(rc, "proj_double")
        proj_double.launches += 1
    return outs


proj_double.launches = 0


def proj_madd(P1, A2):
    """Mixed add of a projective (..., 12) triple and an affine (..., 12)
    pair, broadcastable; (0, 0) is the affine identity."""
    if all(t.device.type == "cpu" for t in (*P1, *A2)):
        return proj_madd_plain(P1, A2)
    flat, outs, n = _flatten("proj_madd", (*P1, *A2))
    if n:
        lib = cuda_lib.load()
        p, pinv = cuda_lib.field_consts(FQ)
        rc = lib.zk_proj_madd(
            flat[0].device.index, p.ctypes.data, pinv,
            *(t.data_ptr() for t in flat), *(t.data_ptr() for t in outs), n,
            cuda_lib.stream_of(outs[0]),
        )
        cuda_lib.check(rc, "proj_madd")
        proj_madd.launches += 1
    return outs


proj_madd.launches = 0
