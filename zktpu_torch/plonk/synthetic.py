"""Synthetic PLONK circuits built directly as tensors (counterpart of
zktpu/plonk/synthetic.py).

n multiplication gates a_i * b_i = c_i chained by a_{i+1} = c_i, so every
gate's output is copy-constrained into the next gate's left input:

  sigma_1 = [w^0,  k2 w^0, k2 w^1, ..., k2 w^{n-2}]   (a_{i+1} <-> c_i)
  sigma_2 = [k1 w^i]                                   (b_i self-wired)
  sigma_3 = [w^1, w^2, ..., w^{n-1}, k2 w^{n-1}]       (c_i <-> a_{i+1})

with k1 = 2, k2 = 3.  The witness comes from np.random.default_rng(seed), so
the circuit equals zktpu's synthetic_mul_chain(log_n, seed) exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.host import FR
from ..fields.fp import field
from ..poly.domain import get_domain
from ..poly.poly import Poly, poly_from_evals
from .constraint import CompiledCircuit, CopyConstraints, GateConstraints


def synthetic_mul_chain(log_n: int, seed: int = 1, device=None) -> CompiledCircuit:
    """A valid n = 2^log_n gate multiplication-chain circuit with witness."""
    n = 1 << log_n
    assert n >= 2
    dom = get_domain(FR, n, device)
    df = field(FR, device)

    # witness: b_i pseudorandom nonzero 16-bit values; a_0 = seed;
    # c_i = a_i b_i; a_{i+1} = c_i
    rng = np.random.default_rng(seed)
    b_raw = rng.integers(1, 1 << 16, size=n, dtype=np.uint64)
    raw = np.zeros((n, df.num_limbs), dtype=np.int32)
    raw[:, 0] = b_raw.astype(np.int32)  # < 2^16: one limb
    b_e = df.to_mont(torch.from_numpy(raw).to(df.device))
    first = df.encode_int(FR.mul(seed, int(b_raw[0])))
    c_e = df.cumprod(torch.cat([first[None], b_e[1:]], dim=0), axis=0)
    a_e = torch.cat([df.encode_int(seed)[None], c_e[:-1]], dim=0)

    # selectors: pure multiplication gates
    qm_e = df.one.expand(n, -1)
    qo_e = df.neg(df.one).expand(n, -1)
    zero_e = df.zero.expand(n, -1)

    # copy permutation
    k1, k2 = 2, 3
    roots = dom.elements_device()
    k1_roots = df.mont_mul(roots, df.encode_int(k1))
    k2_roots = df.mont_mul(roots, df.encode_int(k2))
    s1_e = torch.cat([roots[:1], k2_roots[:-1]], dim=0)
    s2_e = k1_roots
    s3_e = torch.cat([roots[1:], k2_roots[-1:]], dim=0)

    evals = {
        "a": a_e, "b": b_e, "c": c_e,
        "ql": zero_e, "qr": zero_e, "qm": qm_e, "qo": qo_e, "qc": zero_e, "pi": zero_e,
    }
    gate_constraints = GateConstraints(
        f_ax=poly_from_evals(dom, a_e),
        f_bx=poly_from_evals(dom, b_e),
        f_cx=poly_from_evals(dom, c_e),
        q_lx=Poly.zero(FR, df.device),
        q_rx=Poly.zero(FR, df.device),
        # the interpolation of a constant column is the constant polynomial
        q_ox=Poly.constant(FR, FR.neg(1), df.device),
        q_mx=Poly.constant(FR, 1, df.device),
        q_cx=Poly.zero(FR, df.device),
        pi_x=Poly.zero(FR, df.device),
        evals=evals,
    )
    copy_constraints = CopyConstraints(
        s_sigma_1=poly_from_evals(dom, s1_e),
        s_sigma_2=poly_from_evals(dom, s2_e),
        s_sigma_3=poly_from_evals(dom, s3_e),
        k1=k1,
        k2=k2,
        evals={"s1": s1_e, "s2": s2_e, "s3": s3_e},
    )
    return CompiledCircuit(size=n, gate_constraints=gate_constraints, copy_constraints=copy_constraints)
