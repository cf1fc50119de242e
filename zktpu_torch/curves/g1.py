"""BLS12-381 G1 over limb tensors (counterpart of zktpu/curves/g1.py).

Points are homogeneous projective triples (X, Y, Z) of (..., 12) Fq
Montgomery limb tensors; the identity is (0 : 1 : 0).  Affine points are
(X, Y) pairs with the identity (0, 0).  ``proj_add``, ``proj_double`` and
``proj_madd`` are kernels 2, 3 and 4 for CUDA tensors (curves/g1_kernel.py).
Functions that make tensors take ``device=None``: the current CUDA device.
"""
from __future__ import annotations

import functools

import torch

from .host_curve import G1Affine
from ..fields.host import FQ
from ..fields.fp import field, ints_to_limbs, norm_device
from ..profiling import check_on_curve
from . import g1_kernel
from .g1_kernel import LIMBS, proj_add, proj_double, proj_madd  # noqa: F401 (re-exported)


def proj_identity(shape=(), device=None):
    """(0 : 1 : 0) with batch `shape`; Y is the Montgomery one."""
    fq = field(FQ, device)
    z = torch.zeros(tuple(shape) + (LIMBS,), dtype=torch.int32, device=fq.device)
    return z, fq.one.expand_as(z).clone(), z.clone()


def affine_to_proj(x: torch.Tensor, y: torch.Tensor, inf_mask=None):
    """Affine Montgomery coordinates -> projective; inf_mask marks identities."""
    one = field(FQ, x.device).one.expand_as(x)
    if inf_mask is None:
        return x, y, one.clone()
    m = inf_mask[..., None]
    zero = torch.zeros_like(x)
    return torch.where(m, zero, x), torch.where(m, one, y), torch.where(m, zero, one)


def host_points_to_device(points: list[G1Affine], device=None):
    fq = field(FQ, device)
    xs = fq.encode_ints([p.x for p in points])
    ys = fq.encode_ints([p.y for p in points])
    inf = torch.tensor([p.infinity for p in points], dtype=torch.bool, device=fq.device)
    return affine_to_proj(xs, ys, inf)


def proj_tree_sum(P, axis: int = 0):
    """Sum a batch of projective points along `axis` by log-depth tree adds."""
    X, Y, Z = (torch.movedim(a, axis, 0) for a in P)
    while X.shape[0] > 1:
        half = X.shape[0] // 2
        s = proj_add((X[:half], Y[:half], Z[:half]), (X[half : 2 * half], Y[half : 2 * half], Z[half : 2 * half]))
        X, Y, Z = (torch.cat([a, b[2 * half :]], dim=0) for a, b in zip(s, (X, Y, Z)))
    return X[0], Y[0], Z[0]


def proj_to_affine_host(P) -> list[G1Affine]:
    """Batch of projective points -> host affine points (one host inversion each)."""
    fq = field(FQ, P[0].device)
    # X, Y and Z decoded together: one from_mont and one copy to the host
    ints = fq.decode_ints(torch.stack([a.reshape(-1, LIMBS) for a in P]))
    n = len(ints) // 3
    x_ints, y_ints, z_ints = ints[:n], ints[n:2 * n], ints[2 * n:]
    p = FQ.modulus
    out = []
    for x, y, z in zip(x_ints, y_ints, z_ints):
        if z == 0:
            out.append(G1Affine.identity())
        else:
            zi = pow(z, -1, p)
            out.append(G1Affine(x * zi % p, y * zi % p))
    check_on_curve(out, "proj_to_affine_host")
    return out


def proj_to_affine_dev(P):
    """Projective (N, 12) triple -> affine (Xa, Ya) planes on the same device.

    One Montgomery-trick batch inversion (log-depth cumulative products and
    one host inversion of the total), then two products; the counterpart of
    zktpu/curves/g1.py::proj_to_affine_dev.  Every Z must be nonzero (no
    identity points), as in an SRS power table."""
    X, Y, Z = P
    fq = field(FQ, Z.device)
    p = FQ.modulus
    zinv = fq.batch_inv(Z, host_inv=lambda v: pow(v, -1, p))
    return fq.mont_mul(X, zinv), fq.mont_mul(Y, zinv)


# ---------------------------------------------------------------------------
# Fixed-base batch scalar multiplication (SRS generation)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def fixed_base_tables(base: G1Affine, window: int, device: torch.device):
    """tables[k][j] = j * 2^(window k) * base, as (windows, 2^window, 12)
    projective planes on `device` (host affine adds, made once per base,
    window and device).  Row 0 of each window is O and every other row is
    affine, Z the Montgomery one, as the fixed-base kernel needs (every
    point but O has the odd prime order r, and no j 2^(window k) with
    0 < j < 2^window is a multiple of r)."""
    if base.infinity:
        raise ValueError("fixed_base_tables: the base is the identity")
    num_windows = -(-256 // window)
    xs, ys, infs = [], [], []
    cur = base
    for _ in range(num_windows):
        row = [G1Affine.identity()]
        for _ in range(1, 1 << window):
            row.append(row[-1] + cur)
        xs += [pt.x for pt in row]
        ys += [pt.y for pt in row]
        infs += [pt.infinity for pt in row]
        for _ in range(window):
            cur = cur + cur
    assert infs == [j == 0 for _ in range(num_windows) for j in range(1 << window)], "a table row is O"
    fq = field(FQ, device)
    shape = (num_windows, 1 << window, LIMBS)
    inf = torch.tensor(infs, dtype=torch.bool, device=fq.device).reshape(shape[:2])
    return affine_to_proj(fq.encode_ints(xs).reshape(shape), fq.encode_ints(ys).reshape(shape), inf)


def scalars_to_u32(scalars, device=None) -> torch.Tensor:
    """Python ints (< 2^256) -> (N, 8) little-endian u32 limbs (int32 bit patterns)."""
    arr = ints_to_limbs([int(s) for s in scalars], 8)
    return torch.from_numpy(arr).to(norm_device(device))


def fixed_base_mul_u32(base: G1Affine, scalars_u32: torch.Tensor, window: int = 8):
    """[s_i] base for (N, 8) canonical u32-limb scalars -> projective batch,
    on the scalars' device: one launch of the fixed-base kernel on the card
    (g1_kernel.fixed_base_mul), its plain loop on the CPU."""
    tables = fixed_base_tables(base, window, norm_device(scalars_u32.device))
    return g1_kernel.fixed_base_mul(tables, scalars_u32, window)


def fixed_base_mul(base: G1Affine, scalars, window: int = 8, device=None):
    """[s_i] base for a batch of host-int scalars -> projective batch on `device`."""
    return fixed_base_mul_u32(base, scalars_to_u32(scalars, device), window)
