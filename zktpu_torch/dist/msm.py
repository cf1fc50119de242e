"""The Pippenger MSM over a mesh (counterpart of zktpu/dist/msm.py).

Points and scalars are sharded along the batch axis: each rank runs the
whole windowed MSM on its rows (curves/msm.py, the tensor path at any size),
the partial sums are gathered (all_gather, 3 field elements a point per
rank and vector) and added by a log-depth tree (g1.proj_tree_sum), so every
rank holds the whole sum.
"""
from __future__ import annotations

import torch

from ..curves.g1 import proj_tree_sum
from ..curves.msm import msm_proj_many
from .mesh import Mesh


def msm_sharded_many(scalars_u32: torch.Tensor, X, Y, Z, *, mesh: Mesh, c: int = 8):
    """This rank's rows of K MSMs over one point set ((K, n/P, 8) scalars,
    (n/P, 12) projective points) -> K projective points ((K, 12) x 3), the
    whole sums, on every rank."""
    local = torch.stack(msm_proj_many(scalars_u32, X, Y, Z, c=c))  # (3, K, 12)
    parts = mesh.all_gather(local[None])  # (P, 3, K, 12)
    return proj_tree_sum(tuple(parts[:, k] for k in range(3)), axis=0)


def msm_jacobian_sharded(scalars_u32: torch.Tensor, X, Y, Z, *, mesh: Mesh, c: int = 8):
    """This rank's rows of an MSM ((n/P, 8) scalars, (n/P, 12) projective
    points) -> the whole sum, one projective point ((12,) x 3), on every rank."""
    return tuple(a[0] for a in msm_sharded_many(scalars_u32[None], X, Y, Z, mesh=mesh, c=c))
