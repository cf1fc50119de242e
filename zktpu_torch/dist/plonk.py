"""PLONK round 1's wire commitments over a mesh (counterpart of
zktpu/dist/plonk.py).

Each wire column is interpolated by the four-step inverse NTT (its values
stay sharded: each rank gets n/P consecutive coefficients), turned into
canonical scalars on the rank, and committed by the sharded MSM against the
rank's rows of the SRS powers; the three wires share one MSM call (three
scalar vectors, msm_sharded_many).

Blinding (plonk/src/prover.rs:68-90) adds (b_hi X + b_lo) Z_H(X) to each
wire, which touches the coefficients 0, 1, n and n + 1 only: the blinded
commitment is the sharded one plus b_hi ([s^(n+1)] - [s]) + b_lo ([s^n] - [1]),
four host scalar multiplications.
"""
from __future__ import annotations

import functools

import torch

from ..curves import g1 as g1mod
from ..fields.fp import field
from ..fields.host import FR, FieldSpec
from .mesh import Mesh, shard_leading
from .msm import msm_sharded_many
from .ntt import get_four_step


class ShardedWireCommitter:
    """Round 1's wire interpolation and commitment over `mesh`: spec the
    scalar field (FR), n the domain size (the four-step NTT's divisibility
    holds for the mesh), c the Pippenger window.

    Zero knowledge: ``__call__`` commits the UNBLINDED interpolations, the
    sharded O(n) building block; a prover uses ``commit_blinded``, which adds
    the reference's wire blinding."""

    def __init__(self, spec: FieldSpec, n: int, mesh: Mesh, c: int = 8):
        self.spec = spec
        self.df = field(spec, mesh.device)
        self.n = n
        self.mesh = mesh
        self.c = c
        self.fs = get_four_step(spec, n, mesh)

    def __call__(self, evals3: torch.Tensor, X, Y, Z):
        """evals3: this rank's rows of the three wire evaluation columns
        ((3, n/P, 8) Montgomery limbs); X, Y, Z: this rank's rows of the
        SRS powers ((n/P, 12) each).  Returns the three projective
        commitments ((12,) x 3 each), on every rank."""
        sc = torch.stack([self.df.to_u32_limbs(self.fs.ifft(e)) for e in evals3])
        S = msm_sharded_many(sc, X, Y, Z, mesh=self.mesh, c=self.c)
        return tuple(tuple(a[i] for a in S) for i in range(len(evals3)))

    def commit_blinded(self, evals3: torch.Tensor, srs, blinds):
        """Zero-knowledge round-1 commitments: the sharded commitment of each
        wire plus its blinding correction.  evals3 as in __call__; srs: the
        whole SRS (at least n + 2 powers); blinds: three (b_hi, b_lo) int
        pairs.  Returns three host G1Affine points, those of the blinded
        polynomials f + (b_hi X + b_lo) Z_H committed directly."""
        n = self.n
        raw = self(evals3, *(shard_leading(self.mesh, a[:n]) for a in srs.g1_proj))
        pts = g1mod.proj_to_affine_host(tuple(torch.stack([p[k] for p in raw]) for k in range(3)))
        idx = torch.tensor([0, 1, n, n + 1], device=srs.device)
        p0, p1, pn, pn1 = g1mod.proj_to_affine_host(tuple(a[idx] for a in srs.g1_proj))
        return [pt + (pn1 - p1).mul(b_hi) + (pn - p0).mul(b_lo) for pt, (b_hi, b_lo) in zip(pts, blinds)]


@functools.lru_cache(maxsize=None)
def get_wire_committer(n: int, mesh: Mesh, c: int = 8) -> ShardedWireCommitter:
    return ShardedWireCommitter(FR, n, mesh, c)
