"""The four-step (Bailey) NTT over a mesh (counterpart of zktpu/dist/ntt.py).

For n = R C, x[j1 C + j2] is an (R, C) matrix:
  1. length-R NTTs down the columns (j1 -> k1);
  2. the twiddles w_n^(k1 j2);
  3. length-C NTTs along the rows (j2 -> k2);
  4. read out X[k1 + R k2].
Each rank holds n/P consecutive values of x in natural order (R/P rows), and
gets n/P consecutive values of X.  Three all_to_all_single transposes move
the data between row and column shards; the local transforms are the
domains' tensor NTTs (Radix2Domain._transform: the NTT kernel on a card) and
the twiddle product is mont_mul, so the values are the single-device
transform's (get_domain(spec, n).fft), word for word.
"""
from __future__ import annotations

import functools

import torch

from ..fields.fp import field
from ..fields.host import FieldSpec
from ..poly.domain import Radix2Domain, get_domain
from .mesh import Mesh


class FourStepNTT:
    def __init__(self, spec: FieldSpec, size: int, mesh: Mesh):
        assert size & (size - 1) == 0 and size > 1
        self.spec = spec
        self.size = size
        self.mesh = mesh
        self.ndev = mesh.size
        log_n = size.bit_length() - 1
        self.R = 1 << (log_n // 2)
        self.C = size // self.R
        if self.R % self.ndev or self.C % self.ndev:
            raise ValueError(
                f"four-step NTT needs ndev | R and ndev | C (n={size}, ndev={self.ndev})"
            )
        self.df = field(spec, mesh.device)
        self.dom_r = get_domain(spec, self.R, mesh.device)
        self.dom_c = get_domain(spec, self.C, mesh.device)
        self.omega_n = spec.root_of_unity(size)
        self._twiddle_cache: dict[bool, torch.Tensor] = {}

    def _twiddles(self, inverse: bool) -> torch.Tensor:
        """W[k1, t] = w^(k1 j2) for this rank's columns j2 = j0 + t, (R, C/P, L) Montgomery limbs."""
        if inverse not in self._twiddle_cache:
            df, spec, R = self.df, self.spec, self.R
            cols = self.C // self.ndev
            w = spec.inv(self.omega_n) if inverse else self.omega_n
            step = df.powers(w, R)  # w^k1
            first = df.powers(spec.pow(w, self.mesh.rank * cols), R)  # w^(k1 j0)
            rows = torch.cat([first[:, None], step[:, None].expand(R, cols - 1, df.num_limbs)], dim=1)
            self._twiddle_cache[inverse] = df.cumprod(rows, axis=1)
        return self._twiddle_cache[inverse]

    @staticmethod
    def _local(dom: Radix2Domain, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """Length-dom.size transforms along axis -2 (none for one point)."""
        return x if dom.size == 1 else dom._transform(x, inverse)

    def _run(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        P, R, C = self.ndev, self.R, self.C
        rows, cols, L = R // P, C // P, self.df.num_limbs
        if tuple(x.shape) != (self.size // P, L):
            raise ValueError(f"four-step NTT: expected this rank's ({self.size // P}, {L}) rows, got {tuple(x.shape)}")
        a2a = self.mesh.all_to_all
        # my rows, column block q to rank q -> (R, C/P): every row, my columns
        x = a2a(x.reshape(rows, P, cols, L).transpose(0, 1)).reshape(R, cols, L)
        x = self._local(self.dom_r, x.transpose(0, 1).contiguous(), inverse).transpose(0, 1)
        x = self.df.mont_mul(x.contiguous(), self._twiddles(inverse))
        # row block q to rank q -> (R/P, C): my rows (k1), every column
        x = a2a(x.reshape(P, rows, cols, L)).transpose(0, 1).reshape(rows, C, L)
        x = self._local(self.dom_c, x.contiguous(), inverse)
        # X[k1 + R k2]: every k1 of my block of k2, transposed locally
        x = a2a(x.reshape(rows, P, cols, L).transpose(0, 1)).reshape(R, cols, L)
        return x.transpose(0, 1).reshape(self.size // P, L)

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """This rank's n/P coefficients -> its n/P evaluations, natural order."""
        return self._run(coeffs, inverse=False)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        """The inverse, with its 1/n (the two local inverses give 1/R and 1/C)."""
        return self._run(evals, inverse=True)


@functools.lru_cache(maxsize=None)
def get_four_step(spec: FieldSpec, size: int, mesh: Mesh) -> FourStepNTT:
    return FourStepNTT(spec, size, mesh)
