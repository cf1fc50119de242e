"""Radix-2 evaluation domains with tensor NTT/iNTT (counterpart of
zktpu/poly/domain.py).

arkworks Radix2EvaluationDomain conventions, so values agree element for
element: size = next power of two; generator w = TWO_ADIC_ROOT^(2^(s - log n));
fft maps coefficients to [p(w^0), ..., p(w^(n-1))] in natural order; ifft
includes the 1/n scaling.  The tensor transform is a bit-reverse gather and
log n DIT butterfly stages.  Over Fr and Goldilocks it is
poly/ntt_kernel.py's ``ntt``: the NTT kernel for CUDA tensors (its stages in
shared-memory tiles, the coset factors and 1/n fused into its loads and
stores), the plain stage loop for CPU tensors.  Fq (two-adicity 1: domains
of at most two points) keeps the stage loop over the Montgomery product.
"""
from __future__ import annotations

import functools

import torch

from .. import config
from ..fields.fp import TorchField, field, ints_to_limbs, norm_device
from ..fields.host import FieldSpec
from .ntt_kernel import KERNEL_FIELDS, bit_reverse_perm, ntt, stage_loop

# Power tables of domains up to this size are built by host loops; larger
# ones by a log-depth cumulative product on the tensor's device.
_HOST_TWIDDLE_MAX = 1 << 12


class Radix2Domain:
    def __init__(self, spec: FieldSpec, size: int, device=None):
        assert size >= 1
        n = 1 << (size - 1).bit_length() if size > 1 else 1
        log_n = n.bit_length() - 1
        if log_n > spec.two_adicity:
            raise ValueError(f"domain size 2^{log_n} unsupported for {spec.name}")
        self.spec = spec
        self.device = norm_device(device)
        self.df: TorchField = field(spec, self.device)
        self.size = n
        self.log_n = log_n
        self.group_gen = spec.root_of_unity(n)
        self.group_gen_inv = spec.inv(self.group_gen) if n > 1 else 1
        self.size_inv = spec.inv(n)
        self._perm_np = bit_reverse_perm(n)
        self._fwd_tw = self._power_table(self.group_gen, max(n // 2, 1))
        self._inv_tw = self._power_table(self.group_gen_inv, max(n // 2, 1))
        self._elements = None
        self._offset_cache: dict[int, torch.Tensor] = {}
        self._coset_out_cache: dict[int, torch.Tensor] = {}

    # -- host helpers --

    def element(self, i: int) -> int:
        return self.spec.pow(self.group_gen, i % self.size)

    def elements_ints(self) -> list[int]:
        out, cur = [], 1
        for _ in range(self.size):
            out.append(cur)
            cur = self.spec.mul(cur, self.group_gen)
        return out

    def elements_device(self) -> torch.Tensor:
        """w^i for i < n as (n, L) Montgomery limbs (cached)."""
        if self._elements is None:
            self._elements = self.df.powers(self.group_gen, self.size)
        return self._elements

    def evaluate_vanishing(self, z: int) -> int:
        return (self.spec.pow(z, self.size) - 1) % self.spec.modulus

    def _power_table(self, gen: int, count: int) -> torch.Tensor:
        """[gen^j for j < count]: every stage's twiddles are a strided slice."""
        if self.size <= _HOST_TWIDDLE_MAX:
            spec, cur, vals = self.spec, 1, []
            for _ in range(count):
                vals.append(spec.to_mont(cur))
                cur = spec.mul(cur, gen)
            return torch.from_numpy(ints_to_limbs(vals, self.df.num_limbs)).to(self.device)
        return self.df.powers(gen, count)

    # -- tensor transforms --

    def _transform(self, values: torch.Tensor, inverse: bool, in_factor=None, out_factor=None) -> torch.Tensor:
        """out_factor * DIT(in_factor * values); with inverse and no
        out_factor the output factor is 1/n (ntt_kernel.py)."""
        assert values.shape[-2] == self.size, (values.shape, self.size)
        E = self._inv_tw if inverse else self._fwd_tw
        if self.spec in KERNEL_FIELDS:
            return ntt(values, E, inverse, in_factor, out_factor, self.spec)
        return stage_loop(self.spec, self.df.mont_mul, values, E, inverse, in_factor, out_factor)

    # -- host transform (small sizes: latency-bound, see config.py) --

    def _host_transform(self, values: list[int], inverse: bool) -> list[int]:
        """The same bit-reverse and DIT butterflies over Python ints."""
        spec, n = self.spec, self.size
        x = [values[int(self._perm_np[i])] for i in range(n)]
        gen = self.group_gen_inv if inverse else self.group_gen
        for s in range(1, self.log_n + 1):
            m = 1 << s
            w_m = spec.pow(gen, n // m)
            for k in range(0, n, m):
                w = 1
                for j in range(m // 2):
                    t = spec.mul(w, x[k + j + m // 2])
                    u = x[k + j]
                    x[k + j] = spec.add(u, t)
                    x[k + j + m // 2] = spec.sub(u, t)
                    w = spec.mul(w, w_m)
        if inverse:
            x = [spec.mul(v, self.size_inv) for v in x]
        return x

    def _host_tier(self, arr: torch.Tensor) -> bool:
        return self.size <= config.HOST_NTT_MAX and arr.ndim == 2

    def _transform_tiered(self, arr: torch.Tensor, inverse: bool) -> torch.Tensor:
        if self._host_tier(arr):
            out = self._host_transform(self.df.decode_ints(arr), inverse)
            return self.df.encode_ints(out)
        return self._transform(arr, inverse)

    def fft(self, coeffs: torch.Tensor, force_device: bool = False) -> torch.Tensor:
        """coeffs: (..., m, L) with m <= n, zero-padded to n."""
        coeffs = self._pad(coeffs)
        if self.size == 1:
            return coeffs
        if force_device:
            return self._transform(coeffs, inverse=False)
        return self._transform_tiered(coeffs, inverse=False)

    def ifft(self, evals: torch.Tensor, force_device: bool = False) -> torch.Tensor:
        assert evals.shape[-2] == self.size
        if self.size == 1:
            return evals
        if force_device:
            return self._transform(evals, inverse=True)
        return self._transform_tiered(evals, inverse=True)

    def _pad(self, coeffs: torch.Tensor) -> torch.Tensor:
        m = coeffs.shape[-2]
        if m == self.size:
            return coeffs
        assert m < self.size
        pad = torch.zeros(coeffs.shape[:-2] + (self.size - m, coeffs.shape[-1]), dtype=coeffs.dtype, device=coeffs.device)
        return torch.cat([coeffs, pad], dim=-2)

    # -- coset transforms: evaluate / interpolate on offset * <w> --

    def offset_powers(self, offset: int) -> torch.Tensor:
        if offset not in self._offset_cache:
            self._offset_cache[offset] = self._power_table(offset, self.size)
        return self._offset_cache[offset]

    def _coset_out(self, offset: int) -> torch.Tensor:
        """1/n offset^-i: coset_ifft's output factor, 1/n merged in."""
        if offset not in self._coset_out_cache:
            n_inv = self.df.encode_int(self.size_inv)
            self._coset_out_cache[offset] = self.df.mont_mul(self.offset_powers(self.spec.inv(offset)), n_inv)
        return self._coset_out_cache[offset]

    def coset_fft(self, coeffs: torch.Tensor, offset: int, force_device: bool = False,
                  out_factor: torch.Tensor | None = None) -> torch.Tensor:
        """coeffs: (..., m, L) with m <= n -> evaluations on offset * <w>;
        the tensor transform multiplies by offset^i as it loads, and by
        out_factor ((n, L) or (L,) Montgomery limbs, if given) as it stores."""
        coeffs = self._pad(coeffs)
        if self.size == 1 or (not force_device and self._host_tier(coeffs)):
            evals = self.fft(self.df.mont_mul(coeffs, self.offset_powers(offset)))
            return evals if out_factor is None else self.df.mont_mul(evals, out_factor)
        return self._transform(coeffs, False, in_factor=self.offset_powers(offset), out_factor=out_factor)

    def coset_ifft(self, evals: torch.Tensor, offset: int) -> torch.Tensor:
        """Evaluations on offset * <w> -> coefficients; the tensor transform
        multiplies by 1/n offset^-i as it stores."""
        assert evals.shape[-2] == self.size
        if self.size == 1 or self._host_tier(evals):
            return self.df.mont_mul(self.ifft(evals), self.offset_powers(self.spec.inv(offset)))
        return self._transform(evals, True, out_factor=self._coset_out(offset))


@functools.lru_cache(maxsize=None)
def _domain(spec: FieldSpec, size: int, device: torch.device) -> Radix2Domain:
    return Radix2Domain(spec, size, device)


def get_domain(spec: FieldSpec, size: int, device=None) -> Radix2Domain:
    """The cached domain of `size` (rounded up to a power of two) on `device`."""
    return _domain(spec, size, norm_device(device))
