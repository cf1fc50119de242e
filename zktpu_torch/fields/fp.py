"""Prime-field arithmetic over limb tensors (counterpart of zktpu/fields/fp.py).

A field element is (..., L) little-endian 32-bit limbs in a torch.int32
tensor, Montgomery form with R = 2^(32 L) (the same R as zktpu's 16-bit-digit
layout), canonical (< p).  ``mont_mul`` is kernel 1 (fields/mont_kernel.py);
add, sub, neg and double are kernel B and the scans (cumprod, cumsum, sum,
powers, batch_inv) kernel A (fields/field_kernel.py); ``lincomb`` (a sum of
products and addends in one pass, Fr) is field_lincomb
(fields/lincomb_kernel.py).  Each runs its kernel
for CUDA tensors and its plain version for CPU tensors.  Every op is
shape-polymorphic over leading axes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import field_kernel as _fk
from . import lincomb_kernel as _lc
from ..profiling import debug_enabled
from .host import FieldSpec
from .limbs import widen
from .mont_kernel import mont_mul as _mont_mul


def ints_to_limbs(values, limbs: int) -> np.ndarray:
    """Host: iterable of Python ints (< 2^(32 limbs)) -> (N, limbs) int32."""
    values = list(values)
    buf = b"".join(int(v).to_bytes(4 * limbs, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(len(values), limbs).view(np.int32).copy()


def limbs_to_ints(arr) -> list[int]:
    """Host: (..., L) int32 limbs -> list of Python ints (row-major)."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.int32))
    nbytes = 4 * a.shape[-1]
    buf = a.astype("<i4").tobytes()
    return [int.from_bytes(buf[i : i + nbytes], "little") for i in range(0, len(buf), nbytes)]


class NoCudaDeviceError(RuntimeError):
    """An entry point was asked for the default device and no CUDA device is present."""


def norm_device(device=None) -> torch.device:
    """The device a call runs on: `device` if given, else the current CUDA
    device.  Without a CUDA device the default raises; it never falls back
    to the CPU (pass device="cpu" for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "zktpu_torch: no CUDA device is available for the default device; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class TorchField:
    """Vectorised arithmetic of one prime field on one device."""

    def __init__(self, spec: FieldSpec, device):
        self.spec = spec
        self.device = norm_device(device)
        self.num_limbs = L = spec.num_digits // 2
        self._p = widen(self._const(spec.modulus))
        self._neg_p = widen(self._const(spec.mont_r - spec.modulus))  # R - p
        self.zero = torch.zeros(L, dtype=torch.int32, device=self.device)
        self.one = self._const(spec.to_mont(1))
        self._r2 = self._const(spec.mont_r2)
        self._one_raw = self._const(1)

    def _const(self, v: int) -> torch.Tensor:
        return torch.from_numpy(ints_to_limbs([v], self.num_limbs)[0]).to(self.device)

    # -- arithmetic --

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a * b * R^{-1} mod p (canonical)."""
        return _mont_mul(self.spec, a, b)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _fk.add(self, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _fk.sub(self, a, b)

    def lincomb(self, products, addends=()) -> torch.Tensor:
        """sum (+-) a b over `products` (a, b, sign) plus sum (+-) c over
        `addends` (c, sign), rows past an operand's length read as 0: one
        launch of field_lincomb (Fr; fields/lincomb_kernel.py)."""
        return _lc.lincomb(self, products, addends)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return _fk.sub(self, self.zero, a)

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def sum(self, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
        return _fk.field_sum(self, a, axis)

    def cumprod(self, a: torch.Tensor, axis: int = 0, reverse: bool = False) -> torch.Tensor:
        return _fk.scan(self, a, _fk.OP_MUL, axis, reverse)

    def cumsum(self, a: torch.Tensor, axis: int = 0, reverse: bool = False) -> torch.Tensor:
        return _fk.scan(self, a, _fk.OP_ADD, axis, reverse)

    def powers(self, base: int, count: int) -> torch.Tensor:
        """[1, z, ..., z^(count-1)] as (count, L) Montgomery limbs."""
        return _fk.powers(self, base, count)

    def batch_inv(self, a: torch.Tensor, host_inv) -> torch.Tensor:
        """Montgomery-trick batch inversion over the leading axis; the total
        product is inverted on the host by `host_inv` (int -> int)."""
        return _fk.batch_inv(self, a, host_inv)

    # -- conversions --

    def to_mont(self, raw: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(raw, self._r2)

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, self._one_raw)

    def to_u32_limbs(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery limbs -> canonical little-endian u32 limbs (int32), on
        the tensor's device (the MSM scalar format)."""
        return self.from_mont(a)

    def encode_ints(self, values) -> torch.Tensor:
        """Canonical Python ints -> Montgomery limbs on the field's device."""
        spec = self.spec
        mont = [spec.to_mont(int(v) % spec.modulus) for v in values]
        if not mont:
            return torch.zeros((0, self.num_limbs), dtype=torch.int32, device=self.device)
        return torch.from_numpy(ints_to_limbs(mont, self.num_limbs)).to(self.device)

    def encode_int(self, value: int) -> torch.Tensor:
        return self._const(self.spec.to_mont(int(value) % self.spec.modulus))

    def decode_ints(self, arr: torch.Tensor) -> list[int]:
        """Montgomery limbs -> canonical Python ints (from_mont on the device)."""
        if arr.numel() == 0:
            return []
        words = arr.reshape(-1, self.num_limbs)
        if debug_enabled():
            self._check_words(words)
        return limbs_to_ints(self.from_mont(words).cpu().numpy())

    def _check_words(self, words: torch.Tensor) -> None:
        """ZKTPU_DEBUG's sanitizer: kernels must hand back 32-bit limbs of
        fully reduced (< p) Montgomery values (one host pass)."""
        host = words.cpu().numpy().astype(np.int64)
        if words.dtype != torch.int32:  # int32 limbs are 32-bit by their type
            lo, hi = int(host.min()), int(host.max())
            assert lo >= 0 and hi < 1 << 32, (
                f"ZKTPU_DEBUG: limb overflow in decode_ints (min={lo:#x}, max={hi:#x}, limbs are 32-bit)"
            )
        p = self.spec.modulus
        for i, v in enumerate(limbs_to_ints(host.astype(np.uint32).view(np.int32))):
            assert 0 <= v < p, f"ZKTPU_DEBUG: unreduced Montgomery value at [{i}]: {v:#x}"

    def decode_int(self, arr: torch.Tensor) -> int:
        return self.decode_ints(arr.reshape(1, -1))[0]


@functools.lru_cache(maxsize=None)
def _field(spec: FieldSpec, device: torch.device) -> TorchField:
    return TorchField(spec, device)


def field(spec: FieldSpec, device=None) -> TorchField:
    """The cached TorchField of `spec` on `device`."""
    return _field(spec, norm_device(device))
