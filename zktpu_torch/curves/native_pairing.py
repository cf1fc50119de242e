"""ctypes binding for the native C++ pairing (zktpu_torch/csrc/pairing.cpp).

The port's own copy of zktpu/curves/native_pairing.py, with one change: the
library is built into ``build/zktpu_torch/`` at the root of the checkout (git
ignores it), named by a hash of the source, and never into ``native/``.

Builds the shared library on first use with the host g++ (the toolchain is
part of the target environment; pybind11 is not, so the binding is plain
ctypes over a C ABI).  Falls back silently to the pure-python pairing when
building or loading fails — `native_pairing_product` returns None in that
case and zktpu_torch/curves/pairing.py keeps using its own implementation.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from ..fields.host import FQ, FR

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "pairing.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "zktpu_torch")
_FLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + b"\0" + f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libzkpairing-{digest}.so")


@functools.lru_cache(maxsize=1)
def _final_exp_bytes() -> bytes:
    q = FQ.modulus
    e = (q**12 - 1) // FR.modulus
    return e.to_bytes((e.bit_length() + 7) // 8, "little")


@functools.lru_cache(maxsize=1)
def _load():
    """Compile (if needed) and load the library; None on any failure."""
    if os.environ.get("ZKTPU_NO_NATIVE_PAIRING"):
        return None
    lib_path = library_path()
    try:
        if not os.path.exists(lib_path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", *_FLAGS, "-o", tmp, _SRC],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, lib_path)  # atomic: concurrent builders never see a partial file
        lib = ctypes.CDLL(lib_path)
    except (OSError, subprocess.SubprocessError):
        return None
    fn = lib.zkp_pairing_product
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),  # g1 coords
        ctypes.POINTER(ctypes.c_uint8),   # g1 infinity flags
        ctypes.POINTER(ctypes.c_uint64),  # g2 coords
        ctypes.POINTER(ctypes.c_uint8),   # g2 infinity flags
        ctypes.c_size_t,                  # n pairs
        ctypes.POINTER(ctypes.c_uint8),   # final exponent, little-endian
        ctypes.c_size_t,                  # exponent byte length
        ctypes.POINTER(ctypes.c_uint64),  # out: 72 limbs (12 x Fq)
    ]
    return fn


def _limbs6(v: int) -> list[int]:
    return [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(6)]


def native_pairing_product(pairs):
    """prod_i e(P_i, Q_i) via the native library; None if unavailable.

    Returns the 12 canonical Fq coefficients (tower order c0.c0.c0 ...
    c1.c2.c1) as a list of python ints.
    """
    fn = _load()
    if fn is None:
        return None
    pairs = list(pairs)
    n = len(pairs)
    g1 = np.zeros(n * 12, dtype=np.uint64)
    g1_inf = np.zeros(n, dtype=np.uint8)
    g2 = np.zeros(n * 24, dtype=np.uint64)
    g2_inf = np.zeros(n, dtype=np.uint8)
    for i, (p, q) in enumerate(pairs):
        g1_inf[i] = 1 if p.infinity else 0
        g2_inf[i] = 1 if q.infinity else 0
        if not p.infinity:
            g1[i * 12 : i * 12 + 6] = _limbs6(p.x)
            g1[i * 12 + 6 : i * 12 + 12] = _limbs6(p.y)
        if not q.infinity:
            g2[i * 24 : i * 24 + 6] = _limbs6(q.x.c0)
            g2[i * 24 + 6 : i * 24 + 12] = _limbs6(q.x.c1)
            g2[i * 24 + 12 : i * 24 + 18] = _limbs6(q.y.c0)
            g2[i * 24 + 18 : i * 24 + 24] = _limbs6(q.y.c1)
    exp = _final_exp_bytes()
    exp_arr = np.frombuffer(exp, dtype=np.uint8)
    out = np.zeros(72, dtype=np.uint64)
    rc = fn(
        g1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        g1_inf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        g2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        g2_inf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        exp_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(exp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        return None
    coeffs = []
    for i in range(12):
        v = 0
        for j in reversed(range(6)):
            v = (v << 64) | int(out[i * 6 + j])
        coeffs.append(v)
    return coeffs


def backend() -> str:
    """'native' when the C++ pairing library loads, else 'python' (the
    pairing's own silent fallback, kept from zktpu)."""
    return "native" if _load() is not None else "python"
