"""Build and load the CUDA kernels of ``zktpu_torch/csrc/``.

The sources are compiled on first use with ``nvcc`` (one process per source,
in parallel) and linked into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so the build takes seconds).  The library lands in ``build/zktpu_torch/`` at the
root of the checkout, named by a hash of the sources and flags, so a changed
source is rebuilt.  There is no fallback: without a CUDA device or ``nvcc``
the loader raises and names what is missing.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from .fields.host import FieldSpec

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "zktpu_torch")
SOURCES = ("mont_mul.cu", "g1.cu", "ntt.cu", "field_ops.cu", "sha256.cu", "mont_mma.cu")
HEADERS = ("field.cuh", "g1.cuh", "ntt.cuh", "field_ops.cuh", "sha256.cuh", "mont_mma.cuh")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    # device, limbs, p (host), pinv, a, na, b, nb, out, n, stream
    "zk_mont_mul": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P, _I64, _P, _I64, _P, _I64, _P],
    # device, p (host), pinv, planes (host: 9, 8 or 6 x (pointer, outer stride,
    # inner stride), inputs then x3, y3, z3), n, inner, stream
    "zk_proj_add": [ctypes.c_int, _P, ctypes.c_uint32, _P, _I64, _I64, _P],
    "zk_proj_double": [ctypes.c_int, _P, ctypes.c_uint32, _P, _I64, _I64, _P],
    "zk_proj_madd": [ctypes.c_int, _P, ctypes.c_uint32, _P, _I64, _I64, _P],
    # kind (0 add, 1 mixed add, 2 double, 3 Horner combine), out {registers,
    # local bytes, shared bytes}
    "zk_g1_kernel_attrs": [ctypes.c_int, _P],
    # device, p (host), pinv, ptrs (host: X, Y, Z parts, X, Y, Z out), W, K, c, stream
    "zk_horner_combine": [ctypes.c_int, _P, ctypes.c_uint32, _P, _I64, _I64, _I64, _P],
    # device, limbs, p (host), pinv, in, out, batch, log_n, twiddles, in factor,
    # its row stride, out factor, its row stride, stream, out: launches
    "zk_ntt": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P, _P, _I64, ctypes.c_int, _P, _P, _I64, _P, _I64,
               _P, _P],
    # limbs, out {registers, local bytes, shared bytes of the largest tile}
    "zk_ntt_attrs": [ctypes.c_int, _P],
    # device, limbs, p (host), pinv, a, b, out, n, chain, stream
    "zk_mont_mul_chain": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P, _P, _P, _I64, ctypes.c_int, _P],
    # device, limbs, p (host), pinv, f32 (0 mxu, 1 f32), pinv matrix, p matrix, a, b, out, n, chain, stream
    "zk_mont_mma_chain": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, ctypes.c_int, _P, _P, _P, _P, _P, _I64,
                          ctypes.c_int, _P],
    # limbs, f32, out {registers, local bytes, shared bytes}
    "zk_mont_mma_attrs": [ctypes.c_int, ctypes.c_int, _P],
    # device, limbs, p (host), pinv, identity (host), op, mode, in, its row and
    # column strides, n, B, chunk, dirs, out_fwd, out_rev, their row and column
    # strides, totals, carry, stream
    "zk_field_scan": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P, ctypes.c_int, ctypes.c_int, _P, _I64, _I64,
                      _I64, _I64, _I64, ctypes.c_int, _P, _P, _I64, _I64, _P, _P, _P],
    "zk_field_scan_threads": [],
    # device, limbs, p (host), pinv, one (host), z^(2^j) table (host), out, count, chunk, stream
    "zk_field_powers": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P, _P, _P, _I64, _I64, _P],
    # device, limbs, p (host), pinv, one (host), inverse total (host), prefix, suffix, out, n, stream
    "zk_field_batch_inv": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P, _P, _P, _P, _P, _I64, _P],
    # device, limbs, p (host), pinv, op (0 add, 1 sub), a, na, b, nb, out, n, stream
    "zk_field_addsub": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, ctypes.c_int, _P, _I64, _P, _I64, _P, _I64,
                        _P],
    # kind (0 kernel A, 1 kernel B), out {registers, local bytes, shared bytes}
    "zk_field_ops_attrs": [ctypes.c_int, _P],
    # device, in, out, n_in, pairs (0 or 1), stream, out: launches
    "zk_sha256_field": [ctypes.c_int, _P, _P, _I64, ctypes.c_int, _P, _P],
    # out {registers, local bytes, shared bytes}
    "zk_sha256_attrs": [_P],
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels cannot be built or loaded here."""


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), DEFAULT_CUDA_HOME):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    return None


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libzktpu_kernels-{_source_hash()}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels (if the hashed library is missing); returns its path.

    verbose: also print ptxas's register and spill counts to stderr."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "zktpu_torch kernels need nvcc (not on PATH, not in $CUDA_HOME/bin or "
            "/usr/local/cuda/bin); they cannot be built on this machine"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    ptxas = ["-Xptxas", "-v"] if verbose else []
    # one nvcc per source, all started together, then one link
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, os.path.join(CSRC_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    try:
        errs = [p.communicate()[1] for p in procs]
        for p, err in zip(procs, errs):
            rc = p.returncode
            if rc != 0:
                raise KernelBuildError(f"nvcc failed ({rc}):\n{err}")
            if verbose:
                print(err, end="", file=sys.stderr)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    if not torch.cuda.is_available():
        raise KernelBuildError("zktpu_torch kernels need a CUDA device; none is available")
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def field_consts(spec: FieldSpec) -> tuple[np.ndarray, int]:
    """(p as little-endian u32 limbs, -p^{-1} mod 2^32) for a kernel launch."""
    L = spec.num_digits // 2
    p = np.frombuffer(spec.modulus.to_bytes(4 * L, "little"), dtype="<u4").copy()
    return p, (-pow(spec.modulus, -1, 1 << 32)) % (1 << 32)


def check(rc: int, name: str) -> None:
    """Raise on a non-zero status from a launch (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_operands(name: str, tensors, limbs: int, contiguous: bool = True) -> None:
    """Device, dtype, width and (unless the kernel takes strides) contiguity
    checks before pointers are passed."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA device, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected torch.int32 limbs, got {t.dtype}")
        if t.shape[-1] != limbs:
            raise ValueError(f"{name}: expected {limbs} limbs in the last dim, got {tuple(t.shape)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
