"""Build and load the CUDA kernels of ``zktpu_torch/csrc/``.

The sources are compiled on first use with ``nvcc`` (one process per source,
in parallel) and linked into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so the build takes seconds).  The library lands in ``build/zktpu_torch/`` at the
root of the checkout, named by a hash of the sources and flags, so a changed
source is rebuilt.  There is no fallback: without a CUDA device or ``nvcc``
the loader raises and names what is missing.
"""
from __future__ import annotations

import contextlib
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
SOURCES = ("mont_mul.cu", "g1.cu", "ntt.cu", "field_ops.cu", "sha256.cu", "mont_mma.cu", "fri_fold.cu", "matvec.cu",
           "lincomb.cu")
HEADERS = ("field.cuh", "g1.cuh", "ntt.cuh", "ntt_gl.cuh", "field_ops.cuh", "sha256.cuh", "mont_mma.cuh",
           "fri_fold.cuh", "matvec.cuh", "lincomb.cuh")
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
    # kind (0 add, 1 mixed add, 2 double, 3 Horner combine, 4 fixed-base
    # multiply), out {registers, local bytes, shared bytes}
    "zk_g1_kernel_attrs": [ctypes.c_int, _P],
    # device, p (host), pinv, ptrs (host: X, Y table, scalars, X, Y, Z out), n, window, stream
    "zk_fixed_base_mul": [ctypes.c_int, _P, ctypes.c_uint32, _P, _I64, ctypes.c_int, _P],
    # out {threads a block, minimum blocks a SM}
    "zk_fixed_base_design": [_P],
    # device, p (host), pinv, ptrs (host: X, Y, Z parts, X, Y, Z out), W, K, c, stream
    "zk_horner_combine": [ctypes.c_int, _P, ctypes.c_uint32, _P, _I64, _I64, _I64, _P],
    # device, p (host), pinv, ptrs (host: a, b, out), chain, stream
    "zk_horner_mul_chain": [ctypes.c_int, _P, ctypes.c_uint32, _P, _I64, _P],
    # out {lanes a product, products at once}
    "zk_horner_design": [_P],
    # device, limbs, p (host), pinv, in, out, batch, log_n, twiddles, in factor,
    # its row stride, out factor, its row stride, stream, out: launches
    "zk_ntt": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P, _P, _I64, ctypes.c_int, _P, _P, _I64, _P, _I64,
               _P, _P],
    # limbs, Fr's log2 radix, out {registers, local bytes, shared bytes of the largest tile}
    "zk_ntt_attrs": [ctypes.c_int, ctypes.c_int, _P],
    # log_n, out: {s0, ns, cols, threads, shared bytes, radix steps} per Goldilocks pass
    "zk_ntt_gl_plan": [ctypes.c_int, _P],
    # log_n, batch, out: the same and the log2 radix per Fr pass
    "zk_ntt_fr_plan": [ctypes.c_int, _I64, _P],
    # out {log2 radix-2 work, log2 tile, log2 columns, one-pass log n, minimum blocks per SM, log2 fewest threads}
    "zk_ntt_fr_design": [_P],
    # device, limbs, p (host), pinv, a, b, out, n, chain, stream
    "zk_mont_mul_chain": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P, _P, _P, _I64, ctypes.c_int, _P],
    # device, limbs, p (host), pinv, f32 (0 mxu, 1 f32), pinv matrix, p matrix, a, b, out, n, chain, stream
    "zk_mont_mma_chain": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, ctypes.c_int, _P, _P, _P, _P, _P, _I64,
                          ctypes.c_int, _P],
    # limbs, f32, out {registers, local bytes, shared bytes}
    "zk_mont_mma_attrs": [ctypes.c_int, ctypes.c_int, _P],
    # limbs, f32, out {tiles in flight, m p parts, minimum blocks}
    "zk_mont_mma_design": [ctypes.c_int, ctypes.c_int, _P],
    # device, limbs, p (host), pinv, identity (host), op, mode, in, its row and
    # column strides, n, B, chunk, dirs, out_fwd, out_rev, their row and column
    # strides, total, status buffer, its slots, ticket base, epoch, stream
    "zk_field_scan": [ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P, ctypes.c_int, ctypes.c_int, _P, _I64, _I64,
                      _I64, _I64, _I64, ctypes.c_int, _P, _P, _I64, _I64, _P, _P, _I64, ctypes.c_uint64,
                      ctypes.c_uint32, _P],
    "zk_field_scan_threads": [],
    # slots, out: the words of a status buffer of that many slots
    "zk_field_scan_status_words": [_I64, _P],
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
    # device, coefficients, n, r's low and high words (Montgomery), out, stream
    "zk_fri_fold": [ctypes.c_int, _P, _I64, ctypes.c_uint32, ctypes.c_uint32, _P, _P],
    # out {registers, local bytes, shared bytes}
    "zk_fri_fold_attrs": [_P],
    # device, p (host), pinv, 2^32 R mod p (host), A, z, out, m, n, stream
    "zk_matvec": [ctypes.c_int, _P, ctypes.c_uint32, _P, _P, _P, _P, _I64, _I64, _P],
    # out {registers, local bytes, shared bytes, rows a block, threads a block}
    "zk_matvec_attrs": [_P],
    # device, p (host), pinv, 2^32 R mod p (host), terms (host: 5 int64 each: a, its rows, b or 0, its rows,
    # negate), their count, out, n, stream
    "zk_lincomb": [ctypes.c_int, _P, ctypes.c_uint32, _P, _P, ctypes.c_int, _P, _I64, _P],
    # out {registers, local bytes, shared bytes, threads a block}
    "zk_lincomb_attrs": [_P],
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


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libzktpu_kernels-{source_hash()}.so")


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


def build_variants(source: str, variants: dict) -> dict:
    """{key: path} of csrc/`source` built alone into a shared library once for
    each {key: extra nvcc flags (-D designs)} of `variants`, every nvcc
    started at once, each library named by a hash of the sources, the
    headers and its flags (so rebuilt only when they change).  For the tools
    that time a kernel's designs side by side; the port loads only build()'s
    library."""
    stem, base = os.path.splitext(source)[0], source_hash()
    paths = {k: os.path.join(BUILD_DIR, "lib{}_{}.so".format(
        stem, hashlib.sha256(" ".join((base, *flags)).encode()).hexdigest()[:16])) for k, flags in variants.items()}
    todo = {k: path for k, path in paths.items() if not os.path.exists(path)}
    if not todo:
        return paths
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(f"building designs of {source} needs nvcc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {k: subprocess.Popen([nvcc, *NVCC_FLAGS, *variants[k], "-shared", "-o", f"{path}.{os.getpid()}.tmp",
                                  os.path.join(CSRC_DIR, source)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
             for k, path in todo.items()}
    for k, p in procs.items():
        err = p.communicate()[1]
        if p.returncode != 0:
            raise KernelBuildError(f"nvcc for {source} with {' '.join(variants[k])} failed ({p.returncode}):\n{err}")
        os.replace(f"{todo[k]}.{os.getpid()}.tmp", todo[k])
    return paths


def load_variant(path: str) -> ctypes.CDLL:
    """A library of build_variants, its entry points' signatures set (those it has)."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def launching(lib: ctypes.CDLL | None):
    """Inside this block the port's wrappers launch the kernels of `lib` (a
    load_variant library; None: the port's own)."""
    global load
    if lib is None:
        yield
        return
    saved = load
    load = lambda: lib  # noqa: E731
    try:
        yield
    finally:
        load = saved


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


_CONSTS: dict = {}  # field name -> (p's limbs, kept alive here, (their address, -p^{-1} mod 2^32))


def field_consts(spec: FieldSpec) -> tuple[int, int]:
    """(the host address of p as little-endian u32 limbs, -p^{-1} mod 2^32)
    for a kernel launch: one pair per field, made on first use."""
    hit = _CONSTS.get(spec.name)
    if hit is None:
        L = spec.num_digits // 2
        p = np.frombuffer(spec.modulus.to_bytes(4 * L, "little"), dtype="<u4").copy()
        hit = _CONSTS[spec.name] = (p, (p.ctypes.data, (-pow(spec.modulus, -1, 1 << 32)) % (1 << 32)))
    return hit[1]


def broadcast_shapes(*shapes) -> tuple:
    """torch.broadcast_shapes on plain tuples of ints: the same result, and
    the same error (RuntimeError, or ValueError for a negative length) where
    it raises, without its Python reference path."""
    out: list = []
    for shape in shapes:
        shape = tuple(shape)
        if any(s < 0 for s in shape):
            raise ValueError("Attempting to broadcast a dimension with negative length!")
        if len(shape) > len(out):
            out[:0] = [1] * (len(shape) - len(out))
        for i in range(1, len(shape) + 1):
            s, o = shape[-i], out[-i]
            if s != o:
                if o == 1:
                    out[-i] = s
                elif s != 1:
                    raise RuntimeError(f"Attempting to broadcast a dimension of length {s} at {-i}! Mismatching "
                                       f"shape {shape}; expected a shape broadcastable to {out}")
    return tuple(out)


def check(rc: int, name: str) -> None:
    """Raise on a non-zero status from a launch (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the address the kernels take."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


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
