"""The CUDA kernels' own arithmetic on the CPU, against the plain versions.

csrc/field.cuh, csrc/g1.cuh, csrc/ntt.cuh and csrc/mont_mma.cuh compile as
host C++ (tests/g1_host.cpp, tests/ntt_host.cpp, tests/mont_mma_host.cpp):
the PTX carry chains of the
Montgomery product are emulated one instruction for one, the per-point code
of the add, mixed add and double runs as each CUDA thread runs it, strided
planes and all, the Horner combine runs its lane schedule phase by phase,
the NTT runs each pass block by block and each block's phases thread by
thread, and the tensor-core chain runs a warp as 32 threads with its u8
mma.sync fragments emulated by the PTX ISA's layout tables.  So the carry chains, the lazy reduction bounds, the plane
addressing, the lane exchange and the NTT's pass and tile index math are
held word for word against the plain PyTorch versions here, though only the
card can run the kernels.  Inputs are arbitrary field elements (the
formulas are field arithmetic and need no curve points), with the extreme
values 0, 1 and p - 1.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from zktpu_torch import cuda_lib
from zktpu_torch.curves import g1_kernel
from zktpu_torch.curves.g1_kernel import horner_combine_plain, proj_add_plain, proj_double_plain, proj_madd_plain
from zktpu_torch.fields import field_kernel
from zktpu_torch.fields.fp import field, ints_to_limbs
from zktpu_torch.fields.host import FQ, FR, GOLDILOCKS
from zktpu_torch.fields.mont_kernel import mont_mul_chain_plain, mont_mul_plain
from zktpu_torch.fields.mont_mats import kernel_mats
from zktpu_torch.poly import ntt_kernel
from zktpu_torch.poly.domain import get_domain

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

HERE = os.path.dirname(os.path.abspath(__file__))
SHIM = os.path.join(HERE, "g1_host.cpp")
NTT_SHIM = os.path.join(HERE, "ntt_host.cpp")
FQT = field(FQ, "cpu")


def _build(shim: str, name: str, flags=()) -> ctypes.CDLL:
    """The host build of `shim` with extra g++ `flags`, cached by content."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host copy of the kernels' code")
    h = hashlib.sha256(" ".join(flags).encode())
    for path in (shim, *(os.path.join(cuda_lib.CSRC_DIR, n) for n in cuda_lib.HEADERS)):
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(cuda_lib.BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", *flags, "-o", tmp,
                        shim], check=True, capture_output=True)
        os.replace(tmp, out)
    return ctypes.CDLL(out)


@pytest.fixture(scope="module")
def lib():
    so = _build(SHIM, "g1_host")
    P = ctypes.c_void_p
    for name in ("host_proj_add", "host_proj_madd", "host_proj_double"):
        getattr(so, name).argtypes = [P, ctypes.c_uint32, P, ctypes.c_int64, ctypes.c_int64]
    so.host_mont_mul.argtypes = [ctypes.c_int, P, ctypes.c_uint32, P, P, P, ctypes.c_int64, ctypes.c_int]
    so.host_horner_combine.argtypes = [P, ctypes.c_uint32, P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    return so


def _elements(rng, spec, n):
    p = spec.modulus
    vals = [0, 1, p - 1, p - 2] + [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n - 4)]
    return [vals[i] for i in rng.permutation(n)]


def _host_op(lib, name, ins, shape):
    """Run the host copy of a kernel over batch `shape`, strided as the CUDA wrapper passes it."""
    full = tuple(shape) + (12,)
    out = tuple(torch.zeros(full, dtype=torch.int32) for _ in range(3))
    descs = [g1_kernel._plane(t, shape) for t in (*ins, *out)]
    assert all(d is not None for d in descs)
    planes = np.array(descs, dtype=np.int64)
    p, pinv = cuda_lib.field_consts(FQ)
    n = int(np.prod(shape))
    getattr(lib, f"host_{name}")(p.ctypes.data, pinv, planes.ctypes.data, n, shape[-1])
    return out


@pytest.mark.parametrize("spec", [FQ, FR, GOLDILOCKS], ids=lambda s: s.name)
def test_host_mont_mul_matches_plain(lib, spec):
    rng = np.random.default_rng(7)
    f = field(spec, "cpu")
    L = spec.num_digits // 2
    a, b = (f.encode_ints(_elements(rng, spec, 64)) for _ in range(2))
    out = torch.zeros_like(a)
    p, pinv = cuda_lib.field_consts(spec)
    lib.host_mont_mul(L, p.ctypes.data, pinv, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], 0)
    assert torch.equal(out, mont_mul_plain(spec, a, b))


def test_host_lazy_product_bound(lib):
    """The lazy product takes a < 4p, b < 2p and gives a value < 2p congruent to a b R^-1."""
    rng = np.random.default_rng(8)
    p, R = FQ.modulus, 1 << 384
    a = [4 * p - 1, 4 * p - 1, 0, 3 * p] + [int.from_bytes(rng.bytes(48), "little") % (4 * p) for _ in range(60)]
    b = [2 * p - 1, 0, 2 * p - 1, p] + [int.from_bytes(rng.bytes(48), "little") % (2 * p) for _ in range(60)]
    A, B = (torch.from_numpy(ints_to_limbs(v, 12)) for v in (a, b))
    out = torch.zeros_like(A)
    pl, pinv = cuda_lib.field_consts(FQ)
    lib.host_mont_mul(12, pl.ctypes.data, pinv, A.data_ptr(), B.data_ptr(), out.data_ptr(), len(a), 1)
    got = [int.from_bytes(r.astype("<u4").tobytes(), "little") for r in out.numpy()]
    rinv = pow(R, -1, p)
    assert all(g < 2 * p and g % p == x * y * rinv % p for g, x, y in zip(got, a, b))


def _planes_with_edges(rng, n, extra=5):
    """Three (3, n + extra, 12) coordinate planes of arbitrary elements with
    0, 1 and p - 1 among them, and zero rows."""
    planes = [FQT.encode_ints(_elements(rng, FQ, 3 * (n + extra))).reshape(3, n + extra, 12) for _ in range(3)]
    for t in planes:
        t[:, 0] = 0  # all-zero rows (padding)
    return planes


def test_host_proj_add_strided_matches_plain(lib):
    rng = np.random.default_rng(9)
    n = 37
    X, Y, Z = _planes_with_edges(rng, n)
    P1 = tuple(t[:, : n] for t in (X, Y, Z))  # strided slices of one plane, as the doubling scan passes them
    P2 = tuple(t[:, 5:] for t in (X, Y, Z))
    got = _host_op(lib, "proj_add", (*P1, *P2), (3, n))
    for g, w in zip(got, proj_add_plain(P1, P2)):
        assert torch.equal(g, w)
    Q = tuple(t[1, 3] for t in (X, Y, Z))  # one point broadcast against the batch
    got = _host_op(lib, "proj_add", (*P1, *Q), (3, n))
    for g, w in zip(got, proj_add_plain(P1, Q)):
        assert torch.equal(g, w)


def test_host_proj_madd_strided_matches_plain(lib):
    rng = np.random.default_rng(10)
    n = 37
    X, Y, Z = _planes_with_edges(rng, n)
    P1 = tuple(t[:, 5:] for t in (X, Y, Z))
    A2 = (X[:, : n].clone(), Y[:, : n].clone())
    A2[0][:, 7] = 0  # (0, 0): the affine identity gives P1 back
    A2[1][:, 7] = 0
    got = _host_op(lib, "proj_madd", (*P1, *A2), (3, n))
    for g, w in zip(got, proj_madd_plain(P1, A2)):
        assert torch.equal(g, w)
    assert all(torch.equal(g[:, 7], p[:, 7]) for g, p in zip(got, P1))


def test_host_proj_double_matches_plain(lib):
    rng = np.random.default_rng(11)
    X, Y, Z = _planes_with_edges(rng, 20)
    P = tuple(t[:, 2:] for t in (X, Y, Z))
    got = _host_op(lib, "proj_double", P, (3, 23))
    for g, w in zip(got, proj_double_plain(P)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("W,K,c", [(3, 3, 4), (2, 9, 2), (1, 2, 5)])
def test_host_horner_combine_matches_plain(lib, W, K, c):
    """The lane schedule (four lanes per point, eight points per warp) on
    arbitrary elements: a group past the last point (K = 3), two blocks
    (K = 9), no doubling at all (W = 1), and all-zero rows."""
    rng = np.random.default_rng(12 + K)
    parts = [FQT.encode_ints(_elements(rng, FQ, W * K)).reshape(W, K, 12) for _ in range(3)]
    for t in parts:
        t[0, 0] = 0
    out = tuple(torch.zeros((K, 12), dtype=torch.int32) for _ in range(3))
    ptrs = np.array([t.data_ptr() for t in (*parts, *out)], dtype=np.int64)
    p, pinv = cuda_lib.field_consts(FQ)
    lib.host_horner_combine(p.ctypes.data, pinv, ptrs.ctypes.data, W, K, c)
    for g, w in zip(out, horner_combine_plain(parts, c)):
        assert torch.equal(g, w)


# Small tiles: 2^4 elements, at least 2 columns, 4 threads a block (both
# fields), so 2^7-2^9 take 2-3 passes; and the library's own tiles (2^12
# takes 2 passes in either field).
SMALL_TILES = ("-DZK_NTT_LOG_TILE=4", "-DZK_NTT_LOG_MIN_COLS=1", "-DZK_NTT_LOG_TILE_L2=4",
               "-DZK_NTT_LOG_MIN_COLS_L2=1", "-DZK_NTT_THREADS=4")


@pytest.fixture(scope="module")
def ntt_lib(request):
    so = _build(NTT_SHIM, "ntt_host", request.param)
    P = ctypes.c_void_p
    so.host_ntt.argtypes = [ctypes.c_int, P, ctypes.c_uint32, P, P, ctypes.c_int64, ctypes.c_int, P, P,
                            ctypes.c_int64, P, ctypes.c_int64]
    so.host_ntt.restype = ctypes.c_int
    return request.param, so


def _host_ntt(so, x, table, in_factor, out_factor, spec=FR):
    n, L = x.shape[-2], spec.num_digits // 2
    out = torch.zeros_like(x)
    args, keep = [], []  # keep: the factor rows, alive until the call returns
    for t in (in_factor, out_factor):
        rows = None if t is None else t.reshape(-1, L).contiguous()
        keep.append(rows)
        args += [0 if rows is None else rows.data_ptr(), int(rows is not None and rows.shape[0] == n and n > 1)]
    p, pinv = cuda_lib.field_consts(spec)
    passes = so.host_ntt(L, p.ctypes.data, pinv, x.data_ptr(), out.data_ptr(), x.shape[0], n.bit_length() - 1,
                         table.data_ptr(), *args)
    return out, passes


@pytest.mark.parametrize("ntt_lib,log_n", [(SMALL_TILES, k) for k in (1, 5, 7, 8, 9)] + [((), 5), ((), 12)],
                         indirect=["ntt_lib"], ids=lambda v: ("small_tiles" if v else "library_tiles")
                         if isinstance(v, tuple) else f"2^{v}")
def test_host_ntt_matches_plain(ntt_lib, log_n):
    """fft, ifft, coset_fft and coset_ifft over a batch of 2 rows (0, 1 and
    p - 1 among them), with the factors as the domain passes them."""
    flags, so = ntt_lib
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    f = field(FR, "cpu")
    x = f.encode_ints(_elements(rng, FR, 2 * n) if n > 2 else [0, 1, FR.modulus - 1, 5]).reshape(2, n, 8)
    dom = get_domain(FR, n, device="cpu")
    g = FR.generator
    n_inv = ntt_kernel._n_inv(FR, n, x.device)
    for inverse, fin, fout in ((False, None, None), (True, None, n_inv), (False, dom.offset_powers(g), None),
                               (True, None, dom._coset_out(g))):
        table = dom._inv_tw if inverse else dom._fwd_tw
        got, passes = _host_ntt(so, x, table, fin, fout)
        assert torch.equal(got, ntt_kernel.ntt_plain(x, table, inverse, fin, fout)), (inverse, fin is not None)
    if flags and log_n >= 7:
        assert passes >= 2
    if not flags:
        assert passes == (2 if log_n == 12 else 1)


@pytest.mark.parametrize("ntt_lib,log_n", [(SMALL_TILES, k) for k in (1, 2, 7, 9)] + [((), 8), ((), 12)],
                         indirect=["ntt_lib"], ids=lambda v: ("small_tiles" if v else "library_tiles")
                         if isinstance(v, tuple) else f"2^{v}")
def test_host_ntt_goldilocks_matches_plain(ntt_lib, log_n):
    """The L = 2 instance (fmul_wide's products) for FRI's coset transforms:
    fft, ifft, coset_fft and coset_ifft over a batch of 2 rows, one of them
    all zero and one holding p - 1, down to n = 2 and 4."""
    flags, so = ntt_lib
    n = 1 << log_n
    rng = np.random.default_rng(100 + log_n)
    f = field(GOLDILOCKS, "cpu")
    p = GOLDILOCKS.modulus
    vals = [int(v) for v in rng.integers(0, p, size=2 * n, dtype=np.uint64)]
    vals[:n] = [0] * n
    vals[n] = p - 1
    x = f.encode_ints(vals).reshape(2, n, 2)
    dom = get_domain(GOLDILOCKS, n, device="cpu")
    g = GOLDILOCKS.generator
    n_inv = ntt_kernel._n_inv(GOLDILOCKS, n, x.device)
    for inverse, fin, fout in ((False, None, None), (True, None, n_inv), (False, dom.offset_powers(g), None),
                               (True, None, dom._coset_out(g))):
        table = dom._inv_tw if inverse else dom._fwd_tw
        got, passes = _host_ntt(so, x, table, fin, fout, GOLDILOCKS)
        want = ntt_kernel.ntt_plain(x, table, inverse, fin, fout, GOLDILOCKS)
        assert torch.equal(got, want), (inverse, fin is not None)
    if flags and log_n >= 7:
        assert passes >= 2
    if not flags:
        assert passes == (2 if log_n == 12 else 1)


# Kernels A and B (csrc/field_ops.cuh) through the port's own wrappers: the
# host build takes the library's arguments, so field_kernel's pass logic runs
# unchanged.  Two warps a block and small sizes make small inputs take
# several tiles and the three-pass scan; the library's 256 threads once.
SCAN_SHIM = os.path.join(HERE, "scan_host.cpp")
SCAN_DESIGNS = {
    "two_warps_multi_pass": (("-DZK_SCAN_THREADS=64",), {"SCAN_CHUNK": 2, "ONE_BLOCK_MAX_MUL": 96,
                                                          "ONE_BLOCK_MAX_ADD": 64, "POWERS_CHUNK": 3}),
    "library_threads": ((), {}),
}


@pytest.fixture(scope="module", params=sorted(SCAN_DESIGNS))
def scan_lib(request):
    flags, sizes = SCAN_DESIGNS[request.param]
    so = _build(SCAN_SHIM, "scan_host", flags)
    for name in ("zk_field_scan", "zk_field_scan_threads", "zk_field_powers", "zk_field_batch_inv",
                 "zk_field_addsub"):
        fn = getattr(so, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    saved = {k: getattr(field_kernel, k) for k in sizes}
    for k, v in sizes.items():
        setattr(field_kernel, k, v)
    yield request.param, so
    for k, v in saved.items():
        setattr(field_kernel, k, v)


def _field_rows(spec, n, seed, nonzero=False):
    rng = np.random.default_rng(seed)
    vals = _elements(rng, spec, max(n, 4))[:n]
    if nonzero:
        vals = [v or 1 for v in vals]
    return field(spec, "cpu").encode_ints(vals)


@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
@pytest.mark.parametrize("op", [field_kernel.OP_MUL, field_kernel.OP_ADD], ids=["cumprod", "cumsum"])
def test_host_field_scan_matches_plain(scan_lib, spec, op):
    """Forward and reverse scans of n = 1, 2, 3, 17, 64 and 300 rows (one
    block up to one 128-row tile or the one-block limit, and three passes
    over several tiles), one column and three
    columns, along axis 0 and along the middle axis of (3, n, L)."""
    design, so = scan_lib
    f = field(spec, "cpu")
    for n in (1, 2, 3, 17, 64, 300):
        x = _field_rows(spec, 3 * n, n).reshape(n, 3, -1)
        for a, axis in ((x[:, 0], 0), (x, 0), (x.permute(1, 0, 2).contiguous(), 1)):
            for reverse in (False, True):
                got, k = field_kernel.scan_kernel(so, f, a, op, axis, reverse)
                assert torch.equal(got, field_kernel.scan_plain(f, a, op, axis, reverse)), (n, axis, reverse)
                if design == "two_warps_multi_pass":
                    assert k == (1 if n <= (96 if op == field_kernel.OP_MUL else 128) else 3)


@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
def test_host_field_sum_powers_batch_inv_match_plain(scan_lib, spec):
    """The sum on axis 0 and 1 (one and two passes), powers (several rows a
    thread, a count that is not a multiple of them), batch_inv (the forward
    and the reverse scan in the same passes, the shifted reads at both ends)."""
    design, so = scan_lib
    f = field(spec, "cpu")
    for n in (1, 3, 64, 200):
        x = _field_rows(spec, 4 * n, 100 + n).reshape(4, n, -1)
        for axis in (0, 1):
            got, k = field_kernel.sum_kernel(so, f, x, axis)
            assert torch.equal(got, field_kernel.sum_plain(f, x, axis)), (n, axis)
        got, k = field_kernel.sum_kernel(so, f, x[0], 0)
        assert torch.equal(got, field_kernel.sum_plain(f, x[0], 0))
        if design == "two_warps_multi_pass":
            assert k == (1 if n <= 128 else 2)
    for count in (1, 2, 3, 17, 300):
        for z in (0, 1, 5, spec.modulus - 1):
            got, k = field_kernel.powers_kernel(so, f, z, count)
            assert k == 1 and torch.equal(got, field_kernel.powers_plain(f, z, count)), (count, z)
    for n in (1, 2, 17, 300):
        a = _field_rows(spec, n, 200 + n, nonzero=True)
        got, k = field_kernel.batch_inv_kernel(so, f, a, spec.inv)
        assert torch.equal(got, field_kernel.batch_inv_plain(f, a, spec.inv)), n
        if design == "two_warps_multi_pass":
            assert k == (2 if n <= 96 else 4)
    a = _field_rows(spec, 2 * 17, 7, nonzero=True).reshape(2, 17, -1)
    assert torch.equal(field_kernel.batch_inv_kernel(so, f, a, spec.inv)[0],
                       field_kernel.batch_inv_plain(f, a, spec.inv))


@pytest.mark.parametrize("spec", [FR, FQ, GOLDILOCKS], ids=lambda s: s.name)
def test_host_field_addsub_matches_plain(scan_lib, spec):
    """add and sub with 0, 1 and p - 1 among the operands: equal shapes, an
    (m,) table and one constant broadcast against (K, m), a broadcast that is
    materialised, and neg as 0 - a with the zero row read by the modulo."""
    _, so = scan_lib
    f = field(spec, "cpu")
    A = _field_rows(spec, 15, 1).reshape(3, 5, -1)
    B = _field_rows(spec, 15, 2).reshape(3, 5, -1)
    for op, plain in ((0, field_kernel.add_plain), (1, field_kernel.sub_plain)):
        for a, b in ((A, B), (A, B[1]), (A, B[2, 3]), (B[0, 1], A), (A[:, :1], B), (A[:, 2:], B[:, 2:])):
            got, k = field_kernel.addsub_kernel(so, f, a, b, op)
            assert k == 1 and torch.equal(got, plain(f, a, b)), (op, a.shape, b.shape)
    got, _ = field_kernel.addsub_kernel(so, f, f.zero, A, 1)
    assert torch.equal(got, field_kernel.sub_plain(f, torch.zeros_like(A), A))


# The field hash (csrc/sha256.cuh): its per-thread code on the CPU, against
# the plain version and hashlib, at the digit-length boundaries.
SHA_SHIM = os.path.join(HERE, "sha256_host.cpp")


def _boundary_values():
    """0, 10^k - 1 and 10^k for every k (each digit length and its edges),
    2^32 - 1, 2^32, 2^63, p - 2, p - 1, and arbitrary values."""
    p = GOLDILOCKS.modulus
    vals = [0, 2**32 - 1, 2**32, 2**63, p - 2, p - 1]
    for k in range(1, 20):
        vals += [10**k - 1, 10**k]
    rng = np.random.default_rng(13)
    return vals + [int(v) for v in rng.integers(0, p, size=31, dtype=np.uint64)]


def test_host_sha256_field_matches_plain_and_hashlib():
    """Single and pair mode, and an odd count (a trailing singleton); every
    pair of boundary values once, so the 0x80 byte and the bit length land
    after every combined length from 2 to 40."""
    from zktpu_torch.hash import host_hash
    from zktpu_torch.hash.sha256_kernel import hash_field_plain

    so = _build(SHA_SHIM, "sha256_host")
    P = ctypes.c_void_p
    so.host_sha256_field.argtypes = [P, P, ctypes.c_int64, ctypes.c_int]
    so.host_sha256_field.restype = None
    vals = _boundary_values()
    edges = vals[:44]
    pairs = [v for a in edges[::3] for b in edges[1::3] for v in (a, b)]  # every length of a with every length of b
    for data, mode in ((vals, 0), (pairs, 1), (vals[:-1], 1)):
        x = torch.from_numpy(ints_to_limbs(data, 2))
        n_out = (len(data) + 1) // 2 if mode else len(data)
        out = torch.zeros((n_out, 2), dtype=torch.int32)
        so.host_sha256_field(x.data_ptr(), out.data_ptr(), len(data), mode)
        assert torch.equal(out, hash_field_plain(x, bool(mode))), mode
        got = out.numpy().view("<u8")[:, 0].tolist()
        if mode:
            want = [host_hash.hash_slice(GOLDILOCKS, data[i : i + 2]) for i in range(0, len(data), 2)]
        else:
            want = [host_hash.hash_elem(GOLDILOCKS, v) for v in data]
        assert got == want, mode


# Kernels 5m and 5f (csrc/mont_mma.cuh): a simulated warp, 32 threads with
# the m16n8k32 u8 fragments of the PTX ISA emulated, through the library's
# entry point over host memory.
MMA_SHIM = os.path.join(HERE, "mont_mma_host.cpp")


@pytest.mark.parametrize("variant", ["mxu", "f32"])
@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
def test_host_mont_mma_chain_matches_plain(spec, variant):
    """Three chained products over 35 elements (two warps, the second with
    three live lanes) with 0, 1 and p - 1 among them, against the plain
    chain."""
    so = _build(MMA_SHIM, "mont_mma_host", ("-pthread",))
    P = ctypes.c_void_p
    so.host_mont_mma_chain.argtypes = [ctypes.c_int, P, ctypes.c_uint32, ctypes.c_int, P, P, P, P, P,
                                       ctypes.c_int64, ctypes.c_int]
    so.host_mont_mma_chain.restype = ctypes.c_int
    rng = np.random.default_rng(21)
    f = field(spec, "cpu")
    a, b = (f.encode_ints(_elements(rng, spec, 35)) for _ in range(2))
    qmat, pmat = (np.ascontiguousarray(m).view(np.int32) for m in kernel_mats(spec))
    p, pinv = cuda_lib.field_consts(spec)
    out = torch.zeros_like(a)
    rc = so.host_mont_mma_chain(spec.num_digits // 2, p.ctypes.data, pinv, int(variant == "f32"), qmat.ctypes.data,
                                pmat.ctypes.data, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], 3)
    assert rc == 0
    assert torch.equal(out, mont_mul_chain_plain(spec, a, b, 3))
