"""The CUDA kernels' own arithmetic on the CPU, against the plain versions.

csrc/field.cuh, csrc/g1.cuh, csrc/ntt.cuh, csrc/matvec.cuh and
csrc/mont_mma.cuh compile as host C++ (tests/g1_host.cpp, tests/ntt_host.cpp,
tests/matvec_host.cpp, tests/mont_mma_host.cpp):
the PTX carry chains of the
Montgomery product are emulated one instruction for one, the per-point code
of the add, mixed add and double runs as each CUDA thread runs it, strided
planes and all, the Horner combine runs its lane schedule phase by phase,
the NTT runs each pass block by block and each block's phases thread by
thread, the matrix-vector product runs every block and thread with its warp
shuffles emulated, and the tensor-core chain runs a warpgroup as 128 threads
with its u8 wgmma operands emulated by the PTX ISA's layouts (shared-memory
descriptors, register fragments, accumulators).  So the carry chains, the lazy reduction bounds, the plane
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


def _build_path(shim: str, name: str, flags=()) -> str:
    """Where the host build of `shim` with g++ `flags` lives, named by content."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in (shim, os.path.join(HERE, "warp_host.h"), *(os.path.join(cuda_lib.CSRC_DIR, n) for n in cuda_lib.HEADERS)):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(cuda_lib.BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


class _build_start:
    """g++ started on the host build of `shim`; finish() waits and installs it."""

    def __init__(self, shim: str, name: str, flags=()):
        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("no g++ to build the host copy of the kernels' code")
        self.out = _build_path(shim, name, flags)
        os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
        self.tmp = f"{self.out}.{os.getpid()}.{id(self)}.tmp"
        self.proc = subprocess.Popen([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", *flags,
                                      "-o", self.tmp, shim], stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def finish(self) -> str:
        err = self.proc.communicate()[1]
        if self.proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({self.proc.returncode}):\n{err.decode()}")
        os.replace(self.tmp, self.out)
        return self.out


def _build(shim: str, name: str, flags=()) -> ctypes.CDLL:
    """The host build of `shim` with extra g++ `flags`, cached by content."""
    out = _build_path(shim, name, flags)
    if not os.path.exists(out):
        _build_start(shim, name, flags).finish()
    return ctypes.CDLL(out)


P_ = ctypes.c_void_p


# The fixed-base kernel's blocks of 64 threads here, not the library's 192,
# so that the tests' 128 and 130 scalars take two and three blocks.
FB_FLAGS = ("-DZK_FB_THREADS=64",)


@pytest.fixture(scope="module")
def lib():
    so = _build(SHIM, "g1_host", FB_FLAGS)
    P = ctypes.c_void_p
    for name in ("host_proj_add", "host_proj_madd", "host_proj_double"):
        getattr(so, name).argtypes = [P, ctypes.c_uint32, P, ctypes.c_int64, ctypes.c_int64]
    so.host_mont_mul.argtypes = [ctypes.c_int, P, ctypes.c_uint32, P, P, P, ctypes.c_int64, ctypes.c_int]
    so.host_horner_combine.argtypes = [P, ctypes.c_uint32, P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    so.host_horner_mul_chain.argtypes = [P, ctypes.c_uint32, P, ctypes.c_int64]
    so.host_fixed_base_mul.argtypes = [P, ctypes.c_uint32, P, ctypes.c_int64, ctypes.c_int]
    so.host_fixed_base_mul.restype = ctypes.c_int
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
    getattr(lib, f"host_{name}")(p, pinv, planes.ctypes.data, n, shape[-1])
    return out


@pytest.mark.parametrize("spec", [FQ, FR, GOLDILOCKS], ids=lambda s: s.name)
def test_host_mont_mul_matches_plain(lib, spec):
    rng = np.random.default_rng(7)
    f = field(spec, "cpu")
    L = spec.num_digits // 2
    a, b = (f.encode_ints(_elements(rng, spec, 64)) for _ in range(2))
    out = torch.zeros_like(a)
    p, pinv = cuda_lib.field_consts(spec)
    lib.host_mont_mul(L, p, pinv, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], 0)
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
    lib.host_mont_mul(12, pl, pinv, A.data_ptr(), B.data_ptr(), out.data_ptr(), len(a), 1)
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


# The Horner combine's designs (lanes a product, products at once) that
# tools/horner_lanes.py sweeps; None is the library's own (no -D flag).
HORNER_DESIGNS = (None, (1, 6), (2, 6), (4, 6), (6, 4))


def _horner_flags(design):
    return () if design is None else (f"-DZK_HORNER_P={design[0]}", f"-DZK_HORNER_G={design[1]}")


@pytest.fixture(scope="module")
def horner_libs(lib):
    """The host build of g1_host.cpp for each design, the builds run at once."""
    missing = [d for d in HORNER_DESIGNS[1:] if not os.path.exists(_build_path(SHIM, "g1_host", _horner_flags(d)))]
    procs = [_build_start(SHIM, "g1_host", _horner_flags(d)) for d in missing]
    for proc in procs:
        proc.finish()
    libs = {None: lib}
    for d in HORNER_DESIGNS[1:]:
        so = _build(SHIM, "g1_host", _horner_flags(d))
        so.host_horner_combine.argtypes = [P_, ctypes.c_uint32, P_, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        so.host_horner_mul_chain.argtypes = [P_, ctypes.c_uint32, P_, ctypes.c_int64]
        libs[d] = so
    return libs


def _design_id(design):
    return "library" if design is None else f"P{design[0]}G{design[1]}"


@pytest.mark.parametrize("design,W,K,c,fill", [
    pytest.param(None, 3, 3, 4, "random", id="3-3-4"), pytest.param(None, 2, 9, 2, "random", id="2-9-2"),
    pytest.param(None, 1, 2, 5, "random", id="1-2-5"), pytest.param(None, 3, 2, 3, "p-1", id="3-2-3-p-1")]
    + [pytest.param(d, 2, 2, 3, "random", id=f"{_design_id(d)}-2-2-3") for d in HORNER_DESIGNS[1:]])
def test_host_horner_combine_matches_plain(horner_libs, design, W, K, c, fill):
    """The warp schedule (one warp a point, lane-parallel products, values
    exchanged by emulated shuffles) against the plain loop, word for word,
    on arbitrary elements with all-zero rows: K points past one (K = 3, two
    groups of lanes that run along), K = 9, W = 1 (no doubling at all),
    parts that are all p - 1 (the largest canonical words, against the lazy
    bounds), and each design the sweep builds."""
    rng = np.random.default_rng(12 + K)
    if fill == "p-1":
        parts = [FQT.encode_ints([FQ.modulus - 1] * (W * K)).reshape(W, K, 12) for _ in range(3)]
    else:
        parts = [FQT.encode_ints(_elements(rng, FQ, W * K)).reshape(W, K, 12) for _ in range(3)]
        for t in parts:
            t[0, 0] = 0
    out = tuple(torch.zeros((K, 12), dtype=torch.int32) for _ in range(3))
    ptrs = np.array([t.data_ptr() for t in (*parts, *out)], dtype=np.int64)
    p, pinv = cuda_lib.field_consts(FQ)
    assert horner_libs[design].host_horner_combine(p, pinv, ptrs.ctypes.data, W, K, c) == 0
    for g, w in zip(out, horner_combine_plain(parts, c)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("design", HORNER_DESIGNS, ids=_design_id)
def test_host_horner_mul_chain_matches_plain(horner_libs, design):
    """The lane-parallel product alone, chained three times in one warp and
    gathered whole after each, against the plain chain: 0, 1, p - 1 and
    random factors."""
    rng = np.random.default_rng(30)
    pairs = [(0, 5), (1, FQ.modulus - 1), (FQ.modulus - 1, FQ.modulus - 1)] + [
        tuple(int.from_bytes(rng.bytes(48), "little") % FQ.modulus for _ in range(2)) for _ in range(3)]
    p, pinv = cuda_lib.field_consts(FQ)
    for x, y in pairs:
        a, b = FQT.encode_ints([x]), FQT.encode_ints([y])
        out = torch.zeros_like(a)
        ptrs = np.array([a.data_ptr(), b.data_ptr(), out.data_ptr()], dtype=np.int64)
        assert horner_libs[design].host_horner_mul_chain(p, pinv, ptrs.ctypes.data, 3) == 0
        assert torch.equal(out, mont_mul_chain_plain(FQ, a, b, 3)), (x, y)


def _host_fixed_base(lib, tables, sc, window):
    """The fixed-base kernel's block walk on the CPU (tests/g1_host.cpp)."""
    out = tuple(torch.zeros((sc.shape[0], 12), dtype=torch.int32) for _ in range(3))
    ptrs = np.array([t.data_ptr() for t in (*tables[:2], sc, *out)], dtype=np.int64)
    p, pinv = cuda_lib.field_consts(FQ)
    assert lib.host_fixed_base_mul(p, pinv, ptrs.ctypes.data, sc.shape[0], window) == 0
    return out


@pytest.mark.parametrize("window", [4, 8])
def test_host_fixed_base_mul_matches_plain(lib, window):
    """The fixed-base kernel's block walk (FB_FLAGS: 64 threads a block in
    step, each window's X and Y rows staged in a buffer laid out as its
    shared memory, the accumulators there too, Z2 put in by the digit) on
    G's table, against the plain loop word for word and, for a few scalars,
    against host curve arithmetic: 130 scalars (three blocks, the last with
    two), 0, 1, r - 1 and 2^256 - 1 (every digit the table's last), scalars
    with zero digits among random ones."""
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.host_curve import G1Affine

    rng = np.random.default_rng(20 + window)
    G = G1Affine.generator()
    edges = [0, 1, FR.modulus - 1, (1 << 256) - 1, 2**200 + 3, 0xDEADBEEF << 96]
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(124)]
    rand[::3] = [v & ~(0xFF << (8 * int(rng.integers(32)))) for v in rand[::3]]  # a digit of 0
    ints = edges + rand
    sc = g1.scalars_to_u32(ints, device="cpu")
    tables = g1.fixed_base_tables(G, window, torch.device("cpu"))
    out = _host_fixed_base(lib, tables, sc, window)
    for got, want in zip(out, g1_kernel.fixed_base_mul_plain(tables, sc, window)):
        assert torch.equal(got, want)
    assert g1.proj_to_affine_host(tuple(t[:6] for t in out)) == [G.mul(k) for k in ints[:6]]


def test_host_fixed_base_mul_matches_zktpu_golden(lib):
    """The block walk at window 8 (two blocks of 64 threads) against zktpu's
    own words for [k] G, k = 2 .. 129 (tests/goldens/dist.npz, points/X|Y|Z):
    nearly every digit of these scalars is 0, so nearly every add is of O,
    with Z2 = 0."""
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.host_curve import G1Affine

    golden = np.load(os.path.join(HERE, "goldens", "dist.npz"))
    sc = g1.scalars_to_u32(range(2, 130), device="cpu")
    out = _host_fixed_base(lib, g1.fixed_base_tables(G1Affine.generator(), 8, torch.device("cpu")), sc, 8)
    for got, k in zip(out, "XYZ"):
        np.testing.assert_array_equal(got.numpy(), golden[f"points/{k}"])


def test_host_mixed_add_and_identity_add_match_complete_add(lib):
    """The identities of the fixed-base table, word for word on arbitrary
    field elements with 0, 1 and p - 1 among them: the mixed add of (x2, y2)
    equals the complete add of (x2, y2, 1) (the table's rows past 0, which
    the kernel adds with Z2 = 1), and the complete add of O = (0 : 1 : 0)
    (row 0, Z2 = 0) equals (X Y, Y^2, Y Z)."""
    rng = np.random.default_rng(19)
    n = 37
    P1 = tuple(FQT.encode_ints(_elements(rng, FQ, n)) for _ in range(3))
    A2 = tuple(FQT.encode_ints(_elements(rng, FQ, n)) for _ in range(2))
    A2[1][A2[0].eq(0).all(-1) & A2[1].eq(0).all(-1)] = FQT.one  # no (0, 0): that is the mixed add's identity
    one = FQT.one.expand(n, 12).contiguous()
    madd = _host_op(lib, "proj_madd", (*P1, *A2), (n,))
    add = _host_op(lib, "proj_add", (*P1, *A2, one), (n,))
    for g, w, v in zip(madd, add, proj_add_plain(P1, (*A2, one))):
        assert torch.equal(g, w) and torch.equal(g, v)
    zero = torch.zeros((n, 12), dtype=torch.int32)
    add = _host_op(lib, "proj_add", (*P1, zero, one, zero), (n,))
    X, Y, Z = P1
    for g, v in zip(add, (mont_mul_plain(FQ, X, Y), mont_mul_plain(FQ, Y, Y), mont_mul_plain(FQ, Y, Z))):
        assert torch.equal(g, v)


# Small tiles.  Fr: radix-4 steps, one pass up to 2^3, then tiles of at
# most 2^4 elements with 2-4 columns (a block of at least 4 threads), so
# 2^4-2^6 take 2 passes and 2^7-2^9 three, with partial (radix-2) steps.
# Goldilocks: radix-4 steps (2 elements... 4 a thread), one pass up to 2^3,
# then tiles of at most 2^5 words with 2 columns, so 2^4-2^8 take 2 passes
# and 2^9-2^12 three, with partial steps.  And the library's own tiles
# (2^12 takes 2 passes in either field).
SMALL_TILES = ("-DZK_NTT_RADIX2_WORK=0", "-DZK_NTT_LOG_TILE=4", "-DZK_NTT_LOG_COLS=1", "-DZK_NTT_ONE_PASS=3",
               "-DZK_NTT_LOG_MIN_THREADS=2", "-DZK_NTT_GL_RADIX=2", "-DZK_NTT_GL_LOG_TILE=5",
               "-DZK_NTT_GL_LOG_COLS=1", "-DZK_NTT_GL_ONE_PASS=3")
# Fr's other builds: the same tiles in radix-2 steps (the plan's choice for
# small calls, here for every call); 4 columns (2^4-2^6 in 2 passes, 2^7-2^9
# in 3); one column, each later tile staging the strided twiddles of its
# own column (2^4-2^8 in 2 passes, 2^9 in 3); and the library's tiles in
# radix-4 steps (its default takes radix 2 for every call of the tests'
# size), a block of at least two warps: 2^11's passes take 4 and 8 columns.
FR_RADIX2 = ("-DZK_NTT_RADIX2_WORK=30", "-DZK_NTT_LOG_TILE=4", "-DZK_NTT_LOG_COLS=1", "-DZK_NTT_ONE_PASS=3",
             "-DZK_NTT_LOG_MIN_THREADS=2")
FR_COLS4 = ("-DZK_NTT_RADIX2_WORK=0", "-DZK_NTT_LOG_TILE=5", "-DZK_NTT_LOG_COLS=2", "-DZK_NTT_ONE_PASS=3",
            "-DZK_NTT_LOG_MIN_THREADS=2")
FR_COLS1 = ("-DZK_NTT_RADIX2_WORK=0", "-DZK_NTT_LOG_TILE=4", "-DZK_NTT_LOG_COLS=0", "-DZK_NTT_ONE_PASS=3",
            "-DZK_NTT_LOG_MIN_THREADS=0")
FR_LIB_RADIX4 = ("-DZK_NTT_RADIX2_WORK=0",)
# log2 of each Fr build's largest one-pass transform and of the stages a
# multi-pass tile holds
FR_PLANS = {SMALL_TILES: (3, 3), FR_RADIX2: (3, 3), FR_COLS4: (3, 3), FR_COLS1: (3, 4), FR_LIB_RADIX4: (10, 9),
            (): (10, 9)}
_FR_NAMES = {SMALL_TILES: "small_tiles", FR_RADIX2: "radix2", FR_COLS4: "cols4", FR_COLS1: "cols1",
             FR_LIB_RADIX4: "library_tiles_radix4", (): "library_tiles"}


def _fr_passes(flags, log_n: int) -> int:
    """The passes of ntt.cuh's plan for a build's flags."""
    one, per = FR_PLANS[flags]
    return 1 if log_n <= one else max(2, -(-log_n // per))


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
    passes = so.host_ntt(L, p, pinv, x.data_ptr(), out.data_ptr(), x.shape[0], n.bit_length() - 1,
                         table.data_ptr(), *args)
    return out, passes


def _fr_transforms(so, flags, x, log_n):
    """fft, ifft, coset_fft and coset_ifft of x through the host build,
    each against ntt_plain with the factors as the domain passes them; the
    pass count against the plan."""
    n = 1 << log_n
    dom = get_domain(FR, n, device="cpu")
    g = FR.generator
    n_inv = ntt_kernel._n_inv(FR, n, x.device)
    for inverse, fin, fout in ((False, None, None), (True, None, n_inv), (False, dom.offset_powers(g), None),
                               (True, None, dom._coset_out(g))):
        table = dom._inv_tw if inverse else dom._fwd_tw
        got, passes = _host_ntt(so, x, table, fin, fout)
        assert torch.equal(got, ntt_kernel.ntt_plain(x, table, inverse, fin, fout)), (inverse, fin is not None)
        assert passes == _fr_passes(flags, log_n)


_FR_CASES = ([(SMALL_TILES, k) for k in (1, 2, 3, 4, 5, 6, 7, 8, 9)] + [(FR_RADIX2, k) for k in (3, 5, 7, 9)]
             + [(FR_COLS4, k) for k in (4, 5, 7, 9)] + [(FR_COLS1, k) for k in (5, 9)] + [((), 5), ((), 12)]
             + [(FR_LIB_RADIX4, k) for k in (11, 12)])


@pytest.mark.parametrize("ntt_lib,log_n", _FR_CASES, indirect=["ntt_lib"],
                         ids=lambda v: _FR_NAMES[v] if isinstance(v, tuple) else f"2^{v}")
def test_host_ntt_matches_plain(ntt_lib, log_n):
    """fft, ifft, coset_fft and coset_ifft over a batch of 2 rows (0, 1 and
    p - 1 among them), with the factors as the domain passes them: one
    pass, two and three, radix-2 and radix-4 steps, full and partial, one
    column and several."""
    flags, so = ntt_lib
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    f = field(FR, "cpu")
    x = f.encode_ints(_elements(rng, FR, 2 * n) if n > 2 else [0, 1, FR.modulus - 1, 5]).reshape(2, n, 8)
    _fr_transforms(so, flags, x, log_n)


@pytest.mark.parametrize("ntt_lib,log_n", [(SMALL_TILES, 6), (FR_RADIX2, 7), (FR_COLS4, 7), (FR_COLS1, 7), ((), 11),
                                            (FR_LIB_RADIX4, 11)],
                         indirect=["ntt_lib"], ids=lambda v: _FR_NAMES[v] if isinstance(v, tuple) else f"2^{v}")
def test_host_ntt_edge_rows(ntt_lib, log_n):
    """A row of 0 and a row of p - 1: the lazy values' largest sums and
    differences (u + w v up to 4p, u - w v down to -2p).  The all-(p - 1)
    row's transform is (p - 1) n at 0 and 0 elsewhere, 0's is 0: a store
    that skipped the last canonicalization would leave p in place of 0."""
    flags, so = ntt_lib
    n = 1 << log_n
    f = field(FR, "cpu")
    x = f.encode_ints([0] * n + [FR.modulus - 1] * n).reshape(2, n, 8)
    _fr_transforms(so, flags, x, log_n)
    dom = get_domain(FR, n, device="cpu")
    got, _ = _host_ntt(so, x, dom._fwd_tw, None, None)
    assert f.decode_ints(got.reshape(-1, 8)) == [0] * n + [(FR.modulus - 1) * n % FR.modulus] + [0] * (n - 1)


def test_host_fr_lazy_ops():
    """The Fr butterfly's lazy operations (ntt.cuh) against field
    arithmetic on Python ints, on random words and the bounds' edges (0, 1,
    p - 1, p, 2p - 1): the products (field.cuh's mont_mul_lazy and the
    NTT's even/odd ntt_mul) of a canonical twiddle and a value below 2p
    are below 1.91 p and equal w v R^-1 mod p, and equal each other word
    for word; the sum and difference of two values below 2p are below 2p
    and equal mod p; the last store's canonicalization of a value below 2p
    is canonical."""
    so = _build(NTT_SHIM, "ntt_host")
    P = ctypes.c_void_p
    so.host_fr_lazy.argtypes = [P, ctypes.c_uint32, P, P, P, ctypes.c_int64, ctypes.c_int]
    so.host_fr_lazy.restype = None
    p = FR.modulus
    rng = np.random.default_rng(23)
    rand = [int.from_bytes(rng.bytes(32), "little") % (2 * p) for _ in range(400)]
    canon = [0, 1, p - 1, p - 2] + [v % p for v in rand[:96]]
    lazy = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p - 2] + rand
    pairs = {0: [(w, v) for w in canon for v in lazy[:60]], 1: [(u, v) for u in lazy[:70] for v in lazy[:70]],
             3: [(v, 0) for v in lazy]}
    pairs[2] = pairs[1]
    pairs[4] = pairs[0]
    pl, pinv = cuda_lib.field_consts(FR)
    rinv = pow(1 << 256, -1, p)

    def words(vals):
        return np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for v in vals], dtype=np.uint32)

    outs = {}
    for op, ab in pairs.items():
        A, B = words([a for a, _ in ab]), words([b for _, b in ab])
        out = outs[op] = np.zeros_like(A)
        so.host_fr_lazy(pl, pinv, A.ctypes.data, B.ctypes.data, out.ctypes.data, len(ab), op)
        got = [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in out]
        for (a, b), r in zip(ab, got):
            want, limit = {0: (a * b * rinv, 1.91 * p), 4: (a * b * rinv, 1.91 * p), 1: (a + b, 2 * p),
                           2: (a - b, 2 * p), 3: (a, p)}[op]
            assert r < limit and r % p == want % p, (op, a, b, r)
    np.testing.assert_array_equal(outs[4], outs[0])


@pytest.mark.parametrize("ntt_lib,log_n", [(SMALL_TILES, k) for k in (1, 2, 3, 4, 5, 6, 7, 9, 10, 11)]
                         + [((), 8), ((), 12)], indirect=["ntt_lib"],
                         ids=lambda v: ("small_tiles" if v else "library_tiles") if isinstance(v, tuple) else f"2^{v}")
def test_host_ntt_goldilocks_matches_plain(ntt_lib, log_n):
    """The Goldilocks design (ntt_gl.cuh: gl_mul's products, radix steps in
    registers, column twiddles in later passes) for FRI's coset transforms:
    fft, ifft, coset_fft, coset_ifft and coset_fft with the raw 1 as the
    output factor (FRI's fused from_mont) over a batch of 2 rows, one of
    them all zero and one holding p - 1, down to n = 2 and 4; with small
    tiles one pass up to 2^3, two with full and partial radix steps from 2^4
    to 2^8 and three from 2^9."""
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
                               (True, None, dom._coset_out(g)), (False, dom.offset_powers(g), f._one_raw)):
        table = dom._inv_tw if inverse else dom._fwd_tw
        got, passes = _host_ntt(so, x, table, fin, fout, GOLDILOCKS)
        want = ntt_kernel.ntt_plain(x, table, inverse, fin, fout, GOLDILOCKS)
        assert torch.equal(got, want), (inverse, fin is not None)
    if flags:
        assert passes == (1 if log_n <= 3 else 2 if log_n <= 8 else 3)
    else:
        assert passes == (2 if log_n == 12 else 1)


def _gl_lib():
    so = _build(NTT_SHIM, "ntt_host")
    P = ctypes.c_void_p
    so.host_gl_mul.argtypes = [P, ctypes.c_uint32, P, P, P, ctypes.c_int64, ctypes.c_int]
    so.host_gl_mul.restype = None
    so.host_fri_fold.argtypes = [P, ctypes.c_int64, ctypes.c_uint64, P]
    so.host_fri_fold.restype = None
    return so


def test_host_gl_mul_matches_fmul_wide_and_plain():
    """The 64-bit Goldilocks product (field.cuh's gl_mul) against the
    two-limb CIOS product it replaced (fmul_wide) and the plain product,
    word for word: every pair of 0, 1, p - 1, p - 2, 2^32, 2^32 - 1, 2^32 - 2
    (2^64 - p and its neighbours), 2^63, and random words."""
    so = _gl_lib()
    p = GOLDILOCKS.modulus
    rng = np.random.default_rng(17)
    edges = [0, 1, p - 1, p - 2, 2**32, 2**32 - 1, 2**32 - 2, 2**32 + 1, 2**63, 2**64 - 2**32]
    a = [x for x in edges for _ in edges] + [int(v) for v in rng.integers(0, p, size=4000, dtype=np.uint64)]
    b = [y for _ in edges for y in edges] + [int(v) for v in rng.integers(0, p, size=4000, dtype=np.uint64)]
    A, B = (np.array(v, dtype=np.uint64) for v in (a, b))
    pl, pinv = cuda_lib.field_consts(GOLDILOCKS)
    outs = []
    for wide in (0, 1):
        out = np.zeros_like(A)
        so.host_gl_mul(pl, pinv, A.ctypes.data, B.ctypes.data, out.ctypes.data, len(a), wide)
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])
    plain = mont_mul_plain(GOLDILOCKS, torch.from_numpy(A.view(np.int32).reshape(-1, 2)),
                           torch.from_numpy(B.view(np.int32).reshape(-1, 2)))
    np.testing.assert_array_equal(outs[0], plain.numpy().view(np.uint64)[:, 0])
    rinv = pow(1 << 64, -1, p)
    assert [int(v) for v in outs[0][:len(edges) ** 2]] == [x * y * rinv % p for x, y in zip(a, b)][:len(edges) ** 2]


@pytest.mark.parametrize("n", [1, 2, 7, 33, 1 << 10])
def test_host_fri_fold_matches_plain(n):
    """The fold's per-output code (fri_fold.cuh) against the plain fold,
    word for word, for one coefficient, two, odd lengths (a last odd term
    of 0) and 2^10, with 0 and p - 1 among the coefficients."""
    from zktpu_torch.fri.fold_kernel import fold_plain

    so = _gl_lib()
    rng = np.random.default_rng(400 + n)
    f = field(GOLDILOCKS, "cpu")
    vals = [int(v) for v in rng.integers(0, GOLDILOCKS.modulus, size=n, dtype=np.uint64)]
    vals[: min(n, 2)] = [0, GOLDILOCKS.modulus - 1][: min(n, 2)]
    c = f.encode_ints(vals)
    for r in (0, 1, GOLDILOCKS.modulus - 1, int(rng.integers(0, GOLDILOCKS.modulus, dtype=np.uint64))):
        out = np.zeros((n + 1) // 2, dtype=np.uint64)
        so.host_fri_fold(c.data_ptr(), n, GOLDILOCKS.to_mont(r), out.ctypes.data)
        np.testing.assert_array_equal(out, fold_plain(GOLDILOCKS, c, r).numpy().view(np.uint64)[:, 0])


# Kernels A and B (csrc/field_ops.cuh) through the port's own wrappers: the
# host build takes the library's arguments, so field_kernel's launch logic
# (chunk, tiles, the status buffer's tickets and epochs) runs unchanged.  Two
# warps a block and one row a thread make small inputs take many tiles (35
# at 2200 rows: the look-back crosses a window of 32); two warps and chunks
# of up to 6 rows take two load batches a thread, the second partial, and
# scans of up to 256 rows one tile; the library's 256 threads once.
SCAN_SHIM = os.path.join(HERE, "scan_host.cpp")
SCAN_DESIGNS = {
    "two_warps_many_tiles": (("-DZK_SCAN_THREADS=64",), {"SCAN_GRID": 1 << 30, "SCAN_ONE_TILE": 0, "POWERS_CHUNK": 3}),
    "two_warps_long_chunks": (("-DZK_SCAN_THREADS=64",), {"SCAN_GRID": 1, "SCAN_CHUNK_MAX": 6}),
    "library_threads": ((), {}),
}
# The host build's block schedules: whole blocks in ticket order (every
# look-back meets an inclusive prefix at once), and every aggregate first:
# phases 1-3 of every block, then all the look-backs at once, from the last
# ticket, each publishing its aggregate before any reads it (the look-backs
# combine aggregates back to tile 0).
SCHEDULES = {"ticket_order": 0, "aggregates_first": 1}


@pytest.fixture(scope="module", params=sorted(SCAN_DESIGNS))
def scan_lib(request):
    flags, sizes = SCAN_DESIGNS[request.param]
    so = _build(SCAN_SHIM, "scan_host", flags)
    for name in ("zk_field_scan", "zk_field_scan_threads", "zk_field_scan_status_words", "zk_field_powers",
                 "zk_field_batch_inv", "zk_field_addsub"):
        fn = getattr(so, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    so.host_scan_schedule.argtypes = [ctypes.c_int]
    so.host_scan_schedule.restype = None
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


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
@pytest.mark.parametrize("op", [field_kernel.OP_MUL, field_kernel.OP_ADD], ids=["cumprod", "cumsum"])
def test_host_field_scan_matches_plain(scan_lib, spec, op, schedule):
    """Forward and reverse scans of n = 1, 2, 3, 17, 64, 65 and 300 rows
    (one tile, a tile's edge, several tiles), one column and three columns,
    along axis 0 and along the middle axis of (3, n, L); and one column of
    2200 rows (35 tiles of 64 rows in the many-tiles design, 6 and 18 in the
    others).  Each is one launch."""
    _, so = scan_lib
    so.host_scan_schedule(SCHEDULES[schedule])
    f = field(spec, "cpu")
    for n in (1, 2, 3, 17, 64, 65, 300):
        x = _field_rows(spec, 3 * n, n).reshape(n, 3, -1)
        for a, axis in ((x[:, 0], 0), (x, 0), (x.permute(1, 0, 2).contiguous(), 1)):
            for reverse in (False, True):
                got, k = field_kernel.scan_kernel(so, f, a, op, axis, reverse)
                assert k == 1 and torch.equal(got, field_kernel.scan_plain(f, a, op, axis, reverse)), (n, axis, reverse)
    a = _field_rows(spec, 2200, 2200)
    for reverse in (False, True):
        got, k = field_kernel.scan_kernel(so, f, a, op, 0, reverse)
        assert k == 1 and torch.equal(got, field_kernel.scan_plain(f, a, op, 0, reverse)), reverse


@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
def test_host_field_sum_powers_batch_inv_match_plain(scan_lib, spec):
    """In both schedules: the sum on axis 0 and 1 (one launch; the last tile
    writes the column's total), powers (several rows a thread, a count that
    is not a multiple of them), batch_inv (the forward and the reverse scan
    in one launch, the shifted reads at both ends; two launches)."""
    design, so = scan_lib
    f = field(spec, "cpu")
    for schedule in SCHEDULES.values():
        so.host_scan_schedule(schedule)
        for n in (1, 3, 64, 200):
            x = _field_rows(spec, 4 * n, 100 + n).reshape(4, n, -1)
            for axis in (0, 1):
                got, k = field_kernel.sum_kernel(so, f, x, axis)
                assert k == 1 and torch.equal(got, field_kernel.sum_plain(f, x, axis)), (n, axis)
            got, k = field_kernel.sum_kernel(so, f, x[0], 0)
            assert k == 1 and torch.equal(got, field_kernel.sum_plain(f, x[0], 0))
        for n in (1, 2, 17, 300):
            a = _field_rows(spec, n, 200 + n, nonzero=True)
            got, k = field_kernel.batch_inv_kernel(so, f, a, spec.inv)
            assert k == 2 and torch.equal(got, field_kernel.batch_inv_plain(f, a, spec.inv)), n
    for count in (1, 2, 3, 17, 300):
        for z in (0, 1, 5, spec.modulus - 1):
            got, k = field_kernel.powers_kernel(so, f, z, count)
            assert k == 1 and torch.equal(got, field_kernel.powers_plain(f, z, count)), (count, z)
    a = _field_rows(spec, 2 * 17, 7, nonzero=True).reshape(2, 17, -1)
    assert torch.equal(field_kernel.batch_inv_kernel(so, f, a, spec.inv)[0],
                       field_kernel.batch_inv_plain(f, a, spec.inv))


@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
def test_host_field_scans_match_zktpu_golden(scan_lib, spec):
    """The host build, aggregates first (every look-back walks aggregates),
    on tests/test_torch_field_ops.py's inputs against zktpu's words in
    tests/goldens/field_ops.npz: cumprod and cumsum both ways, the sum on
    axis 0 and 1 and batch_inv at n = 1, 2, 3, 17 and 64."""
    from test_torch_field_ops import GOLDEN, SIZES, _inputs

    _, so = scan_lib
    so.host_scan_schedule(SCHEDULES["aggregates_first"])
    f = field(spec, "cpu")
    with np.load(GOLDEN) as g:
        zk = {k.split("/", 1)[1]: g[k] for k in g.files if k.startswith(spec.name + "/")}
    for n in SIZES:
        a = f.encode_ints(_inputs(spec, n)[0]).reshape(n, 3, -1)
        for reverse in (False, True):
            way = "rev" if reverse else "fwd"
            for op, name in ((field_kernel.OP_MUL, "cumprod"), (field_kernel.OP_ADD, "cumsum")):
                np.testing.assert_array_equal(field_kernel.scan_kernel(so, f, a, op, 0, reverse)[0].numpy(),
                                              zk[f"{name}_{way}_{n}"])
        np.testing.assert_array_equal(field_kernel.sum_kernel(so, f, a, 0)[0].numpy(), zk[f"sum0_{n}"])
        np.testing.assert_array_equal(field_kernel.sum_kernel(so, f, a.transpose(0, 1).contiguous(), 1)[0].numpy(),
                                      zk[f"sum1_{n}"])
        inv_in = f.encode_ints(_inputs(spec, n)[1]).reshape(3, n, -1)
        np.testing.assert_array_equal(field_kernel.batch_inv_kernel(so, f, inv_in, spec.inv)[0].numpy(),
                                      zk[f"batch_inv_{n}"])


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


# Kernels 5m and 5f (csrc/mont_mma.cuh): a simulated warpgroup, 128 threads
# with the wgmma m64nNk32 u8 operands of the PTX ISA emulated (shared-memory
# descriptors, register fragments, the s32 accumulator layout), through the
# library's entry point over host memory.  MMA_DESIGNS: the library's design
# and the others tools/mma_budgets.py times on the card.
MMA_SHIM = os.path.join(HERE, "mont_mma_host.cpp")
MMA_DESIGNS = {
    "library": (),
    "one_tile_one_part": ("-DZK_MMA_TILES=1", "-DZK_MMA_PSPLIT=1"),
    "two_tiles_two_parts": ("-DZK_MMA_TILES=2", "-DZK_MMA_PSPLIT=2"),
}


def _host_mma_chain(spec, variant, flags=(), n=131, chain=3):
    """(out, want): `chain` products over n elements (the last block ragged)
    with 0, 1 and p - 1 among them, and the plain chain."""
    so = _build(MMA_SHIM, "mont_mma_host", ("-pthread", *flags))
    P = ctypes.c_void_p
    so.host_mont_mma_chain.argtypes = [ctypes.c_int, P, ctypes.c_uint32, ctypes.c_int, P, P, P, P, P,
                                       ctypes.c_int64, ctypes.c_int]
    so.host_mont_mma_chain.restype = ctypes.c_int
    rng = np.random.default_rng(21)
    f = field(spec, "cpu")
    a, b = (f.encode_ints(_elements(rng, spec, n)) for _ in range(2))
    qmat, pmat = kernel_mats(spec)
    p, pinv = cuda_lib.field_consts(spec)
    out = torch.zeros_like(a)
    rc = so.host_mont_mma_chain(spec.num_digits // 2, p, pinv, int(variant == "f32"), qmat.ctypes.data,
                                pmat.ctypes.data, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], chain)
    assert rc == 0, "a descriptor held a swizzle or base offset, or a warpgroup's threads disagreed"
    return out, mont_mul_chain_plain(spec, a, b, chain)


@pytest.mark.parametrize("variant", ["mxu", "f32"])
@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
def test_host_mont_mma_chain_matches_plain(spec, variant):
    """Three chained products over 131 elements (two warpgroups, the second
    with three live threads) with 0, 1 and p - 1 among them, against the
    plain chain, in the library's design."""
    out, want = _host_mma_chain(spec, variant)
    assert torch.equal(out, want)


@pytest.mark.parametrize("kind", ["split", "f32"])
@pytest.mark.parametrize("limbs", [8, 12])
def test_host_mont_mma_products_match_ints(limbs, kind):
    """The variable product t = x y of each body (conv_split, conv_f32)
    against Python ints, on words that make the longest carry runs (all
    ones, all ones but one word, alternating) and random ones."""
    so = _build(MMA_SHIM, "mont_mma_host", ("-pthread",))
    P = ctypes.c_void_p
    so.host_mont_mma_product.argtypes = [ctypes.c_int, ctypes.c_int, P, P, P, ctypes.c_int64]
    rng = np.random.default_rng(limbs)
    full = (1 << (32 * limbs)) - 1
    vals = [full, full - 1, full ^ (0xFFFFFFFF << 32 * (limbs // 2)), int("AAAAAAAA" * limbs, 16), 0, 1]
    vals += [int.from_bytes(rng.bytes(4 * limbs), "little") for _ in range(26)]
    xs = vals + [full] * len(vals)
    ys = [full] * len(vals) + vals[::-1]
    x = np.array([[(v >> 32 * k) & 0xFFFFFFFF for k in range(limbs)] for v in xs], dtype=np.uint32)
    y = np.array([[(v >> 32 * k) & 0xFFFFFFFF for k in range(limbs)] for v in ys], dtype=np.uint32)
    t = np.zeros((len(xs), 2 * limbs), dtype=np.uint32)
    kinds = {"split": 0, "f32": 1}
    assert so.host_mont_mma_product(limbs, kinds[kind], x.ctypes.data, y.ctypes.data, t.ctypes.data, len(xs)) == 0
    got = [sum(int(w) << 32 * k for k, w in enumerate(row)) for row in t]
    assert got == [a * b for a, b in zip(xs, ys)]


@pytest.mark.parametrize("design", sorted(set(MMA_DESIGNS) - {"library"}))
@pytest.mark.parametrize("variant", ["mxu", "f32"])
@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
def test_host_mont_mma_designs_match_plain(spec, variant, design):
    """The same in the sweep's other designs."""
    out, want = _host_mma_chain(spec, variant, MMA_DESIGNS[design])
    assert torch.equal(out, want)


# Nova's matrix-vector product (csrc/matvec.cuh): every block and thread on
# the CPU, through the port's own wrapper (nova/matvec_kernel.py's run),
# with one warp and four rows a block, two warps and three rows, and the
# library's design.
MATVEC_SHIM = os.path.join(HERE, "matvec_host.cpp")
MATVEC_DESIGNS = {
    "one_warp_four_rows": ("-DZK_MATVEC_THREADS=32", "-DZK_MATVEC_ROWS=4"),
    "two_warps_three_rows": ("-DZK_MATVEC_THREADS=64", "-DZK_MATVEC_ROWS=3"),
    "library": (),
}


def matvec_host_lib(design: str = "one_warp_four_rows") -> ctypes.CDLL:
    """The host build of the matvec kernel in one of MATVEC_DESIGNS."""
    so = _build(MATVEC_SHIM, "matvec_host", MATVEC_DESIGNS[design])
    for name in ("zk_matvec", "zk_matvec_attrs"):
        fn = getattr(so, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return so


@pytest.fixture(scope="module", params=sorted(MATVEC_DESIGNS))
def matvec_lib(request):
    return request.param, matvec_host_lib(request.param)


def _fr_words(rng, shape) -> torch.Tensor:
    """Canonical Fr words of `shape` + (8,), the words 0, 1, p - 2 and p - 1 among them."""
    count = int(np.prod(shape))
    return torch.from_numpy(ints_to_limbs(_elements(rng, FR, count), 8)).reshape(*shape, 8)


@pytest.mark.parametrize("m, n", [(1, 1), (3, 2), (5, 33), (9, (1 << 10) + 3)])
def test_host_matvec_matches_plain(matvec_lib, m, n):
    """Random canonical entries with the edge words: m below, at and past a
    block's rows, n below one warp, past it, and 2^10 + 3 (a tail of the
    column loop in every design)."""
    from zktpu_torch.nova import matvec_kernel

    design, so = matvec_lib
    rng = np.random.default_rng(1000 * m + n)
    A, z = _fr_words(rng, (m, n)), _fr_words(rng, (n,))
    got = matvec_kernel.run(so, A, z)
    assert torch.equal(got, matvec_kernel.matvec_plain(field(FR, "cpu"), A, z)), (design, m, n)
    attrs = (ctypes.c_int * 5)()
    assert so.zk_matvec_attrs(attrs) == 0
    assert (attrs[3], attrs[4]) == {"one_warp_four_rows": (4, 32), "two_warps_three_rows": (3, 64),
                                    "library": (1, 128)}[design]


def test_host_matvec_all_p_minus_one(matvec_lib):
    """Every word of A and z p - 1, n = 2^10 + 3: one warp's threads sum 33
    products of (p - 1)^2 each (more than 16 words hold), so the sum needs
    the accumulator's 17th word."""
    from zktpu_torch.nova import matvec_kernel

    _, so = matvec_lib
    m, n = 6, (1 << 10) + 3
    top = torch.from_numpy(ints_to_limbs([FR.modulus - 1], 8))[0]
    A, z = top.expand(m, n, 8).contiguous(), top.expand(n, 8).contiguous()
    got = matvec_kernel.run(so, A, z)
    assert torch.equal(got, matvec_kernel.matvec_plain(field(FR, "cpu"), A, z))
    want = (FR.modulus - 1) ** 2 * n * pow(FR.mont_r, -1, FR.modulus) % FR.modulus
    assert [int.from_bytes(r.numpy().astype("<u4").tobytes(), "little") for r in got] == [want] * m


def test_host_matvec_refuses_bad_operands():
    from zktpu_torch.nova import matvec_kernel

    so = matvec_host_lib()
    A, z = torch.zeros((2, 3, 8), dtype=torch.int32), torch.zeros((3, 8), dtype=torch.int32)
    for a, b in ((A, z[:2]), (A[:, :, :4], z), (A.to(torch.int64), z), (A[:, ::2], z[:2]), (A[:0], z)):
        with pytest.raises(ValueError):
            matvec_kernel.run(so, a, b)


# The field linear combination (csrc/lincomb.cuh): every row's code on the
# CPU, through the port's own wrapper (fields/lincomb_kernel.py's run).
LINCOMB_SHIM = os.path.join(HERE, "lincomb_host.cpp")


@pytest.fixture(scope="module")
def lincomb_lib():
    so = _build(LINCOMB_SHIM, "lincomb_host")
    for name in ("zk_lincomb", "zk_lincomb_attrs"):
        fn = getattr(so, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return so


def _host_lincomb(so, products, addends):
    from zktpu_torch.fields import lincomb_kernel

    terms, n = lincomb_kernel._terms(field(FR, "cpu"), products, addends)
    out = torch.zeros((n, 8), dtype=torch.int32)
    lincomb_kernel.run(so, [(a.contiguous(), None if b is None else b.contiguous(), s) for a, b, s in terms], n, out)
    return out


# (rows of each product's a, its b's rows (0: one row, a scalar), rows of each addend), signs alternating
LINCOMB_CASES = {
    "compute_t": ([(37, 37), (37, 37), (37, 0), (37, 0)], []),
    "fold_e": ([(37, 0), (37, 0)], [37]),
    "w_ev_x": ([(35, 0), (35, 0), (35, 0), (33, 0), (33, 0)], [40, 1]),
    "eight_unequal": ([(1, 1), (9, 9), (4, 0), (16, 16), (2, 0)], [17, 3, 1]),
}


@pytest.mark.parametrize("case", sorted(LINCOMB_CASES))
def test_host_lincomb_matches_plain(lincomb_lib, case):
    """Random canonical rows with the edge words 0, 1, p - 2 and p - 1, at
    the sites' shapes (unequal lengths, scalars, a row-0 addend), both
    signs: the kernel's row code == the plain chain, every word."""
    from zktpu_torch.fields.lincomb_kernel import lincomb_plain

    prods, adds = LINCOMB_CASES[case]
    rng = np.random.default_rng(len(case) * 7919 + len(prods))
    sign = [1 if k % 3 else -1 for k in range(len(prods) + len(adds))]
    products = [(_fr_words(rng, (na,)), _fr_words(rng, (nb or 1,)), sign[k]) for k, (na, nb) in enumerate(prods)]
    addends = [(_fr_words(rng, (nc,)), sign[len(prods) + j]) for j, nc in enumerate(adds)]
    want = lincomb_plain(field(FR, "cpu"), products, addends)
    assert torch.equal(_host_lincomb(lincomb_lib, products, addends), want), case


@pytest.mark.parametrize("negate", [False, True])
def test_host_lincomb_all_p_minus_one(lincomb_lib, negate):
    """K + J = 8 terms of rows of p - 1 (and of 0, which a negative term
    turns into p): the accumulator's largest sums."""
    from zktpu_torch.fields.lincomb_kernel import lincomb_plain

    n, p = 5, FR.modulus
    top = torch.from_numpy(ints_to_limbs([p - 1], 8))[0].expand(n, 8).contiguous()
    zero = torch.zeros((n, 8), dtype=torch.int32)
    s = -1 if negate else 1
    products = [(top, top, s), (top, top, s), (top, top[:1], s), (zero, top, s), (top, zero[:1], s)]
    addends = [(top, s), (zero, s), (top[:1], s)]
    got = _host_lincomb(lincomb_lib, products, addends)
    assert torch.equal(got, lincomb_plain(field(FR, "cpu"), products, addends))
    rinv = pow(FR.mont_r, -1, p)
    row = 3 * (p - 1) ** 2 * rinv + (p - 1)
    want = [s * (row + (p - 1 if i == 0 else 0)) % p for i in range(n)]
    assert [int.from_bytes(r.numpy().astype("<u4").tobytes(), "little") for r in got] == want


def test_host_lincomb_refuses_bad_terms(lincomb_lib):
    from zktpu_torch.fields import lincomb_kernel

    a = torch.zeros((3, 8), dtype=torch.int32)
    out = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError):  # nine terms in one launch
        lincomb_kernel.run(lincomb_lib, [(a, None, 1)] * 9, 3, out)
    with pytest.raises(RuntimeError):  # a term longer than the result
        lincomb_kernel.run(lincomb_lib, [(a, None, 1)], 2, out)
    with pytest.raises(ValueError):  # b neither one row nor as long as a
        lincomb_kernel.lincomb(field(FR, "cpu"), [(a, a[:2], 1)])
    with pytest.raises(ValueError):
        lincomb_kernel.lincomb(field(FR, "cpu"), [(a, a, 2)])
    with pytest.raises(ValueError):
        lincomb_kernel.lincomb(field(FQ, "cpu"), [], [(torch.zeros((3, 12), dtype=torch.int32), 1)])
