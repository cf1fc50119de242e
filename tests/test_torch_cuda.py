"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device or nvcc.  On the GPU
machine (no JAX there, so without the repo's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import os
import random

import pytest
import torch

from zktpu_torch import cuda_lib
from zktpu_torch.curves.host_curve import G1Affine
from zktpu_torch.fields.host import FQ, FR, GOLDILOCKS

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if cuda_lib.find_nvcc() is None and not os.path.exists(cuda_lib.library_path()):
        pytest.skip("no nvcc to build the kernels")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("spec", [FR, FQ, GOLDILOCKS], ids=lambda s: s.name)
def test_mont_mul_kernel_matches_plain(device, spec):
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_plain

    f = field(spec, device)
    rng = random.Random(1)
    p = spec.modulus
    a = [0, 1, p - 1] + [rng.randrange(p) for _ in range(1000)]
    b = [p - 1, p - 1, p - 1] + [rng.randrange(p) for _ in range(1000)]
    A, B = f.encode_ints(a), f.encode_ints(b)
    before = mont_mul.launches[spec.name]
    got = mont_mul(spec, A, B)
    assert mont_mul.launches[spec.name] == before + 1
    assert torch.equal(got, mont_mul_plain(spec, A, B))
    assert f.decode_ints(got) == [x * y % p for x, y in zip(a, b)]
    # broadcasting: a (K, m) batch against an (m,) table, and one constant
    T = A[:10].reshape(2, 5, -1)
    assert torch.equal(mont_mul(spec, T, B[:5]), mont_mul_plain(spec, T, B[:5]))
    assert torch.equal(mont_mul(spec, A, B[7]), mont_mul_plain(spec, A, B[7]))
    with pytest.raises(TypeError):
        mont_mul(spec, A.to(torch.int64), B)


def test_proj_kernels_match_plain(device):
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.g1_kernel import proj_add, proj_add_plain, proj_double, proj_double_plain

    G = G1Affine.generator()
    pts = [G.mul(k) for k in (1, 2, 3, 7, 1, 9)] + [G1Affine.identity()]
    qts = [G1Affine.identity(), G.mul(5), G.mul(3), G.mul(FR.modulus - 7), G.mul(11), G.mul(9), G1Affine.identity()]
    P, Q = g1.host_points_to_device(pts, device), g1.host_points_to_device(qts, device)
    got = proj_add(P, Q)
    for a, b in zip(got, proj_add_plain(P, Q)):
        assert torch.equal(a, b)
    assert g1.proj_to_affine_host(got) == [x + y for x, y in zip(pts, qts)]
    got = proj_double(P)
    for a, b in zip(got, proj_double_plain(P)):
        assert torch.equal(a, b)
    assert g1.proj_to_affine_host(got) == [x + x for x in pts]


def test_msm_on_device_matches_host(device):
    from zktpu_torch.curves import g1, msm

    G = G1Affine.generator()
    rng = random.Random(5)
    pts = [G.mul(rng.randrange(1, 1 << 10)) for _ in range(40)]
    scalars = [rng.randrange(FR.modulus) for _ in range(40)]
    want = G1Affine.identity()
    for s, p in zip(scalars, pts):
        want = want + p.mul(s)
    P = g1.host_points_to_device(pts, device)
    R = msm.msm_proj(g1.scalars_to_u32(scalars, device), *P, c=msm.pick_window(40))
    assert g1.proj_to_affine_host(tuple(a[None] for a in R)) == [want]


@pytest.mark.parametrize("spec", [FR, FQ, GOLDILOCKS], ids=lambda s: s.name)
def test_mont_mul_chain_kernel_matches_plain(device, spec):
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.mont_kernel import mont_mul_chain, mont_mul_chain_plain

    f = field(spec, device)
    rng = random.Random(2)
    p = spec.modulus
    a = [0, 1, p - 1] + [rng.randrange(p) for _ in range(500)]
    b = [p - 1, 1, p - 1] + [rng.randrange(p) for _ in range(500)]
    A, B = f.encode_ints(a), f.encode_ints(b)
    before = mont_mul_chain.launches["base"]
    got = mont_mul_chain(spec, A, B, 12)
    assert mont_mul_chain.launches["base"] == before + 1
    assert torch.equal(got, mont_mul_chain_plain(spec, A, B, 12))
    assert f.decode_ints(got) == [x * pow(y, 12, p) % p for x, y in zip(a, b)]


@pytest.mark.parametrize("variant", ["mxu", "f32"])
@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
def test_mont_mma_chain_kernel_matches_plain(device, spec, variant):
    """The tensor-core chain (kernels 5m, 5f) against its own plain version
    and the base plain chain: 503 elements (a ragged last warp) with 0, 1
    and p - 1, one launch each; Goldilocks raises."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.mont_kernel import (
        mont_mul_chain, mont_mul_chain_f32_plain, mont_mul_chain_mxu_plain, mont_mul_chain_plain,
    )

    f = field(spec, device)
    rng = random.Random(3)
    p = spec.modulus
    a = [0, 1, p - 1] + [rng.randrange(p) for _ in range(500)]
    b = [p - 1, p - 1, 1] + [rng.randrange(p) for _ in range(500)]
    A, B = f.encode_ints(a), f.encode_ints(b)
    before = mont_mul_chain.launches[variant]
    got = mont_mul_chain(spec, A, B, 12, variant)
    assert mont_mul_chain.launches[variant] == before + 1
    plain = mont_mul_chain_f32_plain if variant == "f32" else mont_mul_chain_mxu_plain
    assert torch.equal(got, plain(spec, A, B, 12))
    assert torch.equal(got, mont_mul_chain_plain(spec, A, B, 12))
    assert f.decode_ints(got) == [x * pow(y, 12, p) % p for x, y in zip(a, b)]
    g = field(GOLDILOCKS, device).encode_ints([1, 2])
    with pytest.raises(ValueError, match="MXU_MIN_DIGITS"):
        mont_mul_chain(GOLDILOCKS, g, g, 2, variant)


def test_proj_madd_kernel_matches_plain(device):
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.g1_kernel import proj_add_plain, proj_madd, proj_madd_plain
    from zktpu_torch.fields.fp import field

    G = G1Affine.generator()
    fq = field(FQ, device)
    # lanes: P1 = O; A2 = (0, 0); A2 = P1 (doubling); A2 = -P1; all-zero padding; general
    p1 = [G1Affine.identity(), G.mul(3), G.mul(5), G.mul(6), G.mul(1), G.mul(9)]
    a2 = [G.mul(4), G1Affine.identity(), G.mul(5), -G.mul(6), G1Affine.identity(), G.mul(2)]
    P1 = proj_add_plain(g1.host_points_to_device(p1, device), g1.host_points_to_device([G.mul(7)] * 6, device))
    P1 = proj_add_plain(P1, g1.host_points_to_device([-G.mul(7)] * 6, device))  # general Z, same points
    P1 = [t.contiguous() for t in P1]
    A2 = [fq.encode_ints([0 if q.infinity else getattr(q, c) for q in a2]) for c in ("x", "y")]
    for t in (*P1, *A2):
        t[4] = 0
    before = proj_madd.launches
    got = proj_madd(P1, A2)
    assert proj_madd.launches == before + 1
    for x, y in zip(got, proj_madd_plain(P1, A2)):
        assert torch.equal(x, y)
    keep = [0, 1, 2, 3, 5]
    assert g1.proj_to_affine_host(tuple(t[keep] for t in got)) == [p1[i] + a2[i] for i in keep]
    assert all(not t[4].any() for t in got)


def test_msm_affine_on_device_matches_host(device):
    from zktpu_torch.curves import g1, msm
    from zktpu_torch.curves.g1_kernel import proj_madd

    G = G1Affine.generator()
    rng = random.Random(6)
    pts = [G.mul(rng.randrange(1, 1 << 10)) for _ in range(40)] + [G1Affine.identity()]
    scalars = [rng.randrange(FR.modulus) for _ in range(41)]
    want = G1Affine.identity()
    for s, p in zip(scalars, pts):
        want = want + p.mul(s)
    Xa, Ya = g1.proj_to_affine_dev(g1.host_points_to_device(pts[:40], device))
    Xa, Ya = (torch.cat([t, torch.zeros_like(t[:1])]) for t in (Xa, Ya))  # (0, 0): the identity
    sc, Xa, Ya = msm.pad_msm_inputs_affine(g1.scalars_to_u32(scalars, device), Xa, Ya)
    before = proj_madd.launches
    R = msm.msm_affine(sc, Xa, Ya, c=msm.pick_window(41))
    assert proj_madd.launches > before
    assert g1.proj_to_affine_host(tuple(a[None] for a in R)) == [want]


@pytest.mark.parametrize("name", ["proj_add", "proj_madd"])
def test_redesigned_adds_strided_broadcast_out(device, name):
    """Strided slices of (3, n + 5, 12) planes, a broadcast operand and out=
    planes, against the plain version; n = 1 and an n that is not a multiple
    of the 128-thread block; overlapping outputs raise; 0 spills."""
    from zktpu_torch.curves import g1, g1_kernel
    from zktpu_torch.fields.fp import field

    kernel, plain = getattr(g1_kernel, name), getattr(g1_kernel, f"{name}_plain")
    fq = field(FQ, device)
    rng = random.Random(3)
    p = FQ.modulus
    for n in (1, 333):
        vals = [0, 1, p - 1] + [rng.randrange(p) for _ in range(3 * 3 * (n + 5) * 3)]
        X, Y, Z = (fq.encode_ints(vals[k * 3 * (n + 5):(k + 1) * 3 * (n + 5)]).reshape(3, n + 5, 12) for k in range(3))
        P1 = tuple(t[:, :n] for t in (X, Y, Z))
        P2 = tuple(t[:, 5:] for t in (X, Y, Z)) if name == "proj_add" else (X[:, 5:], Y[:, 5:])
        if name == "proj_madd":
            for t in P2:
                t[0, 0] = 0  # the affine identity (0, 0)
        before = kernel.launches
        got = kernel(P1, P2)
        assert kernel.launches == before + 1
        for a, b in zip(got, plain(P1, P2)):
            assert torch.equal(a, b)
        one = tuple(t[1, 0] for t in P2)  # broadcast
        out = tuple(torch.full((3, n, 12), -1, dtype=torch.int32, device=device) for _ in range(3))
        assert kernel(P1, one, out=out) is out
        for a, b in zip(out, plain(P1, one)):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="overlap"):
            kernel(P1, P2, out=(X[:, 1:n + 1], out[1], out[2]))
    attrs = g1_kernel.kernel_attrs(name)
    assert attrs["local_bytes"] == 0, attrs
    G = G1Affine.generator()
    pts = g1.host_points_to_device([G.mul(3), G.mul(5)], device)
    if name == "proj_add":
        assert g1.proj_to_affine_host(kernel(pts, pts)) == [G.mul(6), G.mul(10)]


@pytest.mark.parametrize("log_n", [0, 1, 5, 9, 12, 15])
def test_ntt_kernel_matches_plain(device, log_n):
    """fft, ifft, coset_fft and coset_ifft on a batch of 3 (an all-zero row,
    a row of p - 1), one pass (n <= 2^10, one tile) and two; launches
    counted as the plan has them; 0 spills."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.poly import ntt_kernel
    from zktpu_torch.poly.domain import get_domain

    n = 1 << log_n
    f = field(FR, device)
    rng = random.Random(log_n)
    x = f.encode_ints([rng.randrange(FR.modulus) for _ in range(3 * n)]).reshape(3, n, 8)
    x[0] = 0
    x[1] = f.encode_int(FR.modulus - 1)
    dom = get_domain(FR, n, device=device)
    g = FR.generator
    for inverse, fin, fout in ((False, None, None), (True, None, None), (False, dom.offset_powers(g), None),
                               (True, None, dom._coset_out(g) if n > 1 else None)):
        table = dom._inv_tw if inverse else dom._fwd_tw
        before = ntt_kernel.ntt.launches[FR.name]
        got = ntt_kernel.ntt(x, table, inverse, fin, fout)
        assert ntt_kernel.ntt.launches[FR.name] == before + (1 if log_n <= 10 else 2) == before + len(
            ntt_kernel.fr_plan(log_n, 3))
        assert torch.equal(got, ntt_kernel.ntt_plain(x, table, inverse, fin, fout)), (inverse, fin is not None)
    assert ntt_kernel.kernel_attrs(FR, 1)["local_bytes"] == ntt_kernel.kernel_attrs(FR, 2)["local_bytes"] == 0


@pytest.mark.parametrize("W,K,c", [(4, 1, 16), (3, 8, 13), (2, 9, 3), (1, 2, 4), (20, 1, 13), (20, 3, 13)])
def test_horner_combine_kernel_matches_plain(device, W, K, c):
    """One launch against the plain loop, with an identity among the parts,
    K = 9 points, W = 1, and the PLONK and Nova commits' shapes at 2^14
    (c = 13, W = 20; K = 1 and 3)."""
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.g1_kernel import horner_combine, horner_combine_plain, kernel_attrs

    G = G1Affine.generator()
    rng = random.Random(W * 100 + K)
    pts = [G.mul(rng.randrange(1, 1 << 20)) for _ in range(W * K)]
    pts[0] = G1Affine.identity()
    parts = tuple(t.reshape(W, K, 12) for t in g1.host_points_to_device(pts, device))
    before = horner_combine.launches
    got = horner_combine(parts, c)
    assert horner_combine.launches == before + 1
    want = horner_combine_plain(parts, c)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kernel_attrs("horner_combine")["local_bytes"] == 0


def test_pythagorean_proof_tensor_paths_gpu_equals_cpu(device):
    """Every tensor path forced (NTT kernel, Horner combine, coset quotient):
    the proof from the card has the CPU's bytes and verifies."""
    import zktpu_torch.config as cfg
    from zktpu_torch.kzg import Srs
    from zktpu_torch.plonk.circuit import Circuit
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.plonk.verifier import verify
    from zktpu_torch.poly import ntt_kernel
    from zktpu_torch.transcript.chacha import StdRng

    def circuit():
        c = Circuit()
        c.add_multiplication_gate((1, 0, 3), (0, 0, 3), (0, 3, 9), 0)
        c.add_multiplication_gate((1, 1, 4), (0, 1, 4), (1, 3, 16), 0)
        c.add_multiplication_gate((1, 2, 5), (0, 2, 5), (2, 3, 25), 0)
        c.add_addition_gate((2, 0, 9), (2, 1, 16), (2, 2, 25), 0)
        return c

    saved = (cfg.HOST_MSM_MAX, cfg.HOST_NTT_MAX, cfg.HOST_POLY_MAX)
    cfg.HOST_MSM_MAX = cfg.HOST_NTT_MAX = cfg.HOST_POLY_MAX = 0
    try:
        proofs = {}
        for dev in (device, torch.device("cpu")):
            compiled = circuit().compile(device=dev)
            srs = Srs.new_from_secret(0x5EED5EED, compiled.size, device=dev)
            before = ntt_kernel.ntt.launches[FR.name]
            proofs[dev.type] = generate_proof(compiled, srs, StdRng.from_seed_u64(7), force="coset")
            if dev.type == "cuda":
                assert ntt_kernel.ntt.launches[FR.name] > before
            verify(compiled, srs, proofs[dev.type])
    finally:
        cfg.HOST_MSM_MAX, cfg.HOST_NTT_MAX, cfg.HOST_POLY_MAX = saved
    assert proofs["cuda"] == proofs["cpu"]


@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
@pytest.mark.parametrize("n", [1, 3, 17, 4096, 4097, 1 << 14, (1 << 15) + 1])
def test_field_scan_kernel_matches_plain(device, spec, n):
    """cumprod and cumsum forward and reverse, the sum on axis 0 and 1, powers
    and batch_inv against their plain versions, from one tile to many: one
    launch a scan and a sum, two a batch inversion, counted; 0 spills."""
    from zktpu_torch.fields import field_kernel as fk
    from zktpu_torch.fields.fp import field

    f = field(spec, device)
    rng = random.Random(n)
    p = spec.modulus
    vals = [0, 1, p - 1] + [rng.randrange(1, p) for _ in range(2 * n)]
    x = f.encode_ints(vals[: 2 * n]).reshape(n, 2, -1)
    for op in (fk.OP_MUL, fk.OP_ADD):
        for reverse in (False, True):
            before = fk.launches["field_scan"][spec.name]
            got = fk.scan(f, x, op, 0, reverse)
            assert fk.launches["field_scan"][spec.name] == before + 1
            assert torch.equal(got, fk.scan_plain(f, x, op, 0, reverse)), (op, reverse)
    for axis, a in ((0, x), (1, x.transpose(0, 1))):
        before = fk.launches["field_scan"][spec.name]
        assert torch.equal(f.sum(a, axis=axis), fk.sum_plain(f, a, axis)), axis
        assert fk.launches["field_scan"][spec.name] == before + 1
    assert torch.equal(f.powers(p - 1, n), fk.powers_plain(f, p - 1, n))
    assert torch.equal(f.powers(5, n), fk.powers_plain(f, 5, n))
    nz = f.encode_ints(vals[3 : 3 + n])
    before = fk.launches["field_scan"][spec.name]
    got = f.batch_inv(nz, host_inv=spec.inv)
    assert fk.launches["field_scan"][spec.name] == before + 2
    assert torch.equal(got, fk.batch_inv_plain(f, nz, spec.inv))
    assert f.decode_ints(got[:4]) == [pow(v, -1, p) for v in vals[3:7]][: min(4, n)]
    assert fk.kernel_attrs("field_scan")["local_bytes"] == 0


@pytest.mark.parametrize("spec", [FR, FQ, GOLDILOCKS], ids=lambda s: s.name)
def test_field_addsub_kernel_matches_plain(device, spec):
    """add, sub, neg and double against the plain versions: equal shapes, an
    (m,) table and one constant read by the modulo, a materialised
    broadcast, a slice off the 16-byte grid; one launch each; 0 spills."""
    from zktpu_torch.fields import field_kernel as fk
    from zktpu_torch.fields.fp import field

    f = field(spec, device)
    rng = random.Random(4)
    p = spec.modulus
    vals = [0, 1, p - 1] + [rng.randrange(p) for _ in range(3 * 1000 - 3)]
    A = f.encode_ints(vals).reshape(3, 1000, -1)
    B = torch.roll(A, 7, 1)
    for a, b in ((A, B), (A, B[1]), (A, B[2, 9]), (A[:, :1], B), (A[:, 1:], B[:, :-1])):
        for op, plain in ((f.add, fk.add_plain), (f.sub, fk.sub_plain)):
            before = fk.launches["field_addsub"][spec.name]
            got = op(a, b)
            assert fk.launches["field_addsub"][spec.name] == before + 1
            assert torch.equal(got, plain(f, a, b))
    assert torch.equal(f.neg(A), fk.sub_plain(f, torch.zeros_like(A), A))
    assert torch.equal(f.double(A), fk.add_plain(f, A, A))
    assert f.decode_ints(f.add(A[0, :3], A[0, :3])) == [2 * v % p for v in vals[:3]]
    assert fk.kernel_attrs("field_addsub")["local_bytes"] == 0


@pytest.mark.parametrize("log_n", [1, 2, 8, 11, 12, 16])
def test_ntt_goldilocks_kernel_matches_plain(device, log_n):
    """The Goldilocks design (ntt_gl.cuh): fft, ifft, coset_fft, coset_ifft
    and coset_fft with the raw-1 output factor (FRI's fused from_mont) on a
    batch of 3 (an all-zero row, a row of p - 1), one pass (n <= 2^11) and
    two; launches counted; 0 spills."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.poly import ntt_kernel
    from zktpu_torch.poly.domain import get_domain

    n = 1 << log_n
    f = field(GOLDILOCKS, device)
    rng = random.Random(50 + log_n)
    x = f.encode_ints([rng.randrange(GOLDILOCKS.modulus) for _ in range(3 * n)]).reshape(3, n, 2)
    x[0] = 0
    x[1] = f.encode_int(GOLDILOCKS.modulus - 1)
    dom = get_domain(GOLDILOCKS, n, device=device)
    g = GOLDILOCKS.generator
    for inverse, fin, fout in ((False, None, None), (True, None, None), (False, dom.offset_powers(g), None),
                               (True, None, dom._coset_out(g)), (False, dom.offset_powers(g), f._one_raw)):
        table = dom._inv_tw if inverse else dom._fwd_tw
        before = ntt_kernel.ntt.launches[GOLDILOCKS.name]
        got = ntt_kernel.ntt(x, table, inverse, fin, fout, GOLDILOCKS)
        assert ntt_kernel.ntt.launches[GOLDILOCKS.name] == before + (1 if log_n <= 11 else 2)
        want = ntt_kernel.ntt_plain(x, table, inverse, fin, fout, GOLDILOCKS)
        assert torch.equal(got, want), (inverse, fin is not None)
    assert ntt_kernel.kernel_attrs(GOLDILOCKS)["local_bytes"] == 0


@pytest.mark.parametrize("pairs", [False, True], ids=["single", "pairs"])
def test_hash_field_kernel_matches_plain(device, pairs):
    """Kernel 6 on every digit-length edge, 2^32 +- 1, p - 1 and random
    values (an odd count: a trailing singleton in pair mode, which takes a
    second launch), against its plain version on the card and hashlib; 0
    spills."""
    from zktpu_torch.fields.fp import ints_to_limbs
    from zktpu_torch.hash import host_hash
    from zktpu_torch.hash.sha256_kernel import hash_field, hash_field_plain, kernel_attrs

    p = GOLDILOCKS.modulus
    rng = random.Random(61)
    vals = [0, 2**32 - 1, 2**32, p - 1] + [v for k in range(1, 20) for v in (10**k - 1, 10**k)]
    vals += [rng.randrange(p) for _ in range(4097 - len(vals))]
    x = torch.from_numpy(ints_to_limbs(vals, 2)).to(device)
    before = hash_field.launches
    got = hash_field(x, pairs)
    assert hash_field.launches == before + (2 if pairs else 1)
    assert torch.equal(got, hash_field_plain(x, pairs))
    ints = got.cpu().numpy().view("<u8")[:, 0].tolist()
    if pairs:
        assert ints[:20] == [host_hash.hash_slice(GOLDILOCKS, vals[i : i + 2]) for i in range(0, 40, 2)]
        assert ints[-1] == host_hash.hash_elem(GOLDILOCKS, vals[-1])
    else:
        assert ints[:50] == [host_hash.hash_elem(GOLDILOCKS, v) for v in vals[:50]]
    assert kernel_attrs()["local_bytes"] == 0


@pytest.mark.parametrize("n", [1, 2, 7, 1 << 10, (1 << 19) + 1])
def test_fri_fold_kernel_matches_plain(device, n):
    """The fold kernel against its plain version: one coefficient, two, odd
    lengths (the last odd term 0; past 2^19, the first fold's size) and
    2^10, with 0 and p - 1 among the coefficients and as r; one launch each;
    0 spills."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fri import fold_kernel

    f = field(GOLDILOCKS, device)
    rng = random.Random(80 + n)
    vals = [rng.randrange(GOLDILOCKS.modulus) for _ in range(n)]
    vals[: min(n, 2)] = [0, GOLDILOCKS.modulus - 1][: min(n, 2)]
    c = f.encode_ints(vals)
    for r in (0, 1, GOLDILOCKS.modulus - 1, rng.randrange(GOLDILOCKS.modulus)):
        before = fold_kernel.fold.launches
        got = fold_kernel.fold(GOLDILOCKS, c, r)
        assert fold_kernel.fold.launches == before + 1
        assert torch.equal(got, fold_kernel.fold_plain(GOLDILOCKS, c, r))
    assert fold_kernel.kernel_attrs()["local_bytes"] == 0


def test_fri_proof_gpu_equals_cpu(device):
    """A 2^10-domain FRI proof made on the card (tensor NTT and vector hash
    at every layer) equals the CPU's on zktpu's tiers and verifies; the
    Goldilocks NTT, hash and fold launched, the product and add/sub did not
    (from_mont rides in the NTT, the fold is one kernel)."""
    from zktpu_torch.convert import fri_proof_to_ints
    from zktpu_torch.fields import field_kernel
    from zktpu_torch.fields.mont_kernel import mont_mul
    from zktpu_torch.fri.fold_kernel import fold
    from zktpu_torch.fri.prover import generate_proof
    from zktpu_torch.fri.verifier import verify
    from zktpu_torch.hash.sha256_kernel import hash_field
    from zktpu_torch.poly import ntt_kernel
    from zktpu_torch.poly.poly import Poly

    rng = random.Random(71)
    coeffs = [rng.randrange(GOLDILOCKS.modulus) for _ in range(1 << 9)]
    poly = Poly.from_ints(GOLDILOCKS, coeffs, device=device)
    counts = lambda: (ntt_kernel.ntt.launches[GOLDILOCKS.name], hash_field.launches, fold.launches)  # noqa: E731
    unused = lambda: (mont_mul.launches[GOLDILOCKS.name],  # noqa: E731
                      field_kernel.launches["field_addsub"][GOLDILOCKS.name])
    before, before_unused = counts(), unused()
    gpu = generate_proof(poly, 2, 8)
    assert all(b > a for a, b in zip(before, counts())), (before, counts())
    assert unused() == before_unused, (before_unused, unused())
    cpu = generate_proof(Poly.from_ints(GOLDILOCKS, coeffs, device="cpu"), 2, 8)
    assert fri_proof_to_ints(gpu) == fri_proof_to_ints(cpu)
    verify(gpu)


def test_matrix_vector_product_reads_z_in_place(device):
    """Nova's A z is one launch of the matvec kernel, which reads A and z in
    place: its only allocation is the (m, 8) output, with no (m, n, 8)
    temporary; it equals the plain product and axis-1 sum."""
    from zktpu_torch.fields import field_kernel
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_plain
    from zktpu_torch.nova.matvec_kernel import matvec
    from zktpu_torch.nova.utils import matrix_vector_product
    from zktpu_torch.tools.prof_nova import chain_r1cs

    f = field(FR, device)
    log_m = 9
    A = chain_r1cs(log_m, device).matrix_a
    m, n = A.shape[:2]
    rng = random.Random(9)
    z = f.encode_ints([rng.randrange(FR.modulus) for _ in range(n)])
    A[:, :, :] = f.encode_ints([rng.randrange(FR.modulus) for _ in range(m * n)]).reshape(m, n, 8)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launched, products = matvec.launches, mont_mul.launches[FR.name]
    got = matrix_vector_product(A, z)
    torch.cuda.synchronize()
    assert (matvec.launches, mont_mul.launches[FR.name]) == (launched + 1, products)
    assert torch.cuda.max_memory_allocated() - base <= m * 8 * 4 + (1 << 20)  # the (m, 8) output
    want = field_kernel.sum_plain(f, mont_mul_plain(FR, A, z[None]), 1)
    assert torch.equal(got, want)


def _fr_words(rng, count: int, device) -> torch.Tensor:
    """(count, 8) canonical Fr words, the words 0, 1 and p - 1 first."""
    from zktpu_torch.fields.fp import ints_to_limbs

    p = FR.modulus
    vals = ([0, 1, p - 1] + [rng.randrange(p) for _ in range(count)])[:count]
    return torch.from_numpy(ints_to_limbs(vals, 8)).to(device)


@pytest.mark.parametrize("m, n", [(1, 1), (3, 2), (5, 33), (9, (1 << 10) + 3)])
def test_matvec_kernel_matches_plain(device, m, n):
    """The matvec kernel against its plain version at the host test's shapes:
    m below and past a block's rows, n below a warp, past it, with a tail."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.nova.matvec_kernel import matvec, matvec_plain

    rng = random.Random(1000 * m + n)
    A, z = _fr_words(rng, m * n, device).reshape(m, n, 8), _fr_words(rng, n, device)
    before = matvec.launches
    got = matvec(A, z)
    assert matvec.launches == before + 1
    assert torch.equal(got, matvec_plain(field(FR, device), A, z))
    with pytest.raises(ValueError):
        matvec(A.cpu(), z.cpu())
    with pytest.raises(ValueError):
        matvec(A, z[:-1])


def test_matvec_kernel_all_p_minus_one(device):
    """Every word p - 1 at n = 4,099: each thread sums more products of
    (p - 1)^2 than 16 words hold, so the accumulator's 17th word carries."""
    from zktpu_torch.fields.fp import field, ints_to_limbs
    from zktpu_torch.nova.matvec_kernel import matvec, matvec_plain

    m, n = 6, 4099
    top = torch.from_numpy(ints_to_limbs([FR.modulus - 1], 8))[0].to(device)
    A, z = top.expand(m, n, 8).contiguous(), top.expand(n, 8).contiguous()
    got = matvec(A, z)
    assert torch.equal(got, matvec_plain(field(FR, device), A, z))
    want = (FR.modulus - 1) ** 2 * n * pow(FR.mont_r, -1, FR.modulus) % FR.modulus
    assert [int.from_bytes(r.astype("<u4").tobytes(), "little") for r in got.cpu().numpy()] == [want] * m


def test_nova_chain_gpu_equals_cpu(device):
    """A 2^5 squaring chain, 3 IVC steps with every tensor path forced
    (HOST_MSM_MAX = HOST_POLY_MAX = 0): the card's records, states and
    folded witness equal the CPU's; the product, sum, linear-combination
    (compute_t and the fold, which no longer launch the add/sub) and MSM
    kernels launched."""
    import zktpu_torch.config as cfg
    from zktpu_torch.kzg import KzgScheme, Srs
    from zktpu_torch.tools import launches
    from zktpu_torch.tools import prof_nova as pn

    log_m, steps = 5, 3
    inputs = pn.chain_inputs(steps, 11)
    saved = (cfg.HOST_MSM_MAX, cfg.HOST_POLY_MAX)
    cfg.HOST_MSM_MAX = cfg.HOST_POLY_MAX = 0
    runs = {}
    try:
        for dev in (device, torch.device("cpu")):
            launches.reset()
            r1cs = pn.chain_r1cs(log_m, dev)
            scheme = KzgScheme(Srs.new_from_secret(0x5EED5EED, (1 << log_m) + 3, device=dev))
            runs[dev.type] = pn.run_ivc(scheme, r1cs, pn.chain_circuit(), pn.chain_step_witness(log_m, inputs),
                                        steps, dev)
            if dev.type == "cuda":
                counts = launches.read()
                assert all(counts[k] > 0 for k in ("mont_mul_fr", "field_scan_fr", "field_lincomb",
                                                   "horner_combine", "proj_add")), counts
    finally:
        cfg.HOST_MSM_MAX, cfg.HOST_POLY_MAX = saved
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu["records"] == cpu["records"] and gpu["states"] == cpu["states"]
    assert torch.equal(gpu["folded"][0].e.cpu(), cpu["folded"][0].e)
    assert torch.equal(gpu["folded"][0].w.cpu(), cpu["folded"][0].w)
    assert gpu["states"][-1] == pn.host_final_state(log_m, inputs)


def test_parser_proof_on_the_card_equals_cpu(device):
    """tests/test_parser.py's equation parsed, compiled and proved on the
    card equals the CPU's proof; CPI's commitments on the card equal the
    CPU's."""
    from zktpu_torch.kzg import KzgScheme, Srs
    from zktpu_torch.plonk.cpi import CPIGenerator
    from zktpu_torch.plonk.parser import Parser
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.plonk.verifier import verify
    from zktpu_torch.transcript.chacha import StdRng

    eq = "x*y+3*x^2+x*y*z=11"
    proofs, cpis = {}, {}
    for dev in (device, torch.device("cpu")):
        p = Parser()
        for k, v in {"x": 1, "y": 2, "z": 3}.items():
            p.add_witness(k, v)
        compiled = p.parse(eq).compile(dev)
        srs = Srs.new_from_secret(31337, 20, device=dev)
        proofs[dev.type] = generate_proof(compiled, srs, rng=StdRng.from_seed_u64(5))
        verify(compiled, srs, proofs[dev.type])
        cpi = CPIGenerator().compute_common_preprocessed_input(eq, KzgScheme(srs))
        cpis[dev.type] = [cpi.com_q_lx, cpi.com_q_mx, cpi.com_s_sigma_3, cpi.n]
    assert proofs["cuda"] == proofs["cpu"]
    assert cpis["cuda"] == cpis["cpu"]


@pytest.mark.parametrize("window", [8, 4])
def test_fixed_base_kernel_matches_plain(device, window):
    """One launch per call; every projective word equals the plain loop's
    (the same adds in the same order), with the scalars 0, 1, r - 1 and
    2^256 - 1 among random ones; a few points equal host scalar
    multiplication; Srs.new_from_secret goes through the kernel."""
    from zktpu_torch.curves import g1, g1_kernel
    from zktpu_torch.kzg import Srs

    rng = random.Random(window)
    ints = [0, 1, FR.modulus - 1, (1 << 256) - 1] + [rng.getrandbits(256) for _ in range((1 << 12) + 1)]
    sc = g1.scalars_to_u32(ints, device=device)
    G = G1Affine.generator()
    tables = g1.fixed_base_tables(G, window, device)
    before = g1_kernel.fixed_base_mul.launches
    got = g1.fixed_base_mul_u32(G, sc, window)
    assert g1_kernel.fixed_base_mul.launches == before + 1
    want = g1_kernel.fixed_base_mul_plain(tables, sc, window)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert g1.proj_to_affine_host(tuple(t[:6] for t in got)) == [G.mul(k) for k in ints[:6]]
    before = g1_kernel.fixed_base_mul.launches
    Srs.new_from_secret(5, 4, device=device)
    assert g1_kernel.fixed_base_mul.launches == before + 1


def test_dist_world_1_matches_single_device(device):
    """zktpu_torch.dist on a world of one (NCCL, local_mesh): the four-step
    NTT, the sharded MSM, the sharded FRI layer and the wire commitments
    against their single-device counterparts."""
    import torch.distributed as tdist

    from zktpu_torch import dist as zd
    from zktpu_torch.curves import g1, msm
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fri.layer import FriLayer
    from zktpu_torch.kzg import KzgScheme, Srs
    from zktpu_torch.poly.domain import get_domain
    from zktpu_torch.poly.poly import Poly

    mesh = zd.local_mesh(device)
    try:
        assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "nccl")
        rng = random.Random(3)
        fr = field(FR, device)
        n = 1 << 10
        x = fr.encode_ints([rng.randrange(FR.modulus) for _ in range(n)])
        fs = zd.get_four_step(FR, n, mesh)
        dom = get_domain(FR, n, device)
        assert torch.equal(fs.fft(x), dom.fft(x, force_device=True))
        assert torch.equal(fs.ifft(x), dom.ifft(x, force_device=True))
        srs = Srs.new_from_secret(77, n, device=device)
        X, Y, Z = (a[:n] for a in srs.g1_proj)
        sc = g1.scalars_to_u32([rng.randrange(FR.modulus) for _ in range(n)], device=device)
        got = zd.msm_jacobian_sharded(sc, X, Y, Z, mesh=mesh, c=8)
        want = msm.msm_proj(sc, X, Y, Z, c=8)
        assert g1.proj_to_affine_host(tuple(a[None] for a in got)) == g1.proj_to_affine_host(
            tuple(a[None] for a in want))
        poly = Poly.from_ints(GOLDILOCKS, [rng.randrange(GOLDILOCKS.modulus) for _ in range(n // 2)], device=device)
        layer = zd.dist_fri_layer(poly, GOLDILOCKS.generator, n, mesh)
        single = FriLayer.from_poly(poly, GOLDILOCKS.generator, n)
        assert torch.equal(layer.evaluations, single.evaluations)
        assert layer.merkle_tree.internal_nodes == single.merkle_tree.internal_nodes
        nw = 1 << 8
        evals3 = torch.stack([fr.encode_ints([rng.randrange(FR.modulus) for _ in range(nw)]) for _ in range(3)])
        committer = zd.get_wire_committer(nw, mesh, c=4)
        wires = committer(evals3, *(a[:nw] for a in srs.g1_proj))
        blinds = [(rng.randrange(FR.modulus), rng.randrange(FR.modulus)) for _ in range(3)]
        blinded = committer.commit_blinded(evals3, srs, blinds)
        dw, scheme = get_domain(FR, nw, device), KzgScheme(srs)
        for i, (b_hi, b_lo) in enumerate(blinds):
            f = Poly(FR, dw.ifft(evals3[i], force_device=True))
            assert g1.proj_to_affine_host(tuple(a[None] for a in wires[i]))[0] == scheme.commit(f).point
            vanish = Poly.from_ints(FR, [b_lo, b_hi], device=device).mul_by_vanishing(nw)
            assert blinded[i] == scheme.commit(f + vanish).point
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("rows", [1, 8, 5, 1 << 10], ids=["one_row", "mask", "modulo", "mask_1024"])
def test_mont_mul_kernel_broadcast_periods(device, rows):
    """An operand of `rows` rows against (K, rows): one row read at 0, a
    power-of-two period by a mask, another by the modulo."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_plain

    f = field(FR, device)
    rng = random.Random(rows)
    p = FR.modulus
    A = f.encode_ints([p - 1, 0, 1] + [rng.randrange(p) for _ in range(12 * rows - 3)]).reshape(12, rows, -1)
    T = f.encode_ints([p - 1] + [rng.randrange(p) for _ in range(rows - 1)])
    assert torch.equal(mont_mul(FR, A, T), mont_mul_plain(FR, A, T))
    assert torch.equal(mont_mul(FR, T, A), mont_mul_plain(FR, T, A))


@pytest.mark.parametrize("case", ["compute_t", "fold_e", "w_ev_x", "eleven_terms"])
def test_lincomb_kernel_matches_plain(device, case):
    """field_lincomb against the plain chain at the sites' shapes (unequal
    lengths, scalars, a row-0 addend; past eight terms, two launches)."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.lincomb_kernel import lincomb, lincomb_plain

    f = field(FR, device)
    rng = random.Random(len(case))
    p = FR.modulus
    shapes = {"compute_t": ([(1 << 14, 1 << 14)] * 2 + [(1 << 14, 1)] * 2, []),
              "fold_e": ([(1 << 14, 1)] * 2, [1 << 14]),
              "w_ev_x": ([((1 << 14) + 5, 1)] * 3 + [(1 << 14, 1)] * 2, [(1 << 14) + 3, 1]),
              "eleven_terms": ([(100, 100), (7, 1), (300, 1)] * 3, [299, 1])}[case]

    def rows(n):
        return f.encode_ints([p - 1, 0, 1][:n] + [rng.randrange(p) for _ in range(n - 3)])

    products = [(rows(na), rows(nb), 1 if k % 2 else -1) for k, (na, nb) in enumerate(shapes[0])]
    addends = [(rows(nc), -1 if j else 1) for j, nc in enumerate(shapes[1])]
    before = lincomb.launches
    got = lincomb(f, products, addends)
    assert lincomb.launches == before + (2 if len(products) + len(addends) > 8 else 1)
    want = lincomb_plain(f, products, addends)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        lincomb(f, [(products[0][0].cpu(), products[0][1], 1)])
