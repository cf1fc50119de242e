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
    a row of p - 1), one pass (n <= 2^9, one tile) and two; launches
    counted; 0 spills."""
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
        assert ntt_kernel.ntt.launches[FR.name] == before + (1 if log_n <= 9 else 2)
        assert torch.equal(got, ntt_kernel.ntt_plain(x, table, inverse, fin, fout)), (inverse, fin is not None)
    assert ntt_kernel.kernel_attrs()["local_bytes"] == 0


@pytest.mark.parametrize("W,K,c", [(4, 1, 16), (3, 8, 13), (2, 9, 3), (1, 2, 4)])
def test_horner_combine_kernel_matches_plain(device, W, K, c):
    """One launch against the plain loop, with an identity among the parts,
    K past one warp's eight points, and W = 1."""
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
    and batch_inv against their plain versions: one block (products up to
    ONE_BLOCK_MAX_MUL rows, adds up to ONE_BLOCK_MAX_ADD) and three passes;
    launches counted; 0 spills."""
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
            one_block = fk.ONE_BLOCK_MAX_MUL if op == fk.OP_MUL else fk.ONE_BLOCK_MAX_ADD
            assert fk.launches["field_scan"][spec.name] == before + (1 if n <= one_block else 3)
            assert torch.equal(got, fk.scan_plain(f, x, op, 0, reverse)), (op, reverse)
    for axis, a in ((0, x), (1, x.transpose(0, 1))):
        assert torch.equal(f.sum(a, axis=axis), fk.sum_plain(f, a, axis)), axis
    assert torch.equal(f.powers(p - 1, n), fk.powers_plain(f, p - 1, n))
    assert torch.equal(f.powers(5, n), fk.powers_plain(f, 5, n))
    nz = f.encode_ints(vals[3 : 3 + n])
    before = fk.launches["field_scan"][spec.name]
    got = f.batch_inv(nz, host_inv=spec.inv)
    assert fk.launches["field_scan"][spec.name] == before + (2 if n <= fk.ONE_BLOCK_MAX_MUL else 4)
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
    """The L = 2 instance: fft, ifft, coset_fft and coset_ifft on a batch of
    3 (an all-zero row, a row of p - 1), one pass (n <= 2^10) and two;
    launches counted; 0 spills."""
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
                               (True, None, dom._coset_out(g))):
        table = dom._inv_tw if inverse else dom._fwd_tw
        before = ntt_kernel.ntt.launches[GOLDILOCKS.name]
        got = ntt_kernel.ntt(x, table, inverse, fin, fout, GOLDILOCKS)
        assert ntt_kernel.ntt.launches[GOLDILOCKS.name] == before + (1 if log_n <= 10 else 2)
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


def test_fri_proof_gpu_equals_cpu(device):
    """A 2^10-domain FRI proof made on the card (tensor NTT and vector hash
    at every layer) equals the CPU's on zktpu's tiers and verifies; the
    Goldilocks NTT, hash, product and add/sub launched."""
    from zktpu_torch.convert import fri_proof_to_ints
    from zktpu_torch.fields import field_kernel
    from zktpu_torch.fields.mont_kernel import mont_mul
    from zktpu_torch.fri.prover import generate_proof
    from zktpu_torch.fri.verifier import verify
    from zktpu_torch.hash.sha256_kernel import hash_field
    from zktpu_torch.poly import ntt_kernel
    from zktpu_torch.poly.poly import Poly

    rng = random.Random(71)
    coeffs = [rng.randrange(GOLDILOCKS.modulus) for _ in range(1 << 9)]
    counts = lambda: (ntt_kernel.ntt.launches[GOLDILOCKS.name], hash_field.launches,  # noqa: E731
                      mont_mul.launches[GOLDILOCKS.name], field_kernel.launches["field_addsub"][GOLDILOCKS.name])
    before = counts()
    gpu = generate_proof(Poly.from_ints(GOLDILOCKS, coeffs, device=device), 2, 8)
    assert all(b > a for a, b in zip(before, counts())), (before, counts())
    cpu = generate_proof(Poly.from_ints(GOLDILOCKS, coeffs, device="cpu"), 2, 8)
    assert fri_proof_to_ints(gpu) == fri_proof_to_ints(cpu)
    verify(gpu)
