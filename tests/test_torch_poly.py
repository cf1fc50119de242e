"""zktpu_torch NTT and dense polynomials vs zktpu's host transform and host ints."""
import random

import pytest
import torch

import zktpu_torch.config as cfg
from zktpu.fields import host
from zktpu.poly.domain import get_domain as zktpu_domain
from zktpu_torch.fields.fp import field
from zktpu_torch.poly.domain import get_domain
from zktpu_torch.poly.poly import Poly, evaluate_many, poly_from_evals

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

FR = host.FR
P = FR.modulus


@pytest.mark.parametrize("spec", [host.FR, host.GOLDILOCKS], ids=lambda s: s.name)
@pytest.mark.parametrize("log_n", range(1, 9))
def test_transforms_match_zktpu_host_transform(spec, log_n):
    n = 1 << log_n
    rng = random.Random(log_n)
    vals = [rng.randrange(spec.modulus) for _ in range(n)]
    ref = zktpu_domain(spec, n)
    dom = get_domain(spec, n, device="cpu")
    f = field(spec, "cpu")
    x = f.encode_ints(vals)
    assert f.decode_ints(dom.fft(x, force_device=True)) == ref._host_transform(vals, inverse=False)
    assert f.decode_ints(dom.ifft(x, force_device=True)) == ref._host_transform(vals, inverse=True)
    # coset transforms: evaluations of sum c_i X^i on g <w>
    g = spec.generator
    want = ref._host_transform([v * pow(g, i, spec.modulus) % spec.modulus for i, v in enumerate(vals)], False)
    evals = dom.coset_fft(x, g)
    assert f.decode_ints(evals) == want
    assert f.decode_ints(dom.coset_ifft(evals, g)) == vals
    assert f.decode_ints(dom.elements_device()) == ref.elements_ints()


@pytest.mark.parametrize("log_n", range(1, 9))
def test_transforms_match_zktpu_host_transform_batched_factors(log_n):
    """ntt_plain (what the NTT kernel is held against) on a batch of 3, with
    the factors the domain fuses into the kernel: offset^i on the input
    (coset_fft), 1/n and 1/n offset^-i on the output (ifft, coset_ifft)."""
    from zktpu_torch.poly import ntt_kernel

    spec, n = host.FR, 1 << log_n
    rng = random.Random(100 + log_n)
    rows = [[rng.randrange(P) for _ in range(n)] for _ in range(3)]
    rows[1][0] = P - 1
    ref = zktpu_domain(spec, n)
    dom = get_domain(spec, n, device="cpu")
    f = field(spec, "cpu")
    x = f.encode_ints([v for r in rows for v in r]).reshape(3, n, 8)
    g, g_inv = spec.generator, pow(spec.generator, -1, P)

    def decoded(t):
        flat = f.decode_ints(t)
        return [flat[i * n:(i + 1) * n] for i in range(3)]

    def scaled(r, o):
        return [v * pow(o, i, P) % P for i, v in enumerate(r)]

    got = ntt_kernel.ntt_plain(x, dom._fwd_tw, False, in_factor=dom.offset_powers(g))
    assert decoded(got) == [ref._host_transform(scaled(r, g), False) for r in rows]
    got = ntt_kernel.ntt_plain(x, dom._inv_tw, True)
    assert decoded(got) == [ref._host_transform(r, True) for r in rows]
    got = ntt_kernel.ntt_plain(x, dom._inv_tw, True, out_factor=dom._coset_out(g))
    assert decoded(got) == [scaled(ref._host_transform(r, True), g_inv) for r in rows]
    assert torch.equal(dom.coset_ifft(dom.coset_fft(x, g, force_device=True), g), x)


def _ints(poly):
    return poly.to_ints()


def _host_mul(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % P
    return out


def _trim(v):
    while v and v[-1] == 0:
        v = v[:-1]
    return v


@pytest.fixture(params=["host_tier", "tensor_tier"])
def tier(request, monkeypatch):
    if request.param == "tensor_tier":
        monkeypatch.setattr(cfg, "HOST_NTT_MAX", 0)
        monkeypatch.setattr(cfg, "HOST_POLY_MAX", 0)
    return request.param


def test_poly_ops_match_host_ints(tier):
    rng = random.Random(11)
    a = [rng.randrange(P) for _ in range(21)]
    b = [rng.randrange(P) for _ in range(9)] + [0, 0]  # trailing zeros are trimmed
    pa, pb = Poly.from_ints(FR, a, device="cpu"), Poly.from_ints(FR, b, device="cpu")
    assert len(pb) == 9 and pb.degree == 8
    assert _ints(pa + pb) == [(x + y) % P for x, y in zip(a, b + [0] * 12)]
    assert _ints(pa - pb) == [(x - y) % P for x, y in zip(a, b + [0] * 12)]
    assert _ints(pb - pb) == [] and (pb - pb).degree == 0
    assert _ints(-pa) == [(-x) % P for x in a]
    assert _ints(pa * pb) == _host_mul(a, b[:9])
    assert _ints(pa.scale(5)) == [5 * x % P for x in a]
    assert _ints(pb.shift(3)) == [0, 0, 0] + b[:9]
    assert _ints(pb.mul_by_vanishing(4)) == _trim(
        [((b[i - 4] if 4 <= i < 13 else 0) - (b[i] if i < 9 else 0)) % P for i in range(13)]
    )
    z = rng.randrange(P)
    assert pa.evaluate(z) == sum(c * pow(z, i, P) for i, c in enumerate(a)) % P
    assert evaluate_many([pa, pb, Poly.zero(FR, device="cpu")], z) == [pa.evaluate(z), pb.evaluate(z), 0]


def test_divisions_match_host_ints(tier):
    rng = random.Random(12)
    n = 8
    q = [rng.randrange(P) for _ in range(19)]
    r = [rng.randrange(P) for _ in range(5)]
    # p = q (X^n - 1) + r
    num = Poly.from_ints(FR, q, device="cpu").mul_by_vanishing(n) + Poly.from_ints(FR, r, device="cpu")
    qq, rr = num.divide_by_vanishing(n)
    assert _ints(qq) == q and _ints(rr) == r
    z = rng.randrange(P)
    c = [rng.randrange(P) for _ in range(30)]
    pc = Poly.from_ints(FR, c, device="cpu")
    quo, rem = pc.divide_by_linear(z)
    assert rem == pc.evaluate(z)
    lin = Poly.from_ints(FR, [(-z) % P, 1], device="cpu")
    assert (quo * lin + Poly.constant(FR, rem, device="cpu")) == pc
    quo0, rem0 = pc.divide_by_linear(0)
    assert rem0 == c[0] and _ints(quo0) == c[1:]


def test_large_evaluate_and_poly_from_evals():
    rng = random.Random(13)
    c = [rng.randrange(P) for _ in range(300)]  # above the host Horner tier
    pc = Poly.from_ints(FR, c, device="cpu")
    z = rng.randrange(P)
    want = sum(x * pow(z, i, P) for i, x in enumerate(c)) % P
    assert pc.evaluate(z) == want
    assert evaluate_many([pc, pc.scale(2)], z) == [want, 2 * want % P]
    dom = get_domain(FR, 16, device="cpu")
    f = field(FR, "cpu")
    vals = [rng.randrange(P) for _ in range(16)]
    interp = poly_from_evals(dom, f.encode_ints(vals))
    assert [interp.evaluate(w) for w in dom.elements_ints()] == vals
