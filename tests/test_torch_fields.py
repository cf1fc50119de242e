"""zktpu_torch field layer vs zktpu: equal Montgomery words, equal integers.

The plain Montgomery product (the CPU side of kernel 1) is held word for word
against zktpu's jnp product (a committed golden, tests/goldens/mont_mul_words.npz,
written by tests/goldens/make_goldens.py mont_mul_words), and every
TorchField op against host ints, for Fr, Fq and Goldilocks.  All comparisons
are exact.
"""
import os
import random

import numpy as np
import pytest
import torch

from zktpu.fields import host
from zktpu_torch.convert import digits_to_limbs, limbs_to_digits
from zktpu_torch.fields.fp import field, limbs_to_ints
from zktpu_torch.fields.limbs import resolve
from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_plain

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

SPECS = [host.FR, host.FQ, host.GOLDILOCKS]
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "mont_mul_words.npz")


def _operands(spec, n=300, seed=17):
    rng = random.Random(seed)
    p = spec.modulus
    a = [rng.randrange(p) for _ in range(n)]
    b = [rng.randrange(p) for _ in range(n)]
    a[:3] = [0, 1, p - 1]
    b[:3] = [p - 1, p - 1, p - 1]
    return a, b


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mont_mul_matches_zktpu_words(spec):
    a, b = _operands(spec)
    with np.load(GOLDEN) as g:  # zktpu's encode_ints of a and b, and their _mont_mul_jnp
        ad, bd, want = (g[f"{spec.name}/{k}"] for k in ("a", "b", "want"))
    A = torch.from_numpy(digits_to_limbs(ad))
    B = torch.from_numpy(digits_to_limbs(bd))
    got = mont_mul(spec, A, B)
    np.testing.assert_array_equal(limbs_to_digits(got.numpy()), want)
    # the port's own encoding gives the same words as zktpu's
    f = field(spec, "cpu")
    np.testing.assert_array_equal(f.encode_ints(a).numpy(), A.numpy())
    np.testing.assert_array_equal(f.encode_ints(b).numpy(), B.numpy())


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_field_ops_match_host_ints(spec):
    f = field(spec, "cpu")
    p = spec.modulus
    a, b = _operands(spec, seed=23)
    A, B = f.encode_ints(a), f.encode_ints(b)
    assert f.decode_ints(f.mont_mul(A, B)) == [x * y % p for x, y in zip(a, b)]
    assert f.decode_ints(f.add(A, B)) == [(x + y) % p for x, y in zip(a, b)]
    assert f.decode_ints(f.sub(A, B)) == [(x - y) % p for x, y in zip(a, b)]
    assert f.decode_ints(f.neg(A)) == [(-x) % p for x in a]
    assert f.decode_ints(f.double(A)) == [2 * x % p for x in a]
    assert f.decode_int(f.sum(A, axis=0)) == sum(a) % p
    assert limbs_to_ints(f.to_u32_limbs(A).numpy()) == a
    raw = torch.from_numpy(np.array([[v >> (32 * i) & 0xFFFFFFFF for i in range(f.num_limbs)] for v in a[:20]], dtype=np.uint32).view(np.int32))
    assert limbs_to_ints(f.from_mont(f.to_mont(raw)).numpy()) == a[:20]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_scans_powers_batch_inv_match_host(spec):
    f = field(spec, "cpu")
    p = spec.modulus
    a, _ = _operands(spec, n=37, seed=5)
    A = f.encode_ints(a)
    prefix, acc = [], 1
    for x in a:
        acc = acc * x % p
        prefix.append(acc)
    assert f.decode_ints(f.cumprod(A)) == prefix
    suffix, acc = [], 1
    for x in reversed(a):
        acc = acc * x % p
        suffix.append(acc)
    assert f.decode_ints(f.cumprod(A, reverse=True)) == suffix[::-1]
    assert f.decode_ints(f.cumsum(A)) == [sum(a[: i + 1]) % p for i in range(len(a))]
    assert f.decode_ints(f.powers(7, 33)) == [pow(7, i, p) for i in range(33)]
    nz = a[3:]  # no zeros
    inv = f.batch_inv(f.encode_ints(nz).reshape(2, 17, -1), host_inv=spec.inv)
    assert inv.shape == (2, 17, f.num_limbs)
    assert f.decode_ints(inv) == [pow(x, -1, p) for x in nz]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mont_mul_broadcasts(spec):
    f = field(spec, "cpu")
    p = spec.modulus
    a, b = _operands(spec, n=15, seed=9)
    A = f.encode_ints(a).reshape(3, 5, -1)
    row = f.encode_ints(b[:5])  # (5, L) against (3, 5, L)
    got = f.decode_ints(f.mont_mul(A, row))
    assert got == [x * b[i % 5] % p for i, x in enumerate(a)]
    one = f.encode_int(b[0])  # (L,)
    assert f.decode_ints(mont_mul_plain(spec, A, one)) == [x * b[0] % p for x in a]


@pytest.mark.parametrize("bits", [16, 32])
def test_carry_resolution_layouts_agree(bits):
    """Both scan layouts of limbs.resolve (the outer one runs on CUDA) equal a
    sequential ripple."""
    v = torch.from_numpy(np.random.default_rng(bits).integers(0, 1 << (bits + 1), size=(3, 50, 9)))
    v[:, ::2, 1:5] = (1 << bits) - 1  # propagate runs
    v[:, ::3, 0] = 1 << bits  # generate into them
    want, carry = v.clone(), torch.zeros(v.shape[:-1], dtype=torch.int64)
    for i in range(v.shape[-1]):
        s = want[..., i] + carry
        want[..., i], carry = s & ((1 << bits) - 1), s >> bits
    for outer in (False, True):
        got, top = resolve(v, bits, outer=outer)
        assert torch.equal(got, want) and torch.equal(top.to(torch.int64), carry)


def test_digit_limb_round_trip():
    rng = np.random.default_rng(3)
    digits = rng.integers(0, 1 << 16, size=(7, 24), dtype=np.uint32)
    limbs = digits_to_limbs(digits)
    assert limbs.dtype == np.int32 and limbs.shape == (7, 12)
    np.testing.assert_array_equal(limbs_to_digits(limbs), digits)
    v = limbs.view(np.uint32)
    np.testing.assert_array_equal(v, digits[:, 0::2] | (digits[:, 1::2] << 16))
