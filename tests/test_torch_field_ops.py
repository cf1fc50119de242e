"""The field scans and the field add/sub (fields/field_kernel.py) against
zktpu's DeviceField, word for word.

On the CPU the TorchField ops run the plain versions of kernels A and B;
they must give zktpu's Montgomery words (repacked from 16-bit digits) for
cumprod and cumsum forward and reverse, sum on axis 0 and 1, powers,
batch_inv, add, sub and neg, over Fr and Fq, for n = 1, 2, 3, 17 and 64
rows of three columns with 0, 1 and p - 1 among the values.  All
comparisons are exact.
"""
import random

import numpy as np
import pytest
import torch

from zktpu.fields import host as zhost
from zktpu.fields.fp import device_field
from zktpu_torch.convert import digits_to_limbs
from zktpu_torch.fields.fp import field
from zktpu_torch.fields.host import FQ, FR

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

SPECS = [(FR, zhost.FR), (FQ, zhost.FQ)]
SIZES = [1, 2, 3, 17, 64]
ROWS = max(SIZES)
POWER_BASES = (0, 1, 7, -1)  # -1: p - 1
IDS = lambda v: v[0].name if isinstance(v, tuple) else str(v)  # noqa: E731


def _values(spec, count, seed, nonzero=False):
    rng = random.Random(seed)
    p = spec.modulus
    vals = [rng.randrange(p) for _ in range(count)]
    for i, v in enumerate((0, 1, p - 1)[:count]):
        vals[(7 * i + 3) % count] = v
    return [v or 1 for v in vals] if nonzero else vals


def _inputs(spec, n):
    """The (n, 3) scan and sum input and the (3, n) batch_inv input of size n."""
    return _values(spec, 3 * n, n), _values(spec, 3 * n, 90 + n, nonzero=True)


@pytest.fixture(scope="module", params=SPECS, ids=IDS)
def zk(request):
    """zktpu's results for every size at once, so that its jitted ops compile
    for one shape each: the (n, 3) inputs of all sizes side by side as
    columns of a (ROWS, 15) array, each padded with the op's identity (after
    the rows for a forward scan, before them for a reverse one, zeros for
    the sums), so every column's first (or last) n rows are its size's
    result; powers of as many rows (a count of n is the first n) and one
    batch inversion of every size's elements, padded to as many rows."""
    ours, theirs = request.param
    df = device_field(theirs)
    p = ours.modulus

    def grid(pad, at_end):
        cols = []
        for n in SIZES:
            vals = np.array(_inputs(ours, n)[0], dtype=object).reshape(n, 3)
            fill = np.full((ROWS - n, 3), pad, dtype=object)
            cols.append(np.concatenate([vals, fill] if at_end else [fill, vals]))
        g = np.concatenate(cols, axis=1)
        return df.encode_ints([int(v) for v in g.reshape(-1)]).reshape(ROWS, 3 * len(SIZES), -1)

    out = {"spec": ours}
    fwd1, rev1, zeros = grid(1, True), grid(1, False), grid(0, True)
    out["cumprod", False], out["cumprod", True] = df.cumprod(fwd1), df.cumprod(rev1, reverse=True)
    out["cumsum", False], out["cumsum", True] = df.cumsum(zeros), df.cumsum(grid(0, False), reverse=True)
    out["sum0"] = df.sum(zeros, axis=0)
    out["sum1"] = df.sum(zeros.transpose(1, 0, 2), axis=1)
    rows = ROWS * 3 * len(SIZES)
    out["powers"] = {z: df.powers(z % p, rows) for z in POWER_BASES}
    inv_in = [v for n in SIZES for v in _inputs(ours, n)[1]]
    inv_in += list(range(2, 2 + rows - len(inv_in)))
    out["batch_inv"] = df.batch_inv(df.encode_ints(inv_in), host_inv=theirs.inv)
    return out


def _column(res, n, reverse=False):
    """Size n's (n, 3, D) part of a (ROWS, 15, D) result."""
    j = SIZES.index(n)
    rows = slice(ROWS - n, ROWS) if reverse else slice(0, n)
    return np.asarray(res)[rows, 3 * j : 3 * j + 3]


def _same(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_array_equal(ours.numpy(), digits_to_limbs(np.asarray(theirs)))


@pytest.mark.parametrize("n", SIZES)
def test_scans_match_zktpu(zk, n):
    f = field(zk["spec"], "cpu")
    a = f.encode_ints(_inputs(zk["spec"], n)[0]).reshape(n, 3, -1)
    for reverse in (False, True):
        _same(f.cumprod(a, axis=0, reverse=reverse), _column(zk["cumprod", reverse], n, reverse))
        _same(f.cumsum(a, axis=0, reverse=reverse), _column(zk["cumsum", reverse], n, reverse))
    # along the middle axis of (3, n, L)
    got = f.cumsum(a.transpose(0, 1).contiguous(), axis=1, reverse=True)
    _same(got.transpose(0, 1), _column(zk["cumsum", True], n, True))


@pytest.mark.parametrize("n", SIZES)
def test_sum_on_both_axes_matches_zktpu(zk, n):
    f = field(zk["spec"], "cpu")
    a = f.encode_ints(_inputs(zk["spec"], n)[0]).reshape(n, 3, -1)
    j = SIZES.index(n)
    _same(f.sum(a, axis=0), np.asarray(zk["sum0"])[3 * j : 3 * j + 3])
    _same(f.sum(a.transpose(0, 1).contiguous(), axis=1), np.asarray(zk["sum1"])[3 * j : 3 * j + 3])  # evaluate_many's axis


@pytest.mark.parametrize("n", SIZES)
def test_powers_and_batch_inv_match_zktpu(zk, n):
    spec = zk["spec"]
    f = field(spec, "cpu")
    for z in POWER_BASES:
        _same(f.powers(z % spec.modulus, n), np.asarray(zk["powers"][z])[:n])
    a = f.encode_ints(_inputs(spec, n)[1]).reshape(3, n, -1)
    start = sum(3 * m for m in SIZES[: SIZES.index(n)])
    want = np.asarray(zk["batch_inv"])[start : start + 3 * n].reshape(3, n, -1)
    _same(f.batch_inv(a, host_inv=spec.inv), want)


def test_add_sub_neg_match_zktpu(zk):
    """Equal shapes, an (m,) table and one constant broadcast against (K, m),
    and every pairing of 0, 1 and p - 1."""
    spec = zk["spec"]
    f = field(spec, "cpu")
    df = device_field(zhost.FR if spec is FR else zhost.FQ)
    p = spec.modulus
    edge = [0, 1, p - 1]
    va, vb = [x for x in edge for _ in edge] + _values(spec, 6, 1), edge * 3 + _values(spec, 6, 2)
    a, b = (f.encode_ints(v).reshape(3, 5, -1) for v in (va, vb))
    ad, bd = (df.encode_ints(v).reshape(3, 5, -1) for v in (va, vb))
    for x, xd, y, yd in ((a, ad, b, bd), (a, ad, b[1], bd[1]), (a, ad, b[2, 4], bd[2, 4]), (b[0], bd[0], a, ad)):
        _same(f.add(x, y), df.add(xd, yd))
        _same(f.sub(x, y), df.sub(xd, yd))
    _same(f.neg(a), df.neg(ad))
    _same(f.double(a), df.double(ad))
