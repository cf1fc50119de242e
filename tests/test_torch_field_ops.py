"""The field scans and the field add/sub (fields/field_kernel.py) against
zktpu's DeviceField, word for word.

On the CPU the TorchField ops run the plain versions of kernels A and B;
they must give zktpu's Montgomery words (repacked from 16-bit digits) for
cumprod and cumsum forward and reverse, sum on axis 0 and 1, powers,
batch_inv, add, sub and neg, over Fr and Fq, for n = 1, 2, 3, 17 and 64
rows of three columns with 0, 1 and p - 1 among the values.  zktpu's words
are committed goldens (tests/goldens/field_ops.npz, written once by
tests/goldens/make_goldens.py), so no JAX graph compiles here.  All
comparisons are exact.
"""
import os
import random

import numpy as np
import pytest
import torch

from zktpu_torch.fields.fp import field
from zktpu_torch.fields.host import FQ, FR

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "field_ops.npz")
SPECS = [FR, FQ]
SIZES = [1, 2, 3, 17, 64]
ROWS = max(SIZES)
POWER_BASES = (0, 1, 7, -1)  # -1: p - 1
IDS = lambda v: v.name if hasattr(v, "name") else str(v)  # noqa: E731


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


def _add_sub_values(spec):
    """The add/sub test's operand values: every pairing of 0, 1 and p - 1, then six others."""
    p = spec.modulus
    edge = [0, 1, p - 1]
    return [x for x in edge for _ in edge] + _values(spec, 6, 1), edge * 3 + _values(spec, 6, 2)


def _add_sub_operands(a, b):
    """Equal shapes, an (m,) table and one constant broadcast against (K, m), and the reverse."""
    return (a, b), (a, b[1]), (a, b[2, 4]), (b[0], a)


@pytest.fixture(scope="module", params=SPECS, ids=IDS)
def zk(request):
    """zktpu's DeviceField results on this module's inputs, from
    tests/goldens/field_ops.npz (written by tests/goldens/make_goldens.py
    from zktpu, repacked as (..., L) int32 limbs): key "<name>_<n>" or
    "<op>_<k>" within this field."""
    spec = request.param
    with np.load(GOLDEN) as g:
        out = {k.split("/", 1)[1]: g[k] for k in g.files if k.startswith(spec.name + "/")}
    out["spec"] = spec
    return out


def _same(ours: torch.Tensor, theirs: np.ndarray) -> None:
    np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("n", SIZES)
def test_scans_match_zktpu(zk, n):
    f = field(zk["spec"], "cpu")
    a = f.encode_ints(_inputs(zk["spec"], n)[0]).reshape(n, 3, -1)
    for reverse in (False, True):
        way = "rev" if reverse else "fwd"
        _same(f.cumprod(a, axis=0, reverse=reverse), zk[f"cumprod_{way}_{n}"])
        _same(f.cumsum(a, axis=0, reverse=reverse), zk[f"cumsum_{way}_{n}"])
    # along the middle axis of (3, n, L)
    got = f.cumsum(a.transpose(0, 1).contiguous(), axis=1, reverse=True)
    _same(got.transpose(0, 1), zk[f"cumsum_rev_{n}"])


@pytest.mark.parametrize("n", SIZES)
def test_sum_on_both_axes_matches_zktpu(zk, n):
    f = field(zk["spec"], "cpu")
    a = f.encode_ints(_inputs(zk["spec"], n)[0]).reshape(n, 3, -1)
    _same(f.sum(a, axis=0), zk[f"sum0_{n}"])
    _same(f.sum(a.transpose(0, 1).contiguous(), axis=1), zk[f"sum1_{n}"])  # evaluate_many's axis


@pytest.mark.parametrize("n", SIZES)
def test_powers_and_batch_inv_match_zktpu(zk, n):
    spec = zk["spec"]
    f = field(spec, "cpu")
    for z in POWER_BASES:
        _same(f.powers(z % spec.modulus, n), zk[f"powers_{z}"][:n])
    a = f.encode_ints(_inputs(spec, n)[1]).reshape(3, n, -1)
    _same(f.batch_inv(a, host_inv=spec.inv), zk[f"batch_inv_{n}"])


def test_add_sub_neg_match_zktpu(zk):
    """Equal shapes, an (m,) table and one constant broadcast against (K, m),
    and every pairing of 0, 1 and p - 1."""
    spec = zk["spec"]
    f = field(spec, "cpu")
    a, b = (f.encode_ints(v).reshape(3, 5, -1) for v in _add_sub_values(spec))
    for k, (x, y) in enumerate(_add_sub_operands(a, b)):
        _same(f.add(x, y), zk[f"add_{k}"])
        _same(f.sub(x, y), zk[f"sub_{k}"])
    _same(f.neg(a), zk["neg"])
    _same(f.double(a), zk["double"])
