"""The port's tracing and sanitizer hooks (zktpu_torch/profiling.py) against
zktpu's (zktpu/profiling.py): ZKTPU_PROFILE writes a trace, and with
ZKTPU_DEBUG=1 the port's TorchField.decode_ints and g1.proj_to_affine_host
raise on a non-canonical word and on an off-curve point, with zktpu's
messages, where zktpu's own raise on the same words."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from zktpu_torch import profiling
from zktpu_torch.convert import limbs_to_digits
from zktpu_torch.curves import g1
from zktpu_torch.curves.host_curve import G1Affine
from zktpu_torch.fields.fp import field, ints_to_limbs
from zktpu_torch.fields.host import FQ, FR

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it


def test_maybe_trace_noop_when_unset_and_writes_a_trace_when_set(monkeypatch, tmp_path):
    monkeypatch.delenv("ZKTPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace("x"):
        pass
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("ZKTPU_PROFILE", str(tmp_path / "traces"))
    f = field(FR, "cpu")
    a = f.encode_ints([3, 5])
    with profiling.maybe_trace("fr_product"):
        assert f.decode_ints(f.mont_mul(a, a)) == [9, 25]
    (path,) = glob.glob(str(tmp_path / "traces" / "fr_product-*.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "fr_product" for e in events)


def test_debug_checks_disabled_by_default(monkeypatch):
    monkeypatch.delenv("ZKTPU_DEBUG", raising=False)
    profiling.check_canonical(FR, [FR.modulus + 1], "t")
    profiling.check_on_curve([G1Affine(1, 1)], "t")
    f = field(FR, "cpu")
    f.decode_ints(torch.from_numpy(ints_to_limbs([FR.modulus], 8)))  # an unreduced word passes unchecked
    one = field(FQ, "cpu").one
    g1.proj_to_affine_host(tuple(one[None] for _ in range(3)))  # (1 : 1 : 1) is off the curve


def _zk():
    """zktpu's G1, host fields and device fields (they read ZKTPU_DEBUG from the same environment)."""
    from zktpu.curves import g1 as zg1
    from zktpu.fields import host as zhost
    from zktpu.fields.fp import device_field

    return zg1, zhost, device_field


def test_decode_ints_sanitizer_matches_zktpu(monkeypatch):
    monkeypatch.setenv("ZKTPU_DEBUG", "1")
    zg1, zhost, device_field = _zk()
    f, zf = field(FR, "cpu"), device_field(zhost.FR)
    vals = [0, 1, FR.modulus - 1, 12345]
    assert f.decode_ints(f.encode_ints(vals)) == zf.decode_ints(zf.encode_ints(vals)) == vals
    words = f.encode_ints([7, 0, 8]).numpy().copy()
    words[1] = ints_to_limbs([FR.modulus + 3], 8)[0]  # an unreduced Montgomery word
    with pytest.raises(AssertionError) as ours:
        f.decode_ints(torch.from_numpy(words))
    with pytest.raises(AssertionError) as theirs:
        zf.decode_ints(np.asarray(limbs_to_digits(words)))
    want = f"ZKTPU_DEBUG: unreduced Montgomery value at [1]: {FR.modulus + 3:#x}"
    assert str(ours.value) == str(theirs.value) == want
    with pytest.raises(AssertionError, match="non-canonical"):
        profiling.check_canonical(FR, [FR.modulus], "bad")
    profiling.check_canonical(FR, [0, FR.modulus - 1], "ok")


def test_proj_to_affine_host_off_curve_matches_zktpu(monkeypatch):
    monkeypatch.setenv("ZKTPU_DEBUG", "1")
    zg1, _, _ = _zk()
    G = G1Affine.generator()
    fq = field(FQ, "cpu")
    on = g1.host_points_to_device([G, G1Affine.identity(), G.mul(5)], "cpu")
    assert g1.proj_to_affine_host(on) == [G, G1Affine.identity(), G.mul(5)]
    # (x, y) = (1, 1) in the middle row: off the curve
    bad = tuple(torch.cat([a[:1], r[None], a[1:]]) for a, r in zip(on, (fq.one, fq.one, fq.one)))
    with pytest.raises(AssertionError) as ours:
        g1.proj_to_affine_host(bad)
    import jax.numpy as jnp

    with pytest.raises(AssertionError) as theirs:
        zg1.proj_to_affine_host(tuple(jnp.asarray(limbs_to_digits(a.numpy())) for a in bad))
    assert str(ours.value) == str(theirs.value) == "ZKTPU_DEBUG: off-curve point at proj_to_affine_host[1]: x=0x1 y=0x1"
