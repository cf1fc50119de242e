"""The plain versions of the mxu and f32 chained products
(fields/mont_kernel.py, fields/mont_mats.py) against zktpu, word for word.

zktpu's values are committed goldens (tests/goldens/mont_mma.npz, written
once by tests/goldens/make_goldens.py), so no JAX graph compiles here:
the mxu chain from mont_mul_pallas (interpret mode, the matrix-unit path
for D >= 16) chained CHAIN times, one product's m_cols and mp_cols from
RowOps._const_mxu, and the f32 chain and the two f32 accumulators of one
product from tools/prof_mulkernels.py's RowOpsF32, over Fr and Fq, on 256
elements from a numpy seed plus 0, 1 and p - 1.  The constant matrices are
held against zktpu's mont_matmats.  All comparisons are exact.
"""
import os

import numpy as np
import pytest
import torch

from zktpu_torch.fields.fp import field
from zktpu_torch.fields.host import FQ, FR, GOLDILOCKS
from zktpu_torch.fields.mont_kernel import (
    mont_mul_chain, mont_mul_chain_f32_plain, mont_mul_chain_mxu_plain, mont_mul_chain_plain, mont_mul_mxu_plain,
)
from zktpu_torch.fields.mont_mats import (
    MXU_MIN_DIGITS, core_tiles, kernel_mats, kernel_rows, mma_issued, mma_products, mont_matmats, tile_rows,
    used_blocks,
)

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "mont_mma.npz")
CHAIN = 12
N_RANDOM = 256
SPECS = [FR, FQ]
IDS = lambda s: s.name  # noqa: E731


def golden_inputs(spec):
    """The operands' values: 256 from numpy's default_rng, then 0, 1 and p - 1."""
    rng = np.random.default_rng(7 + spec.num_digits)
    p = spec.modulus
    nbytes = (p.bit_length() + 7) // 8 + 8
    a = [int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(N_RANDOM)] + [0, 1, p - 1]
    b = [int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(N_RANDOM)] + [p - 1, p - 1, 1]
    return a, b


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _operands(spec):
    f = field(spec, "cpu")
    a, b = golden_inputs(spec)
    return f.encode_ints(a), f.encode_ints(b)


def _g(goldens, spec, key):
    return torch.from_numpy(goldens[f"{spec.name}/{key}"].astype(np.int64))


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_operands_match_goldens(goldens, spec):
    a, b = _operands(spec)
    assert torch.equal(a, _g(goldens, spec, "a").to(torch.int32))
    assert torch.equal(b, _g(goldens, spec, "b").to(torch.int32))


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_mxu_chain_plain_matches_zktpu(goldens, spec):
    """CHAIN plain mxu products == mont_mul_pallas chained CHAIN times, and
    the base plain chain gives the same words (the bodies compute one function)."""
    a, b = _operands(spec)
    got = mont_mul_chain_mxu_plain(spec, a, b, CHAIN)
    want = _g(goldens, spec, "mxu_chain").to(torch.int32)
    assert torch.equal(got, want)
    assert torch.equal(mont_mul_chain(spec, a, b, CHAIN, "mxu"), want)
    assert torch.equal(mont_mul_chain_plain(spec, a, b, CHAIN), want)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_f32_chain_plain_matches_zktpu(goldens, spec):
    a, b = _operands(spec)
    got = mont_mul_chain_f32_plain(spec, a, b, CHAIN)
    want = _g(goldens, spec, "f32_chain").to(torch.int32)
    assert torch.equal(got, want)
    assert torch.equal(mont_mul_chain(spec, a, b, CHAIN, "f32"), want)


@pytest.mark.parametrize("variant", ["mxu", "f32"])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_intermediates_match_zktpu(goldens, spec, variant):
    """One product's constant-convolution columns (RowOps._const_mxu) and,
    for f32, its two accumulators (RowOpsF32.conv_full's accA and accB)."""
    a, b = _operands(spec)
    parts = {}
    mont_mul_mxu_plain(spec, a, b, variant, parts)
    assert torch.equal(parts["m_cols"], _g(goldens, spec, "m_cols"))
    assert torch.equal(parts["mp_cols"], _g(goldens, spec, "mp_cols"))
    if variant == "f32":
        assert torch.equal(parts["accA"], _g(goldens, spec, "accA"))
        assert torch.equal(parts["accB"], _g(goldens, spec, "accB"))


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_constant_matrices_match_zktpu(goldens, spec):
    """mont_matmats entry for entry, and the kernel's layout is the same
    matrices: natural byte order, weight-1 and weight-256 columns
    interleaved, staged as wgmma's K-major core matrices (8 rows x 16 bytes,
    128 contiguous bytes each: byte k of row n at [n // 8, k // 16, n % 8,
    k % 16])."""
    mats = mont_matmats(spec)
    assert torch.equal(mats, _g(goldens, spec, "matmats"))
    D = spec.num_digits
    kp = 32 * -(-2 * D // 32)
    r = np.arange(2 * D)
    block = np.where(r % 2 == 0, r // 2, D + r // 2)  # natural byte r -> block-order row
    qmat, pmat = kernel_mats(spec)
    for km, rows, (A, B), S in ((qmat, kernel_rows(spec)[0], (mats[0], mats[1]), D),
                                (pmat, kernel_rows(spec)[1], (mats[2], mats[3]), 2 * D)):
        assert km.shape == (2 * S // 8, kp // 16, 8, 16) and km.flags.c_contiguous
        assert np.array_equal(tile_rows(km), rows)
        flat = km.reshape(-1)
        for n, k in ((0, 0), (2 * S - 1, 2 * D - 1), (9, 17), (2 * S - 3, 31)):
            assert flat[(n // 8) * 128 * (kp // 16) + (k // 16) * 128 + (n % 8) * 16 + k % 16] == rows[n, k]
        assert np.array_equal(core_tiles(rows), km)
        assert np.array_equal(rows[0::2, : 2 * D], A[:S].numpy()[:, block])
        assert np.array_equal(rows[1::2, : 2 * D], B[:S].numpy()[:, block])
        assert not rows[:, 2 * D:].any()


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_skipped_blocks_are_zero(spec):
    """The blocks outside the band hold only zeros; the band's 16 x 8 x 32
    blocks per 16 elements: Fq 26 of 36, Fr 12 of 12, and the u8
    multiply-accumulates the kernel issues an element (whole N ranges): Fq
    9,216 against the band's 6,656, Fr 3,072."""
    D = spec.num_digits
    for km, S in zip(map(tile_rows, kernel_mats(spec)), (D, 2 * D)):
        used = set(used_blocks(spec, S))
        for j in range(S // 4):
            for ks in range(km.shape[1] // 32):
                if (j, ks) not in used:
                    assert not km[8 * j : 8 * j + 8, 32 * ks : 32 * ks + 32].any(), (S, j, ks)
    assert mma_products(spec) == {FQ.name: 26, FR.name: 12}[spec.name]
    assert mma_issued(spec) == {FQ.name: 9216, FR.name: 3072}[spec.name]
    assert mma_products(spec) * 256 <= mma_issued(spec)


def test_goldilocks_raises():
    """Goldilocks (D = 4) is below zktpu's MXU_MIN_DIGITS = 16."""
    g = field(GOLDILOCKS, "cpu").encode_ints([1, 2])
    assert GOLDILOCKS.num_digits < MXU_MIN_DIGITS
    for variant in ("mxu", "f32"):
        with pytest.raises(ValueError, match="MXU_MIN_DIGITS"):
            mont_mul_chain(GOLDILOCKS, g, g, 2, variant)
    with pytest.raises(ValueError, match="MXU_MIN_DIGITS"):
        mont_matmats(GOLDILOCKS)
    with pytest.raises(ValueError, match="variant"):
        mont_mul_chain(FR, g, g, 2, "bf16")
