"""The field hash (hash/sha256_kernel.py, hash/sha256_vec.py) against zktpu.

On the CPU the wrapper runs kernel 6's plain version: torch-built SHA-256
blocks, the compression in int64 lanes and the reference's Montgomery fold.
Held here, exactly, against zktpu's host hash (hashlib) at the digit-length
boundaries, its message words against zktpu's numpy block-building functions
(_blocks_single, _blocks_pairs: plain numpy, no JAX graph compiles), and
the bulk entry points against zktpu's hash_elem/hash_slice for Goldilocks
and for a field that hashes on the host.
"""
import numpy as np
import pytest
import torch

from zktpu.fields import host as z_host
from zktpu.hash import host_hash as z_hash
from zktpu.hash.sha256_vec import _blocks_pairs, _blocks_single
from zktpu_torch.fields.fp import ints_to_limbs
from zktpu_torch.fields.host import FR, GOLDILOCKS
from zktpu_torch.hash import sha256_kernel, sha256_vec

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

GL = GOLDILOCKS
P = GL.modulus


def _boundary_values() -> list[int]:
    """Every digit length's edges (10^k - 1, 10^k), 0, 2^32 +- 1, 2^63, p - 2,
    p - 1, and arbitrary values, in a fixed shuffle."""
    vals = [0, 2**32 - 1, 2**32, 2**63, P - 2, P - 1]
    for k in range(1, 20):
        vals += [10**k - 1, 10**k]
    rng = np.random.default_rng(21)
    vals += [int(v) for v in rng.integers(0, P, size=20, dtype=np.uint64)]
    return [vals[i] for i in rng.permutation(len(vals))]


VALUES = _boundary_values()


def _limbs(vals) -> torch.Tensor:
    return torch.from_numpy(ints_to_limbs(vals, 2))


def _ints(t: torch.Tensor) -> list[int]:
    return t.numpy().view("<u8")[:, 0].tolist()


def test_message_words_match_zktpu_blocks():
    """The padded blocks, word for word: single values and every pairing of
    the lengths (so the 0x80 byte lands at every offset up to 40)."""
    x = _limbs(VALUES)
    got = sha256_kernel.message_words(x)
    want = _blocks_single(np.array(VALUES, dtype=np.uint64))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    a = [v for v in VALUES for _ in range(3)]
    b = [VALUES[(7 * i + 1) % len(VALUES)] for i in range(len(a))]
    got = sha256_kernel.message_words(_limbs(a), _limbs(b))
    want = _blocks_pairs(np.array(a, dtype=np.uint64), np.array(b, dtype=np.uint64))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("pairs", [False, True], ids=["single", "pairs"])
def test_plain_field_hash_matches_zktpu_host_hash(pairs):
    """hash(x) for every value, or hash_slice of consecutive pairs with an
    odd count (the trailing singleton hashed alone)."""
    vals = VALUES if not pairs else VALUES[:-1] if len(VALUES) % 2 == 0 else VALUES
    got = _ints(sha256_kernel.hash_field(_limbs(vals), pairs))
    if pairs:
        want = [z_hash.hash_slice(z_host.GOLDILOCKS, vals[i : i + 2]) for i in range(0, len(vals), 2)]
    else:
        want = [z_hash.hash_elem(z_host.GOLDILOCKS, v) for v in vals]
    assert got == want


def test_bulk_entry_points_match_zktpu():
    """hash_elems_vec / hash_pairs_vec from ints (placed on the given device)
    and from tensors, Goldilocks; and a non-Goldilocks field, which hashes on
    the host and returns ints, as zktpu's does."""
    vals = VALUES[:24]
    want_e = [z_hash.hash_elem(z_host.GOLDILOCKS, v) for v in vals]
    want_p = [z_hash.hash_slice(z_host.GOLDILOCKS, vals[i : i + 2]) for i in range(0, len(vals), 2)]
    assert _ints(sha256_vec.hash_elems_vec(GL, vals, device="cpu")) == want_e
    assert _ints(sha256_vec.hash_pairs_vec(GL, _limbs(vals))) == want_p
    fr_vals = [0, 1, FR.modulus - 1, 2**200 + 7]
    assert sha256_vec.hash_elems_vec(FR, fr_vals) == [z_hash.hash_elem(z_host.FR, v) for v in fr_vals]
    odd = fr_vals[:3]
    assert sha256_vec.hash_pairs_vec(FR, odd) == [z_hash.hash_slice(z_host.FR, odd[i : i + 2]) for i in (0, 2)]


def test_hash_of_a_meta_tensor_never_runs_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel (which needs a
    CUDA device) or raises; the plain version runs for CPU tensors only."""
    from zktpu_torch import cuda_lib

    x = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    for pairs in (False, True):
        with pytest.raises((ValueError, cuda_lib.KernelBuildError)):
            sha256_kernel.hash_field(x, pairs)
