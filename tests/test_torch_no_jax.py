"""zktpu_torch runs without JAX and without zktpu, and never hides a missing
device or kernel."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from zktpu_torch import cuda_lib

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROVE_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None  # any import of jax or zktpu now raises ImportError
sys.modules["zktpu"] = None
from zktpu_torch.curves import g1, msm
from zktpu_torch.curves.host_curve import G1Affine
from zktpu_torch.kzg import Srs
from zktpu_torch.plonk.circuit import Circuit
from zktpu_torch.plonk.prover import generate_proof
from zktpu_torch.plonk.verifier import verify
from zktpu_torch.transcript.chacha import StdRng
c = Circuit()
c.add_multiplication_gate((1, 0, 3), (0, 0, 3), (0, 3, 9), 0)
c.add_multiplication_gate((1, 1, 4), (0, 1, 4), (1, 3, 16), 0)
c.add_multiplication_gate((1, 2, 5), (0, 2, 5), (2, 3, 25), 0)
c.add_addition_gate((2, 0, 9), (2, 1, 16), (2, 2, 25), 0)
compiled = c.compile(device="cpu")
from zktpu_torch.fields.host import FR
srs_order = FR.modulus
srs = Srs.new_from_secret(1234567, compiled.size, device="cpu")
verify(compiled, srs, generate_proof(compiled, srs, StdRng.from_seed_u64(42)))
Xa, Ya = srs.g1_affine()  # the SRS's first 5 points, tau^i G, in an affine MSM
R = msm.msm_affine(g1.scalars_to_u32([3, 0, 5, 1, 9], device="cpu"), Xa[:5], Ya[:5], c=4)
assert g1.proj_to_affine_host(tuple(a[None] for a in R)) == [G1Affine.generator().mul(
    sum(s * pow(1234567, i, srs_order) for i, s in enumerate([3, 0, 5, 1, 9])))]
from zktpu_torch.fields.host import GOLDILOCKS
from zktpu_torch.fri.prover import generate_proof as fri_prove
from zktpu_torch.fri.verifier import verify as fri_verify
from zktpu_torch.poly.poly import Poly
fri_verify(fri_prove(Poly.from_ints(GOLDILOCKS, [1, 2, 3, 4, 5], device="cpu"), 2, 2, force_device=True))
loaded = sorted(m for m in sys.modules if m in ("jax", "zktpu") or m.startswith(("jax.", "jaxlib", "zktpu.")))
assert loaded == ["jax", "zktpu"] and sys.modules["jax"] is None and sys.modules["zktpu"] is None, loaded
print("proved, verified and ran msm_affine and FRI without jax or zktpu")
"""


def test_prove_and_verify_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-c", _PROVE_WITHOUT_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "proved, verified and ran msm_affine and FRI without jax or zktpu" in out.stdout


def test_no_jax_import_in_the_port():
    """No import of jax or of zktpu anywhere in the port or chip_smoke.py."""
    jax_import = re.compile(r"^\s*(import|from)\s+jax\b", re.MULTILINE)
    zktpu_import = re.compile(r"^\s*(import|from)\s+zktpu(\.|\s)", re.MULTILINE)
    files = sorted((REPO / "zktpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert [str(p.relative_to(REPO)) for p in files if jax_import.search(p.read_text())] == []
    via_zktpu = [str(p.relative_to(REPO)) for p in files if zktpu_import.search(p.read_text())]
    assert via_zktpu == []


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_lib, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_lib, "library_path", lambda: str(tmp_path / "libzktpu_kernels.so"))
    with pytest.raises(cuda_lib.KernelBuildError, match="nvcc"):
        cuda_lib.build()


def test_kernel_load_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cuda_lib.load.cache_clear()
    with pytest.raises(cuda_lib.KernelBuildError, match="CUDA device"):
        cuda_lib.load()


def test_wrapper_on_a_non_cpu_tensor_launches_or_raises():
    """A tensor that is not on the CPU never reaches the plain version."""
    from zktpu_torch.curves.g1_kernel import proj_madd
    from zktpu_torch.fields.host import FQ, FR
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_chain

    a = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, cuda_lib.KernelBuildError)):
        mont_mul(FR, a, a)
    a = torch.zeros((4, 12), dtype=torch.int32, device="meta")
    for variant in ("base", "mxu", "f32"):
        with pytest.raises((ValueError, cuda_lib.KernelBuildError)):
            mont_mul_chain(FQ, a, a, 12, variant)
    with pytest.raises((ValueError, cuda_lib.KernelBuildError)):
        proj_madd((a, a, a), (a, a))
    # kernels A and B (fields/field_kernel.py) through the field's ops
    from zktpu_torch.fields import field_kernel
    from zktpu_torch.fields.fp import field

    f = field(FQ, "cpu")
    for call in (lambda: field_kernel.add(f, a, a), lambda: field_kernel.sub(f, a, a),
                 lambda: field_kernel.scan(f, a, field_kernel.OP_MUL), lambda: field_kernel.field_sum(f, a),
                 lambda: field_kernel.batch_inv(f, a, FQ.inv)):
        with pytest.raises((ValueError, cuda_lib.KernelBuildError)):
            call()
    # the Goldilocks NTT and the field hash (kernels 1g and 6)
    from zktpu_torch.fields.host import GOLDILOCKS
    from zktpu_torch.hash.sha256_kernel import hash_field
    from zktpu_torch.poly.ntt_kernel import ntt

    g = torch.zeros((8, 2), dtype=torch.int32, device="meta")
    for call in (lambda: ntt(g, g[:4], False, spec=GOLDILOCKS), lambda: hash_field(g, False),
                 lambda: hash_field(g, True)):
        with pytest.raises((ValueError, cuda_lib.KernelBuildError)):
            call()


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """device=None means the current CUDA device; without one each entry point
    raises and names it, and never falls back to the CPU."""
    from zktpu_torch import bench
    from zktpu_torch.curves import g1
    from zktpu_torch.fields.fp import NoCudaDeviceError
    from zktpu_torch.fields.host import FR
    from zktpu_torch.kzg import Srs
    from zktpu_torch.plonk.circuit import Circuit
    from zktpu_torch.plonk.synthetic import synthetic_mul_chain
    from zktpu_torch.poly.domain import Radix2Domain, get_domain
    from zktpu_torch.poly.poly import Poly
    from zktpu_torch.fields.host import GOLDILOCKS
    from zktpu_torch.fri.merkle import MerkleTree
    from zktpu_torch.hash import sha256_vec
    from zktpu_torch.tools import prof_fri, prof_mulkernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    circuit = Circuit()
    circuit.add_multiplication_gate((1, 0, 3), (0, 0, 3), (0, 3, 9), 0)
    circuit.add_multiplication_gate((1, 1, 4), (0, 1, 4), (1, 3, 16), 0)
    circuit.add_multiplication_gate((1, 2, 5), (0, 2, 5), (2, 3, 25), 0)
    circuit.add_addition_gate((2, 0, 9), (2, 1, 16), (2, 2, 25), 0)
    calls = [
        circuit.compile,
        lambda: synthetic_mul_chain(2),
        lambda: Srs.new_from_secret(5, 4),
        lambda: Srs.new(4),
        lambda: Radix2Domain(FR, 8),
        lambda: get_domain(FR, 8),
        lambda: Poly.from_ints(FR, [1, 2]),
        lambda: Poly.zero(FR),
        lambda: Poly.constant(FR, 3),
        lambda: g1.proj_identity((2,)),
        lambda: g1.host_points_to_device([]),
        lambda: g1.scalars_to_u32([1]),
        lambda: bench.main(["--log-n", "4"]),
        lambda: prof_mulkernels.main(["16"]),
        lambda: prof_mulkernels.main(["16", "mxu"]),
        lambda: prof_mulkernels.main(["16", "f32"]),
        lambda: Poly.from_ints(GOLDILOCKS, [1, 2]),
        lambda: sha256_vec.hash_elems_vec(GOLDILOCKS, [1, 2]),
        lambda: MerkleTree([1, 2, 3], GOLDILOCKS, force_device=True),
        lambda: prof_fri.main(["--log-n", "4"]),
    ]
    for call in calls:
        with pytest.raises(NoCudaDeviceError, match="CUDA device"):
            call()


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke would run for real")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr
