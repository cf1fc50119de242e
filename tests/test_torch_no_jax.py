"""zktpu_torch runs without JAX, and never hides a missing device or kernel."""
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
sys.modules["jax"] = None  # any import of jax now raises ImportError
from zktpu_torch.kzg import Srs
from zktpu_torch.plonk.circuit import Circuit
from zktpu_torch.plonk.prover import generate_proof
from zktpu_torch.plonk.verifier import verify
from zktpu_torch.shared import StdRng
c = Circuit()
c.add_multiplication_gate((1, 0, 3), (0, 0, 3), (0, 3, 9), 0)
c.add_multiplication_gate((1, 1, 4), (0, 1, 4), (1, 3, 16), 0)
c.add_multiplication_gate((1, 2, 5), (0, 2, 5), (2, 3, 25), 0)
c.add_addition_gate((2, 0, 9), (2, 1, 16), (2, 2, 25), 0)
compiled = c.compile(device="cpu")
srs = Srs.new_from_secret(1234567, compiled.size, device="cpu")
verify(compiled, srs, generate_proof(compiled, srs, StdRng.from_seed_u64(42)))
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
print("proved and verified without jax")
"""


def test_prove_and_verify_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-c", _PROVE_WITHOUT_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "proved and verified without jax" in out.stdout


def test_no_jax_import_in_the_port():
    """No jax import anywhere in the port; zktpu's host layer only through
    zktpu_torch/shared.py."""
    jax_import = re.compile(r"^\s*(import|from)\s+jax\b", re.MULTILINE)
    zktpu_import = re.compile(r"^\s*(import|from)\s+zktpu(\.|\s)", re.MULTILINE)
    files = sorted((REPO / "zktpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert [str(p.relative_to(REPO)) for p in files if jax_import.search(p.read_text())] == []
    via_zktpu = [str(p.relative_to(REPO)) for p in files if zktpu_import.search(p.read_text())]
    assert via_zktpu == ["zktpu_torch/shared.py"]


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
    from zktpu.fields.host import FR
    from zktpu_torch.fields.mont_kernel import mont_mul

    a = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, cuda_lib.KernelBuildError)):
        mont_mul(FR, a, a)


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
