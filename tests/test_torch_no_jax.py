"""zktpu_torch runs without JAX and without zktpu, and never hides a missing
device or kernel."""
import functools
import importlib.util
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
from zktpu_torch.kzg import KzgScheme
from zktpu_torch.nova.nifs import NIFS, gen_test_values
from zktpu_torch.nova.r1cs import FWitness, is_r1cs_satisfied
from zktpu_torch.plonk.cpi import CPIGenerator
from zktpu_torch.plonk.parser import Parser
from zktpu_torch.tools import prof_nova
from zktpu_torch.transcript.transcripts import NovaTranscript
r1cs, ws, xs = gen_test_values([3, 4], device="cpu")
scheme = KzgScheme(Srs.new_from_secret(424242, 6, device="cpu"))
w = [FWitness.new(wi, 4, "cpu") for wi in ws]
u = [wi.commit(scheme, xi) for wi, xi in zip(w, xs)]
fw, fu, _, _ = NIFS.prover(r1cs, w[0], w[1], u[0], u[1], scheme, NovaTranscript())
is_r1cs_satisfied(r1cs, fu, fw, scheme)
chain = prof_nova.chain_r1cs(1, "cpu")
assert chain.matrix_a.shape == (2, 5, 8)
import torch
from zktpu_torch.fields.fp import field
from zktpu_torch.nova.matvec_kernel import matvec_plain
from zktpu_torch.nova.utils import matrix_vector_product
z = field(FR, "cpu").encode_ints([2, 3, 5, 7, 1])
assert torch.equal(matrix_vector_product(chain.matrix_a, z), matvec_plain(field(FR, "cpu"), chain.matrix_a, z))
parser = Parser()
parser.add_witness("x", 3)
parsed = parser.parse("x*x=9").compile(device="cpu")
assert CPIGenerator().compute_common_preprocessed_input("x*x=9", KzgScheme(srs)).n == parsed.size == 4
import os, runpy, tempfile
import torch
from zktpu_torch import compat, profiling
from zktpu_torch.dist import FourStepNTT, local_mesh
from zktpu_torch.fields.fp import field
from zktpu_torch.poly.domain import get_domain
with tempfile.TemporaryDirectory() as tmp:
    compat.save_srs(os.path.join(tmp, "srs.npz"), srs)
    assert compat.load_srs(os.path.join(tmp, "srs.npz"), device="cpu") == srs
    with profiling.maybe_trace("noop"):
        pass
mesh = local_mesh("cpu")
x = field(FR, "cpu").encode_ints(range(16))
assert torch.equal(FourStepNTT(FR, 16, mesh).fft(x), get_domain(FR, 16, "cpu").fft(x, force_device=True))
torch.distributed.destroy_process_group()
sys.argv = ["torch_fri_example.py", "--device", "cpu"]
runpy.run_path("examples/torch_fri_example.py", run_name="__main__")
loaded = sorted(m for m in sys.modules if m in ("jax", "zktpu") or m.startswith(("jax.", "jaxlib", "zktpu.")))
assert loaded == ["jax", "zktpu"] and sys.modules["jax"] is None and sys.modules["zktpu"] is None, loaded
print("proved, verified and ran msm_affine, FRI, a Nova fold, the parser, compat, dist and an example without "
      "jax or zktpu")
"""


def test_prove_and_verify_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-c", _PROVE_WITHOUT_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert ("proved, verified and ran msm_affine, FRI, a Nova fold, the parser, compat, dist and an example without "
            "jax or zktpu") in out.stdout


def test_no_jax_import_in_the_port():
    """No import of jax or of zktpu anywhere in the port, its examples or chip_smoke.py."""
    jax_import = re.compile(r"^\s*(import|from)\s+jax\b", re.MULTILINE)
    zktpu_import = re.compile(r"^\s*(import|from)\s+zktpu(\.|\s)", re.MULTILINE)
    examples = sorted((REPO / "examples").glob("torch_*_example.py"))
    names = ("dist_plonk", "fri", "kzg", "nova", "plonk")
    assert [p.name for p in examples] == [f"torch_{n}_example.py" for n in names]
    files = sorted((REPO / "zktpu_torch").rglob("*.py")) + examples + [REPO / "chip_smoke.py"]
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
    # the FRI fold kernel, and the NTT with the raw-1 output factor (FRI's fused from_mont)
    from zktpu_torch.fri.fold_kernel import fold

    for call in (lambda: fold(GOLDILOCKS, g, 5), lambda: fold(GOLDILOCKS, g[:7], 0),
                 lambda: ntt(g, g[:4], False, None, g[0], GOLDILOCKS)):
        with pytest.raises((ValueError, cuda_lib.KernelBuildError)):
            call()
    # the fixed-base multiply
    from zktpu_torch.curves.g1_kernel import fixed_base_mul

    table = torch.zeros((32, 256, 12), dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, cuda_lib.KernelBuildError)):
        fixed_base_mul((table, table, table), torch.zeros((4, 8), dtype=torch.int32, device="meta"), 8)
    # Nova's matrix-vector product: the kernel on a non-CPU tensor, and
    # matrix_vector_product, whose CPU branch is taken only for CPU tensors
    from zktpu_torch.nova.matvec_kernel import matvec
    from zktpu_torch.nova.utils import matrix_vector_product

    A = torch.zeros((2, 4, 8), dtype=torch.int32, device="meta")
    for call in (lambda: matvec(A, a), lambda: matrix_vector_product(A, a)):
        with pytest.raises((ValueError, cuda_lib.KernelBuildError)):
            call()
    with pytest.raises(ValueError):
        matvec(torch.zeros((2, 4, 8), dtype=torch.int32), torch.zeros((4, 8), dtype=torch.int32))


def _example(name: str):
    """examples/torch_<name>_example.py as a module (its main() not run)."""
    path = REPO / "examples" / f"torch_{name}_example.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    from zktpu_torch.tools import ntt_tiles, prof_fri, prof_mulkernels, prof_nova
    from zktpu_torch.nova.nifs import gen_test_values
    from zktpu_torch.nova.r1cs import FWitness
    from zktpu_torch.nova.utils import to_f_matrix, to_f_vec
    from zktpu_torch import compat
    from zktpu_torch import dist as zd
    from zktpu_torch.curves.host_curve import G1Affine

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
        lambda: ntt_tiles.main(["--field", "goldilocks"]),
        lambda: gen_test_values([3]),
        lambda: FWitness.new([1, 2], 2),
        lambda: FWitness.new_trivial_witness(2),
        lambda: to_f_matrix([[1, 0]]),
        lambda: to_f_vec([1]),
        lambda: prof_nova.chain_r1cs(2),
        lambda: prof_nova.main(["--log-m", "2", "--steps", "1"]),
        lambda: g1.fixed_base_mul(G1Affine.generator(), [1, 2]),
        lambda: compat.load_srs(str(REPO / "tests" / "goldens" / "compat_srs.npz")),
        lambda: zd.init(0, 1, 1),
        lambda: zd.local_mesh(),
        lambda: zd.spawn(len, 1),
        *(functools.partial(_example(name).main, []) for name in ("kzg", "plonk", "nova", "fri", "dist_plonk")),
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
