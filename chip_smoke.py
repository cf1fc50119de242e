#!/usr/bin/env python3
"""Run the zktpu_torch main path once on one CUDA GPU and check it.

    python3 chip_smoke.py [--log-n 14]

Phases, one line each:
  1. device: the card's name and power limit (fails without CUDA);
  2. kernels: builds csrc/ and holds each CUDA kernel against its plain
     PyTorch version on the card, bit for bit (mont_mul for Fr, Fq and
     Goldilocks at N = 2^16 + 3 with the edge values 0, 1, p - 1; proj_add and
     proj_double at N = 2^14 + 5 with identity, P + P, P + (-P) and padding
     lanes), with both times;
  3. small proof: a 4-gate circuit proved with every tensor path forced,
     once on the GPU and once on the CPU; the proofs must be equal;
  4. main path: synthetic_mul_chain(log_n) and its SRS on the GPU, prove,
     verify, and reject a tampered proof; every kernel must have launched.
Then one JSON line with the kernels, the card's name and power limit, and
the final {"ok": true, ...} line.  Any failure raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 20261016
SRS_SECRET = 0x5EED5EED


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare(name: str, got, want) -> int:
    """Mismatching 32-bit words between kernel and plain outputs (asserts 0)."""
    got, want = (torch.cat([t.reshape(-1) for t in x]) for x in (got, want))
    diff = (got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64) & 0xFFFFFFFF)
    bad = int((diff != 0).sum())
    assert bad == 0, f"{name}: {bad} words differ from the plain version"
    return int(diff.abs().max()) if diff.numel() else 0


def phase_kernels(device) -> dict:
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.g1_kernel import proj_add, proj_add_plain, proj_double, proj_double_plain
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_plain
    from zktpu_torch.shared import FQ, FR, GOLDILOCKS, G1Affine

    rng = random.Random(SEED)
    results = {}
    n = (1 << 16) + 3
    for spec, key in ((FR, "mont_mul_fr"), (FQ, "mont_mul_fq"), (GOLDILOCKS, "mont_mul_goldilocks")):
        f = field(spec, device)
        p = spec.modulus
        a = [0, 1, p - 1, p - 1] + [rng.randrange(p) for _ in range(n - 4)]
        b = [p - 1, p - 1, p - 1, 1] + [rng.randrange(p) for _ in range(n - 4)]
        A, B = f.encode_ints(a), f.encode_ints(b)
        err = _compare(key, [mont_mul(spec, A, B)], [mont_mul_plain(spec, A, B)])
        assert f.decode_ints(mont_mul(spec, A[:8], B[:8])) == [x * y % p for x, y in zip(a[:8], b[:8])]
        ms = _cuda_ms(lambda: mont_mul(spec, A, B), 50)
        plain_ms = _cuda_ms(lambda: mont_mul_plain(spec, A, B), 5)
        results[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "n": n}
        print(f"phase 2: {key} n={n} mismatches=0 kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)

    # points: a host chain (i + 1) G, lifted to general Z by one plain add
    n = (1 << 14) + 5
    G = G1Affine.generator()
    chain, cur = [], G
    for _ in range(n):
        chain.append(cur)
        cur = cur + G
    A = g1.host_points_to_device(chain, device)
    perm = torch.tensor([(7 * i + 3) % n for i in range(n)], device=A[0].device)
    B = tuple(t[perm] for t in A)
    fq = field(FQ, device)
    P1 = proj_add_plain(A, B)
    P2 = proj_double_plain(B)
    ident = g1.proj_identity((), device)
    # the plain versions return limb-major strided planes on CUDA (fields/limbs.py);
    # contiguous copies keep the wrapper's own copy out of the kernel's time
    P1 = [t.clone(memory_format=torch.contiguous_format) for t in P1]
    P2 = [t.clone(memory_format=torch.contiguous_format) for t in P2]
    for i in range(3):  # lane 0: O + Q; lane 1: P + P; lane 2: P + (-P); lane 3: O + O
        P1[i][0] = ident[i]
        P2[i][1] = P1[i][1]
        P2[i][2] = P1[i][2] if i != 1 else fq.neg(P1[1][2])
        P1[i][3] = ident[i]
        P2[i][3] = ident[i]
        P1[i][4] = 0  # lane 4: all-zero padding maps to all zero
        P2[i][4] = 0
    host_p1 = g1.proj_to_affine_host(tuple(t[:4] for t in P1))
    host_p2 = g1.proj_to_affine_host(tuple(t[:4] for t in P2))
    got = proj_add(P1, P2)
    err = _compare("proj_add", got, proj_add_plain(P1, P2))
    assert g1.proj_to_affine_host(tuple(t[:4] for t in got)) == [x + y for x, y in zip(host_p1, host_p2)]
    assert all(int(t[4].abs().sum()) == 0 for t in got)
    ms = _cuda_ms(lambda: proj_add(P1, P2), 20)
    plain_ms = _cuda_ms(lambda: proj_add_plain(P1, P2), 3)
    results["proj_add"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "n": n}
    print(f"phase 2: proj_add n={n} mismatches=0 kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)

    got = proj_double(P1)
    err = _compare("proj_double", got, proj_double_plain(P1))
    assert g1.proj_to_affine_host(tuple(t[:4] for t in got)) == [x + x for x in host_p1]
    ms = _cuda_ms(lambda: proj_double(P1), 20)
    plain_ms = _cuda_ms(lambda: proj_double_plain(P1), 3)
    results["proj_double"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "n": n}
    print(f"phase 2: proj_double n={n} mismatches=0 kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
    return results


def _pythagorean_circuit():
    from zktpu_torch.plonk.circuit import Circuit

    c = Circuit()
    c.add_multiplication_gate((1, 0, 3), (0, 0, 3), (0, 3, 9), 0)
    c.add_multiplication_gate((1, 1, 4), (0, 1, 4), (1, 3, 16), 0)
    c.add_multiplication_gate((1, 2, 5), (0, 2, 5), (2, 3, 25), 0)
    c.add_addition_gate((2, 0, 9), (2, 1, 16), (2, 2, 25), 0)
    return c


def phase_small_proof(device) -> None:
    """The same proof with every tensor path forced, on the GPU and the CPU."""
    import zktpu_torch.config as cfg
    from zktpu_torch.kzg import Srs
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.plonk.verifier import verify
    from zktpu_torch.shared import StdRng

    saved = (cfg.HOST_MSM_MAX, cfg.HOST_NTT_MAX, cfg.HOST_POLY_MAX)
    cfg.HOST_MSM_MAX = cfg.HOST_NTT_MAX = cfg.HOST_POLY_MAX = 0
    try:
        proofs, secs = {}, {}
        for dev in (device, torch.device("cpu")):
            t0 = time.perf_counter()
            compiled = _pythagorean_circuit().compile(device=dev)
            srs = Srs.new_from_secret(SRS_SECRET, compiled.size, device=dev)
            proofs[dev.type] = generate_proof(compiled, srs, StdRng.from_seed_u64(SEED), force="coset")
            verify(compiled, srs, proofs[dev.type])
            secs[dev.type] = time.perf_counter() - t0
    finally:
        cfg.HOST_MSM_MAX, cfg.HOST_NTT_MAX, cfg.HOST_POLY_MAX = saved
    assert proofs["cuda"] == proofs["cpu"], "GPU proof differs from the CPU proof"
    print(
        f"phase 3: 4-gate proof, tensor paths forced: GPU proof == CPU proof, both verify "
        f"(gpu {secs['cuda']:.2f} s, cpu {secs['cpu']:.2f} s)",
        flush=True,
    )


def phase_main(device, log_n: int) -> dict:
    from zktpu_torch.curves.g1_kernel import proj_add, proj_double
    from zktpu_torch.fields.mont_kernel import mont_mul
    from zktpu_torch.kzg import Srs
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.plonk.synthetic import synthetic_mul_chain
    from zktpu_torch.plonk.verifier import PlonkVerificationError, verify
    from zktpu_torch.shared import FQ, FR, StdRng

    counters = (mont_mul.launches, proj_add, proj_double)
    for name in mont_mul.launches:
        mont_mul.launches[name] = 0
    proj_add.launches = proj_double.launches = 0

    t0 = time.perf_counter()
    circuit = synthetic_mul_chain(log_n, seed=1, device=device)
    srs = Srs.new_from_secret(SRS_SECRET, circuit.size, device=device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    timings = {}
    t0 = time.perf_counter()
    proof = generate_proof(circuit, srs, StdRng.from_seed_u64(SEED), timings=timings)
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify(circuit, srs, proof)
    t_verify = time.perf_counter() - t0
    launches = {
        "mont_mul_fr": counters[0][FR.name],
        "mont_mul_fq": counters[0][FQ.name],
        "proj_add": proj_add.launches,
        "proj_double": proj_double.launches,
    }
    assert all(v > 0 for v in launches.values()), f"a kernel of the path never launched: {launches}"

    proof.bar_a = FR.add(proof.bar_a, 1)
    try:
        verify(circuit, srs, proof)
    except PlonkVerificationError:
        pass
    else:
        raise AssertionError("a tampered proof was accepted")

    rounds = {k: round(v, 4) for k, v in timings.items() if "." in k}
    print(
        f"phase 4: main path 2^{log_n} gates (SRS {srs.size} points, 8n coset 2^{log_n + 3}): "
        f"setup {t_setup:.3f} s, prove {t_prove:.3f} s, verify {t_verify:.3f} s; "
        f"proof verifies, tampered proof rejected",
        flush=True,
    )
    print(f"phase 4: rounds {json.dumps(rounds)}", flush=True)
    print(f"phase 4: launches {json.dumps(launches)}", flush=True)
    return launches


_SOURCES = {
    "mont_mul_fr": ("zktpu_torch/csrc/mont_mul.cu", "zktpu/fields/pallas_mont.py:363"),
    "mont_mul_fq": ("zktpu_torch/csrc/mont_mul.cu", "zktpu/fields/pallas_mont.py:363"),
    "proj_add": ("zktpu_torch/csrc/g1.cu", "zktpu/curves/pallas_g1.py:125"),
    "proj_double": ("zktpu_torch/csrc/g1.cu", "zktpu/curves/pallas_g1.py:211"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=14, help="log2 of the main-path circuit size")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from zktpu_torch import cuda_lib
    from zktpu_torch.shared import pairing_backend

    device = torch.device("cuda", 0)
    smi = _smi()
    print(f"phase 1: device {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    cuda_lib.build(verbose=True)  # ptxas register and spill counts go to stderr
    print(f"phase 1: kernels built from zktpu_torch/csrc in {time.perf_counter() - t0:.1f} s "
          f"-> {os.path.relpath(cuda_lib.library_path())}", flush=True)
    print(f"phase 1: pairing backend {pairing_backend()}", flush=True)

    kernels = phase_kernels(device)
    phase_small_proof(device)
    launches = phase_main(device, args.log_n)

    rows = []
    for name, (source, replaces) in _SOURCES.items():
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
