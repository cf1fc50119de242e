"""Time the NTT kernel's designs, and count the SASS of its butterflies.

    python -m zktpu_torch.tools.ntt_tiles [--reps 30] [--field fr|goldilocks] [--parent DIR] [--sass]

csrc/ntt.cu hard-codes its designs.  Fr (ntt.cuh): the largest call
(batch x n elements) that takes radix-2 steps (larger ones take radix 4),
the largest tile of a multi-pass plan, its columns, the largest transform
done in one pass, the minimum of blocks per SM that the launch bound asks
for (which caps the registers) and the fewest threads of a multi-pass
block (-DZK_NTT_RADIX2_WORK, -DZK_NTT_LOG_TILE, -DZK_NTT_LOG_COLS,
-DZK_NTT_ONE_PASS, -DZK_NTT_MIN_BLOCKS, -DZK_NTT_LOG_MIN_THREADS).
Goldilocks (ntt_gl.cuh): the radix, the largest tile, the columns of a
multi-pass tile, the largest transform done in one pass and the minimum of
blocks per SM (-DZK_NTT_GL_RADIX, -DZK_NTT_GL_LOG_TILE,
-DZK_NTT_GL_LOG_COLS, -DZK_NTT_GL_ONE_PASS, -DZK_NTT_GL_MIN_BLOCKS).  For
each design in DESIGNS (Fr) or GL_DESIGNS (Goldilocks) this tool builds its
own copy of ntt.cu (one nvcc per design, in parallel, into
build/zktpu_torch/), launches it through the port's wrapper at the paths'
shapes (Fr: the PLONK prover's transforms and the four-step NTT's local
ones, SHAPES, and 2^20 x 1; Goldilocks: coset transforms at 2^16, 2^20 and
2^22, batch 1, and 2^13 x 3), checks that it gives the library's words,
and prints one JSON line per design and shape: registers, local bytes
(spills), launches, ms per call with CUDA events (wrapper included),
kernel-only ms per call (torch.profiler) and the share of the bound (Fr:
also of the products the design issues, ntt_kernel.fr_products).

--parent DIR also loads another checkout's package (a `git archive` of an
earlier commit unpacked under build/; tools/parent.py) and times its NTT
the same way (its design as that tree builds it), before the designs and
again after them at each shape, so that two designs are compared in turns
inside one run on one card.  --sass prints the SASS instructions per
butterfly of one radix-4 step of the Fr design and of its product beside
field.cuh's (fr_butterfly_sass), or of one Goldilocks radix step
(butterfly_sass).
"""
from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import subprocess

import torch

from zktpu_torch import cuda_lib
from zktpu_torch.fields.host import FR, GOLDILOCKS
from zktpu_torch.poly import ntt_kernel
from zktpu_torch.poly.domain import Radix2Domain

# Fr: (log2 of the largest call in radix-2 steps, log2 largest tile, log2
# columns, largest log n in one pass, minimum blocks per SM, log2 fewest
# threads of a multi-pass block); the library's is (16, 10, 1, 10, 2, 6).
# A tile of 2^10 elements takes 40 KB of shared memory with its padding,
# its table 16-32 KB; a block has 2^(log tile - log2 radix) threads.  The
# radix cut on either side of the library's (radix 4 everywhere, radix 2 up
# to 2^17 and everywhere) and the thread floor below and above it (half a
# warp, one warp, 4 warps).
DESIGNS = ((16, 10, 1, 10, 2, 6), (0, 10, 1, 10, 2, 6), (17, 10, 1, 10, 2, 6), (30, 10, 1, 10, 2, 6),
           (16, 10, 1, 10, 2, 4), (16, 10, 1, 10, 2, 5), (16, 10, 1, 10, 2, 7))
# (log n, batch): the PLONK prover's coset transforms at 2^14 gates (8n x 7,
# 4n x 9, 4n x 2), its coset divisions (8n x 1), poly_from_evals (n x 3,
# n x 1), the four-step NTT's local transforms at 2^22 (2^11 x 2048), and
# the 2^20 transform
SHAPES = ((17, 7), (16, 9), (16, 2), (17, 1), (14, 3), (14, 1), (11, 2048), (20, 1))
# Goldilocks: (log2 radix, log2 largest tile, log2 columns, largest log n in
# one pass, minimum blocks per SM); the library's is (3, 13, 3, 11, 1).  A
# tile of 2^12 words takes 32 KB of shared memory, 2^13 64 KB, plus the
# twiddle table; a block has 2^(log tile - radix) <= 1024 threads.
GL_DESIGNS = ((3, 13, 3, 11, 1), (3, 13, 2, 11, 1), (3, 13, 4, 11, 1), (3, 13, 3, 13, 1), (3, 13, 3, 11, 2),
              (4, 13, 3, 11, 1), (2, 12, 3, 11, 1), (2, 12, 2, 11, 1))
GL_SHAPES = ((16, 1), (20, 1), (22, 1), (13, 3))
GL_FLAGS = ("ZK_NTT_GL_RADIX", "ZK_NTT_GL_LOG_TILE", "ZK_NTT_GL_LOG_COLS", "ZK_NTT_GL_ONE_PASS",
            "ZK_NTT_GL_MIN_BLOCKS")
FR_FLAGS = ("ZK_NTT_RADIX2_WORK", "ZK_NTT_LOG_TILE", "ZK_NTT_LOG_COLS", "ZK_NTT_ONE_PASS", "ZK_NTT_MIN_BLOCKS",
            "ZK_NTT_LOG_MIN_THREADS")
# NVIDIA H100 SXM: 32-bit integer multiply-adds, 64 per clock per SM x 132
# SMs x 1.98 GHz; HBM3 at 3.35 TB/s.  An Fr product is 2 x (2 L^2 + L)
# multiply-adds; a Goldilocks one 8 (field.cuh's gl_mul: four word products).
IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def _product_imads(spec) -> int:
    if spec is GOLDILOCKS:
        return 8
    L = spec.num_digits // 2
    return 2 * (2 * L * L + L)


def bound_ms(spec, log_n: int, batch: int) -> dict:
    """The least time of a transform of `batch` rows of 2^log_n (with an
    input factor for Goldilocks, FRI's coset transform): its products'
    multiply-adds over the integer rate, or its bytes (each input and output
    row once, the n/2 twiddles and the factor table once) over HBM."""
    n, gl = 1 << log_n, spec is GOLDILOCKS
    products = batch * ((n // 2) * log_n + (n if gl else 0))
    ops_s = products * _product_imads(spec) / IMAD_PER_S
    nbytes = (2 * batch * n + n // 2 + (n if gl else 0)) * 4 * (spec.num_digits // 2)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3, "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def build_designs(designs, spec=FR) -> dict:
    """{design: path} of ntt.cu built once per design, all nvcc at once."""
    names = GL_FLAGS if spec is GOLDILOCKS else FR_FLAGS
    return cuda_lib.build_variants("ntt.cu", {d: tuple(f"-D{k}={v}" for k, v in zip(names, d)) for d in designs})


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_only_ms(fn, reps: int, name: str = "ntt") -> tuple[float, float]:
    """(device ms per launch, launches per call) of the kernels whose name
    holds `name` over `reps` calls of fn, from torch.profiler's trace (a
    trace may drop device events: the mean per launch stands, the count
    does not)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in events)
    assert count > 0, f"the profiler saw no {name} launch"
    return sum(e.self_device_time_total for e in events) / 1e3 / count, count / reps


def time_designs(reps: int = 30, designs=None, device=None, spec=FR, parent: str | None = None) -> list[dict]:
    """Each design (and the parent's NTT, first and last at each shape) at
    the paths' shapes of `spec`: Fr's plain transforms, or Goldilocks'
    coset transforms (FRI's layers)."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    gl = spec is GOLDILOCKS
    designs = designs or (GL_DESIGNS if gl else DESIGNS)
    libs = {d: cuda_lib.load_variant(p) for d, p in build_designs(designs, spec).items()}
    builds = [(d, (ntt_kernel, spec, lib)) for d, lib in libs.items()]
    if parent is not None:
        from zktpu_torch.tools.parent import load_parent

        par = load_parent(parent)
        par_ntt = importlib.import_module(par.__name__ + ".poly.ntt_kernel")
        host = importlib.import_module(par.__name__ + ".fields.host")
        par_build = ("parent", (par_ntt, getattr(host, "GOLDILOCKS" if gl else "FR"), None))
        builds = [par_build, *builds, par_build]
    gen = torch.Generator(device=device)
    gen.manual_seed(20261016)
    L = spec.num_digits // 2
    rows = []
    for log_n, batch in GL_SHAPES if gl else SHAPES:
        n = 1 << log_n
        dom = Radix2Domain(spec, n, device=device)
        x = torch.randint(-(1 << 31), 1 << 31, (batch, n, L), dtype=torch.int64, device=device, generator=gen)
        x[..., L - 1] &= (1 << (31 if gl else 29)) - 1  # canonical: below p
        x = x.to(torch.int32)
        fin = dom.offset_powers(spec.generator) if gl else None

        def run(mod=ntt_kernel, sp=spec):
            return mod.ntt(x, dom._fwd_tw, False, fin, None, sp)

        want = run()  # the library's design
        for design, (mod, sp, lib) in builds:
            call = functools.partial(run, mod, sp)
            with cuda_lib.launching(lib):
                before = mod.ntt.launches[sp.name]
                got = call()
                passes = mod.ntt.launches[sp.name] - before
                assert torch.equal(got, want), f"the NTT design {design} disagrees with the library's"
                k_ms = kernel_only_ms(call, reps)[0] * passes  # a launch's mean times the launches a call
                row = {"field": spec.name, "design": design if design == "parent" else
                       dict(zip(GL_FLAGS if gl else FR_FLAGS, design)), "log_n": log_n, "batch": batch,
                       "passes": passes, **mod.kernel_attrs(sp), "ms": _ms(call, reps), "kernel_only_ms": k_ms,
                       **bound_ms(spec, log_n, batch)}
                if not gl and design != "parent":
                    radix_log = ntt_kernel.fr_plan(log_n, batch)[0]["radix_log"]
                    row.update(radix_log=radix_log, **ntt_kernel.kernel_attrs(spec, radix_log))
                    issued = ntt_kernel.fr_products(log_n, batch, 0)
                    row["products_issued"] = issued
                    row["issued_bound_ms"] = issued * _product_imads(spec) / IMAD_PER_S * 1e3
                    row["issued_share"] = row["issued_bound_ms"] / k_ms
            row["bound_share"] = row["bound_ms"] / row["kernel_only_ms"]
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x, want, dom
        torch.cuda.empty_cache()
    return rows


# One middle radix-2^K step of the Goldilocks design (a later pass of 12
# stages in a 2^24 transform: shared memory in and out, 15 twiddles from
# shared memory), alone in a kernel so that its SASS counts what one step
# issues.
_PROBE = """
#include "ntt_gl.cuh"
__global__ void ntt_gl_step_probe() {
  extern __shared__ uint64_t smem[];
  GlArgs a{};
  a.log_n = 24;
  a.pass = GlPass{12, 12, ZK_NTT_GL_LOG_COLS};
  uint64_t x[GL_E];
  gl_step<GL_K, 1>(a, GlTile{0, 0, 0, 0}, 1, threadIdx.x, x, smem + gl_table_words(a.pass), smem);
}
"""


def butterfly_sass() -> dict:
    """The SASS instructions per butterfly of one full radix step of the
    library's Goldilocks design (K 2^(K-1) butterflies: the step's shared
    loads and stores, twiddle loads and products; cuobjdump of a probe
    kernel built from csrc/ntt_gl.cuh), by opcode, and the product's IMAD
    (gl_mul's four IMAD.WIDE.U32)."""
    from zktpu_torch.tools.g1_budgets import sass_counts

    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    h = cuda_lib.source_hash()
    src = os.path.join(cuda_lib.BUILD_DIR, f"ntt_gl_probe-{h}.cu")
    out = os.path.join(cuda_lib.BUILD_DIR, f"ntt_gl_probe-{h}.cubin")
    if not os.path.exists(out):
        with open(src, "w") as f:
            f.write(_PROBE)
        nvcc = cuda_lib.find_nvcc()
        if nvcc is None:
            raise cuda_lib.KernelBuildError("butterfly_sass needs nvcc")
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-cubin",
                            "-I", cuda_lib.CSRC_DIR, "-o", out, src], capture_output=True, text=True)
        if r.returncode != 0:
            raise cuda_lib.KernelBuildError(f"nvcc for the NTT step probe failed:\n{r.stderr}")
    c = sass_counts(out, kernels=(("step", r"ntt_gl_step_probe"),))["step"]
    radix = int(next(ln.split()[2] for ln in open(os.path.join(cuda_lib.CSRC_DIR, "ntt_gl.cuh"))
                     if ln.startswith("#define ZK_NTT_GL_RADIX")))
    butterflies = radix << (radix - 1)
    per = {op: v / butterflies for op, v in sorted(c["by_op"].items(), key=lambda kv: -kv[1])}
    full = {op: v / butterflies for op, v in sorted(c["by_full_op"].items(), key=lambda kv: -kv[1])}
    wide = sum(v for op, v in full.items() if op.startswith("IMAD.WIDE"))
    return {"radix_log": radix, "butterflies": butterflies, "instructions": c["total"] / butterflies,
            "IMAD": c.get("IMAD", 0) / butterflies, "IMAD.WIDE": wide, "by_op": per, "by_full_op": full}


# Fr: one middle radix-4 step of the design (a later pass of 10 stages in a
# 2^20 transform: shared memory in and out, twiddles from the block's
# table), alone in a kernel; and a product alone, the NTT's or field.cuh's.
_FR_PROBE = """
#include "ntt.cuh"
extern "C" __global__ void ntt_fr_step_probe(const uint32_t* tw, FrConsts f) {
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  NttArgs a{};
  a.log_n = 20;
  a.tw = tw;
  a.pass = NttPass{10, 10, ZK_NTT_LOG_COLS, 2};
  uint32_t x[4 * NTT_L];
  ntt_step<2, 1>(a, NttTile{0, 0, 0, 0}, 1, threadIdx.x, x, smem + 8 * ntt_table_slots(a.pass), smem, f);
}
"""
_FR_PRODUCT_PROBE = """
#include "ntt.cuh"
extern "C" __global__ void fr_product_probe(const uint32_t* a, const uint32_t* b, uint32_t* out, FieldConsts<8> f) {
  uint32_t x[8], y[8], r[8];
  load_elem<8>(x, a + 8 * threadIdx.x);
  load_elem<8>(y, b + 8 * threadIdx.x);
  PRODUCT(r, x, y, f);
  store_elem<8>(out + 8 * threadIdx.x, r);
}
"""
FR_WORD_PRODUCTS = 2 * 8 * 8 + 8  # of one CIOS product: a b, m p, and the 8 m
FR_STEP_BUTTERFLIES = 4  # of a radix-4 step: 2 stages of 2


def _families(by_full_op: dict) -> dict:
    """SASS counts by the families the probe reports: IMAD (32-bit
    multiply-adds), IMAD.HI, IMAD.WIDE, IMAD.X (carry in, not wide or high),
    IMAD.MOV, IADD3, IADD3.X, and the shared, device-memory and barrier
    instructions."""
    out = dict.fromkeys(("IMAD", "IMAD.HI", "IMAD.WIDE", "IMAD.X", "IMAD.MOV", "IADD3", "IADD3.X", "SEL", "LOP3",
                         "LDS", "STS", "LDG", "STG", "BAR"), 0)
    for op, v in by_full_op.items():
        base, mods = op.split(".")[0], set(op.split(".")[1:])
        if base == "IMAD":
            key = next((f"IMAD.{m}" for m in ("MOV", "WIDE", "HI") if m in mods), "IMAD.X" if "X" in mods else "IMAD")
        elif base == "IADD3":
            key = "IADD3.X" if "X" in mods else "IADD3"
        else:
            key = base
        if key in out:
            out[key] += v
    return out


def _probe_cubin(name: str, source: str) -> str:
    """A probe kernel built with nvcc -cubin against csrc/, cached by its
    source and the headers."""
    import hashlib

    h = hashlib.sha256(source.encode())
    for header in ("field.cuh", "ntt.cuh"):
        with open(os.path.join(cuda_lib.CSRC_DIR, header), "rb") as f:
            h.update(f.read())
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    stem = os.path.join(cuda_lib.BUILD_DIR, f"{name}-{h.hexdigest()[:16]}")
    if not os.path.exists(stem + ".cubin"):
        with open(stem + ".cu", "w") as f:
            f.write(source)
        nvcc = cuda_lib.find_nvcc()
        if nvcc is None:
            raise cuda_lib.KernelBuildError("the SASS probes need nvcc")
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-cubin",
                            "-I", cuda_lib.CSRC_DIR, "-o", stem + ".cubin", stem + ".cu"], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise cuda_lib.KernelBuildError(f"nvcc for the probe {name} failed:\n{r.stderr}")
    return stem + ".cubin"


def _product_sass(product: str) -> dict:
    """The SASS of one Fr product (`product`: ntt_mul or field.cuh's
    mont_mul_lazy<8>), its families a word product (FR_WORD_PRODUCTS of a
    CIOS product)."""
    from zktpu_torch.tools.g1_budgets import sass_counts

    stem = "fr_product_probe_" + product.split("<")[0]
    c = sass_counts(_probe_cubin(stem, _FR_PRODUCT_PROBE.replace("PRODUCT", product)),
                    kernels=(("product", r"fr_product_probe"),))["product"]
    fam = _families(c["by_full_op"])
    madds = sum(fam[k] for k in ("IMAD", "IMAD.HI", "IMAD.WIDE", "IMAD.X"))
    return {"instructions": c["total"], "word_products": FR_WORD_PRODUCTS,
            "per_word_product": {k: fam[k] / FR_WORD_PRODUCTS
                                 for k in ("IMAD", "IMAD.HI", "IMAD.WIDE", "IMAD.X", "IADD3", "IADD3.X")},
            "multiply_adds_per_word_product": madds / FR_WORD_PRODUCTS}


def fr_butterfly_sass() -> dict:
    """The SASS per butterfly of one middle radix-4 step of the Fr design
    (FR_STEP_BUTTERFLIES butterflies, all with products; families by
    _families), and of one product: the NTT's own ntt_mul and field.cuh's
    mont_mul_lazy, which the other kernels take (and the first design of
    the NTT took)."""
    from zktpu_torch.tools.g1_budgets import sass_counts

    step = sass_counts(_probe_cubin("ntt_fr_step_probe", _FR_PROBE),
                       kernels=(("step", r"ntt_fr_step_probe"),))["step"]
    sf, b = _families(step["by_full_op"]), FR_STEP_BUTTERFLIES
    return {"butterflies": b, "instructions": step["total"] / b, "per_butterfly": {k: v / b for k, v in sf.items()},
            "by_full_op": {op: v / b for op, v in sorted(step["by_full_op"].items(), key=lambda kv: -kv[1])},
            "product": _product_sass("ntt_mul"), "field_product": _product_sass("mont_mul_lazy<8>")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--field", choices=("fr", "goldilocks"), default="fr")
    ap.add_argument("--parent", help="another checkout whose NTT to time beside the designs")
    ap.add_argument("--sass", action="store_true", help="also print the SASS per butterfly of a radix step")
    args = ap.parse_args(argv)
    from zktpu_torch.fields.fp import norm_device

    device = norm_device(None)  # the current CUDA device; raises without one
    print(f"device {torch.cuda.get_device_name(0)}; library {cuda_lib.build()}", flush=True)
    if args.sass and args.field == "goldilocks":
        print(json.dumps({"butterfly_sass": butterfly_sass()}), flush=True)
    elif args.sass:
        print(json.dumps({"fr_butterfly_sass": fr_butterfly_sass()}), flush=True)
    time_designs(args.reps, device=device, spec=GOLDILOCKS if args.field == "goldilocks" else FR,
                 parent=args.parent)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
