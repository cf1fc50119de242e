"""Time the NTT kernel at other tile sizes, block sizes and occupancies.

    python -m zktpu_torch.tools.ntt_tiles [--reps 30] [--field fr|goldilocks] [--parent DIR] [--sass]

csrc/ntt.cu hard-codes its designs.  Fr: the tile size, the threads of a
block, the minimum of blocks per SM that the launch bound asks for (which
caps the registers) and the fewest columns of a later pass's tile
(-DZK_NTT_LOG_TILE, -DZK_NTT_THREADS, -DZK_NTT_MIN_BLOCKS,
-DZK_NTT_LOG_MIN_COLS).  Goldilocks (ntt_gl.cuh): the radix of the steps a
thread runs in registers, the largest tile, the columns of a multi-pass
tile, the largest transform done in one pass and the minimum of blocks per
SM (-DZK_NTT_GL_RADIX, -DZK_NTT_GL_LOG_TILE, -DZK_NTT_GL_LOG_COLS,
-DZK_NTT_GL_ONE_PASS, -DZK_NTT_GL_MIN_BLOCKS).  For each design in DESIGNS
(Fr) or GL_DESIGNS (Goldilocks) this tool builds its own copy of ntt.cu (one
nvcc per design, in parallel, into build/zktpu_torch/), launches it through
the port's wrapper at the paths' shapes (Fr: the 8n coset transform at 2^14
gates, 2^17 x batch 7, and 2^20 x 1; Goldilocks: coset transforms at 2^16,
2^20 and 2^22, batch 1, and 2^13 x 3), checks that it gives the library's
words, and prints one JSON line per design and shape: registers, local
bytes (spills), launches, ms per call with CUDA events (wrapper included),
kernel-only ms per call (torch.profiler) and the share of the bound.

--parent DIR also loads another checkout's package (a `git archive` of an
earlier commit unpacked under build/; tools/parent.py) and times its NTT
the same way (its design as that tree builds it), so that two designs are
compared inside one run on one card.  --sass prints the SASS instructions
per butterfly of one radix step of the Goldilocks design (butterfly_sass).
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

# (log2 tile, threads a block, minimum blocks per SM, log2 fewest columns);
# the library's is (9, 128, 8, 3)
DESIGNS = ((11, 512, 2, 3), (10, 256, 4, 3), (10, 256, 4, 2), (10, 128, 7, 3), (9, 128, 8, 3), (9, 128, 8, 2),
           (9, 256, 4, 3), (8, 64, 16, 3), (8, 64, 16, 2))
SHAPES = ((17, 7), (20, 1))  # (log n, batch)
# Goldilocks: (log2 radix, log2 largest tile, log2 columns, largest log n in
# one pass, minimum blocks per SM); the library's is (3, 13, 3, 11, 1).  A
# tile of 2^12 words takes 32 KB of shared memory, 2^13 64 KB, plus the
# twiddle table; a block has 2^(log tile - radix) <= 1024 threads.
GL_DESIGNS = ((3, 13, 3, 11, 1), (3, 13, 2, 11, 1), (3, 13, 4, 11, 1), (3, 13, 3, 13, 1), (3, 13, 3, 11, 2),
              (4, 13, 3, 11, 1), (2, 12, 3, 11, 1), (2, 12, 2, 11, 1))
GL_SHAPES = ((16, 1), (20, 1), (22, 1), (13, 3))
GL_FLAGS = ("ZK_NTT_GL_RADIX", "ZK_NTT_GL_LOG_TILE", "ZK_NTT_GL_LOG_COLS", "ZK_NTT_GL_ONE_PASS",
            "ZK_NTT_GL_MIN_BLOCKS")
FR_FLAGS = ("ZK_NTT_LOG_TILE", "ZK_NTT_THREADS", "ZK_NTT_MIN_BLOCKS", "ZK_NTT_LOG_MIN_COLS")
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
    """(device ms per call, launches per call) of the kernels whose name holds
    `name` over `reps` calls of fn, from torch.profiler's trace."""
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
    return sum(e.self_device_time_total for e in events) / 1e3 / reps, count / reps


def time_designs(reps: int = 30, designs=None, device=None, spec=FR, parent: str | None = None) -> list[dict]:
    """Each design (and the parent's NTT) at the paths' shapes of `spec`:
    Fr's plain transforms, or Goldilocks' coset transforms (FRI's layers)."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    gl = spec is GOLDILOCKS
    designs = designs or (GL_DESIGNS if gl else DESIGNS)
    libs = {d: cuda_lib.load_variant(p) for d, p in build_designs(designs, spec).items()}
    builds = {d: (ntt_kernel, spec, lib) for d, lib in libs.items()}
    if parent is not None:
        from zktpu_torch.tools.parent import load_parent

        par = load_parent(parent)
        par_ntt = importlib.import_module(par.__name__ + ".poly.ntt_kernel")
        host = importlib.import_module(par.__name__ + ".fields.host")
        builds["parent"] = (par_ntt, getattr(host, "GOLDILOCKS" if gl else "FR"), None)
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
        for design, (mod, sp, lib) in builds.items():
            call = functools.partial(run, mod, sp)
            with cuda_lib.launching(lib):
                before = mod.ntt.launches[sp.name]
                got = call()
                passes = mod.ntt.launches[sp.name] - before
                assert torch.equal(got, want), f"the NTT design {design} disagrees with the library's"
                k_ms, _ = kernel_only_ms(call, reps)
                row = {"field": spec.name, "design": design if design == "parent" else
                       dict(zip(GL_FLAGS if gl else FR_FLAGS, design)), "log_n": log_n, "batch": batch,
                       "passes": passes, **mod.kernel_attrs(sp), "ms": _ms(call, reps), "kernel_only_ms": k_ms,
                       **bound_ms(spec, log_n, batch)}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--field", choices=("fr", "goldilocks"), default="fr")
    ap.add_argument("--parent", help="another checkout whose NTT to time beside the designs")
    ap.add_argument("--sass", action="store_true", help="also print the Goldilocks step's SASS per butterfly")
    args = ap.parse_args(argv)
    from zktpu_torch.fields.fp import norm_device

    device = norm_device(None)  # the current CUDA device; raises without one
    print(f"device {torch.cuda.get_device_name(0)}; library {cuda_lib.build()}", flush=True)
    if args.sass:
        print(json.dumps({"butterfly_sass": butterfly_sass()}), flush=True)
    time_designs(args.reps, device=device, spec=GOLDILOCKS if args.field == "goldilocks" else FR,
                 parent=args.parent)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
