"""Design sweep of the tensor-core chained products (kernels 5m, 5f).

    python -m zktpu_torch.tools.mma_budgets [--reps 20] [--log-n 16 20] [--parent DIR] [--designs NAME ...]
                                            [--out FILE]

Builds csrc/mont_mma.cu once for each design of DESIGNS (one nvcc each,
all at once, through cuda_lib.build_variants: -D values of csrc/mont_mma.cuh's
ZK_MMA_* knobs, the library's build among them as "library") and, for Fq and
Fr, each body (mxu, f32) and each N = 2^log_n + 3 elements (0, 1 and p - 1
first, then random ones), prints one JSON line a design: kernel-only ms per
launch of CHAIN = 12 products (CUDA events around back-to-back launches
queued behind a spin of the card, so the host's launch time is hidden),
the share of the bound (prof_mulkernels.chain_bound) and of the tensor
pipe's time for the MACs it issues, registers, local (spill) bytes and
shared bytes per block (cudaFuncGetAttributes), the SASS counts of the
instance (cuobjdump: IGMMA, the warpgroup's integer tensor-core product;
IMMA, mma.sync's; FFMA; IMAD) and "match": its words equal the base plain
chain's (up to 2^16 + 3 the library's words are held against the plain
chain on every element; every other design and the parent against the
library's at every N).  The port's base body
(csrc/mont_mul.cu) is timed beside them.  With --parent DIR (a `git
archive` of another commit unpacked under build/; tools/parent.py) the
parent's mxu and f32 bodies are timed too, and the order of each shape is
parent, designs, designs reversed, parent: every figure is the mean of two
turns, both listed.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from zktpu_torch import cuda_lib
from zktpu_torch.fields.fp import field
from zktpu_torch.fields.host import FQ, FR
from zktpu_torch.fields.mont_kernel import mont_mma_attrs, mont_mma_design, mont_mul_chain, mont_mul_chain_plain
from zktpu_torch.tools.prof_mulkernels import chain_bound, rand_elems

CHAIN = 12
# name: the -D flags of csrc/mont_mma.cuh's knobs for every instance (the
# library's own per-instance design is "library": mxu 1 tile in flight, f32
# 2; the m p product in 2 parts for Fq, 1 for Fr; no launch bound)
DESIGNS = {
    "library": (),
    "one_tile": ("-DZK_MMA_TILES=1",),
    "two_tiles": ("-DZK_MMA_TILES=2",),
    "psplit_1": ("-DZK_MMA_PSPLIT=1",),
    "psplit_2": ("-DZK_MMA_PSPLIT=2",),
    "min_blocks_3": ("-DZK_MMA_MIN_BLOCKS=3",),
    "min_blocks_4": ("-DZK_MMA_MIN_BLOCKS=4",),
}


def device_ms(fn, reps: int) -> float:
    """Device ms per call of fn: CUDA events around `reps` calls queued behind
    a spin of the card (torch.cuda._sleep), so the window holds the kernels
    back to back and none of the host's launch time."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # about 10 ms: the host queues every launch first
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sass(path: str) -> dict:
    """{"variant<L>": {IGMMA, IMMA, FFMA, IMAD, total, top (the 8 most frequent
    opcodes)}} of the chain kernels in the library at path (cuobjdump)."""
    from zktpu_torch.tools.g1_budgets import sass_counts

    kernels = [(f"{v}<{L}>", rf"21mont_mma_chain_kernelILi{L}ELb{int(v == 'f32')}E") for L in (12, 8)
               for v in ("mxu", "f32")]
    counts = sass_counts(path, kernels=kernels)
    return {label: {**{op: c["by_op"].get(op, 0) for op in ("IGMMA", "IMMA", "FFMA")}, "IMAD": c.get("IMAD", 0),
                    "total": c["total"], "top": dict(sorted(c["by_op"].items(), key=lambda kv: -kv[1])[:8])}
            for label, c in counts.items()}


def _operands(spec, n: int, device):
    a, b = rand_elems(spec, n, device, 0), rand_elems(spec, n, device, 1)
    p = spec.modulus
    edges = field(spec, device).encode_ints
    a[:4], b[:4] = edges([0, 1, p - 1, p - 1]), edges([p - 1, p - 1, p - 1, 1])
    return a, b


def sweep(reps: int = 20, log_ns=(16, 20), parent: str | None = None, designs=None, device=None,
          out=None) -> list[dict]:
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    designs = {k: DESIGNS[k] for k in (designs or DESIGNS)}
    paths = cuda_lib.build_variants("mont_mma.cu", designs)
    libs = {k: cuda_lib.load_variant(p) for k, p in paths.items()}
    counts = {k: sass(p) for k, p in paths.items()}
    par = None
    if parent is not None:
        from zktpu_torch.tools.parent import load_parent

        par = importlib.import_module(load_parent(parent).__name__ + ".fields.mont_kernel")
    order = list(libs)
    turns = ["parent", *order, *order[::-1], "parent"] if par is not None else [*order, *order[::-1]]
    rows = []
    for spec in (FQ, FR):
        L = spec.num_digits // 2
        for log_n in log_ns:
            n = (1 << log_n) + 3
            a, b = _operands(spec, n, device)
            want = mont_mul_chain_plain(spec, a, b, CHAIN) if log_n <= 16 else None
            base_ms = [device_ms(lambda: mont_mul_chain(spec, a, b, CHAIN), reps) for _ in range(2)]
            base_bound = chain_bound(spec, "base", n, CHAIN)
            print(json.dumps({"field": spec.name, "n": n, "variant": "base", "kernel_only_ms": sum(base_ms) / 2,
                              "turns": base_ms, "bound_ms": base_bound["bound_ms"],
                              "bound_share": base_bound["bound_ms"] * 2 / sum(base_ms)}), flush=True)
            for variant in ("mxu", "f32"):
                with cuda_lib.launching(libs.get("library")):
                    ref = mont_mul_chain(spec, a, b, CHAIN, variant)
                if want is not None:
                    assert torch.equal(ref, want), f"{spec.name} {variant}: the library's words differ from plain"
                times = {k: [] for k in ("parent", *order)}
                for who in turns:
                    if who == "parent":
                        fn = lambda: par.mont_mul_chain(spec, a, b, CHAIN, variant)  # noqa: E731
                        assert torch.equal(fn(), ref), f"{spec.name} {variant}: the parent's words differ"
                        times[who].append(device_ms(fn, reps))
                        continue
                    with cuda_lib.launching(libs[who]):
                        fn = lambda: mont_mul_chain(spec, a, b, CHAIN, variant)  # noqa: E731
                        assert torch.equal(fn(), ref), f"{spec.name} {variant} {who}: the words differ"
                        times[who].append(device_ms(fn, reps))
                bound = chain_bound(spec, variant, n, CHAIN)
                for who, ts in times.items():
                    if not ts:
                        continue
                    ms = sum(ts) / len(ts)
                    row = {"field": spec.name, "n": n, "variant": variant, "design": who, "kernel_only_ms": ms,
                           "turns": ts, "base_ms": sum(base_ms) / 2, "bound_ms": bound["bound_ms"],
                           "bound_pipe": bound["bound_pipe"], "bound_share": bound["bound_ms"] / ms,
                           "tensor_issued_share": bound["tensor_issued_ms"] / ms, "match": True}
                    if who != "parent":
                        with cuda_lib.launching(libs[who]):
                            row.update(mont_mma_attrs(spec, variant), design_values=mont_mma_design(spec, variant))
                        row["sass"] = counts[who][f"{variant}<{L}>"]
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                    if out is not None:
                        out.write(json.dumps(row) + "\n")
            del a, b, want
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--log-n", type=int, nargs="+", default=[16, 20], help="log2 of the element counts (+ 3)")
    ap.add_argument("--parent", default=None, help="another checkout whose mxu and f32 bodies to time in turns")
    ap.add_argument("--designs", nargs="+", default=None, choices=sorted(DESIGNS))
    ap.add_argument("--out", default=None, help="also append the rows to this file as JSON lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mma_budgets: no CUDA device", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    if args.out:
        with open(args.out, "a") as out:
            sweep(args.reps, args.log_n, args.parent, args.designs, out=out)
    else:
        sweep(args.reps, args.log_n, args.parent, args.designs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
