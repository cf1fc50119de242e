#!/usr/bin/env python3
"""Run the zktpu_torch main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py [--log-n 14] [--msm-log-n 20] [--fri-log-n 20] [--nova-log-m 14] [--nova-steps 64]
                          [--parent DIR]

Phases:
  1. device: the card's name and power limit (fails without CUDA); the
     kernels built from zktpu_torch/csrc (one nvcc per source, in parallel;
     ptxas's register and spill counts go to stderr), and the registers,
     local (spill) bytes and shared memory per block of the group-law
     kernels, the Horner combine, the NTT (Fr and Goldilocks), the field
     scans, the field add/sub, the field hash, the FRI fold, the fixed-base
     multiply (its dynamic shared memory included), Nova's matrix-vector
     product (and its rows and threads a block), the field linear
     combination (field_lincomb) and the tensor-core chained
     products (mxu and f32, Fr and Fq) (fails if one spills); the designs of
     the fixed-base multiply (threads a block, launch bound) and of the field
     scans (threads a block, the tile rule's grid and longest chunk); with
     --parent DIR, another checkout's library built beside this one
     (tools/parent.py); the design of the mxu and f32 kernels (csrc/mont_mma.cuh
     MmaDesign) and the SASS of the chained product's three bodies (IGMMA, IMMA,
     FFMA, IMAD: cuobjdump), the mxu and f32 kernels must hold the
     warpgroup's tensor-core product (IGMMA) and no IMMA, the f32 ones
     FFMA; the Goldilocks NTT's plan at 2^fri_log_n and 2^22 and its
     SASS per butterfly (IMAD, LDS/STS of one radix step; BAR per butterfly
     from the plan); the Fr NTT's design, its plan at the paths' shapes
     (a multi-pass block fills a warp) and the SASS per butterfly of one of its radix-4 steps, of its
     product and of field.cuh's (the step must hold no LDG);
  2. kernels: holds each CUDA kernel against its plain PyTorch version on
     the card, bit for bit (mont_mul for Fr, Fq and Goldilocks and
     mont_mul_chain at N = 2^16 + 3 with the edge values 0, 1, p - 1, for
     Fr and Fq in each body, base, mxu and f32, each also against the base
     plain chain, timed with the wrapper and kernel only, with --parent the
     parent's mxu and f32 kernel only in turns with this checkout's;
     proj_add, proj_double and proj_madd at N = 2^14 + 5 with identity,
     P + P, P + (-P), (0, 0) and padding lanes), with both times; proj_add
     and proj_madd also on strided slices of (3, n + 5, 12) planes (n = 2^14
     + 5, 1, 333), a broadcast operand and out= planes; proj_double at the
     Horner combine's (K, 12) for K = 8 and 1, and mont_mul over Fr at one
     stage of the 2^17 coset NTT (the shapes their paths gave them before
     the NTT kernel and the one-launch combine) and at the coset division's
     (2^17, 8) pointwise product, which the path still gives it; the NTT
     (ntt against ntt_plain) at the path's 2^17 x batch 7, 2^16 x 9, 2^14 x
     3 and 2^17 x 1, at the four-step NTT's 2^11 x 2048 and at 2^20 x 1
     for fft, ifft, coset_fft and coset_ifft, each timed beside its bound (the fft kernel only too, and
     with --parent in turns with the parent's), and at n = 2 and n = 2^8
     (one pass), with an all-zero row and a row of p - 1 where the batch has
     three; the Horner combine against its
     plain loop and the launch loop it replaced at (c, K, W) = (13, 1, 20),
     (13, 3, 20), (13, 8, 20) (the PLONK and Nova commits at 2^14) and
     (16, 1, 16) (the MSM bench's), parts holding the identity, with ms,
     microseconds a dependent product step, registers and the depth figure
     (steps x one lane-parallel product, timed alone as a chain in one
     warp and held against the plain chain); the field scans (cumprod, cumsum both ways, sum
     on axis 0 and 1, powers, batch_inv) and the field add/sub against their
     plain versions at the shapes the paths give them, a scan of many tiles
     (2^20) and one of 5 rows, Fr and Fq, each with its launches a call and
     its kernel-only ms (phase_field_ops); rows 1 Fr (2^17, 8), 1 Fq
     (2^16 + 3, 12) and 1a Fr (2^17, 8) with their wrappers and kernel
     only, and mont_mul Fr's kernel alone where an operand broadcasts
     ((2^20, 8) x (1, 8), (2^14, 8, 8) x (8, 8)), each with --parent in
     turns with the parent's (phase_field_turns); field_lincomb against its
     plain chain at the sites' shapes: compute_t's K = 4 at 2^log_n,
     fold_witness's two, w_ev_x's six unequal lengths with a row-0
     constant, r(X)'s nine terms (two launches) and eight terms of 0, 1 and
     p - 1 with both signs, each with its ms, kernel-only ms, bound, the
     plain chain's ms and the launch chain it replaced (phase_lincomb);
     the Goldilocks NTT (fft, ifft, coset_fft, coset_ifft and coset_fft with
     the raw-1 output factor at 2^fri_log_n x 1, 2^13 x 3, n = 2 and 2^8 x 3,
     2^16 and 2^22, an all-zero row and a row of p - 1; its kernel-only time
     at 2^16, 2^fri_log_n and 2^22), the field hash (single at 2^fri_log_n
     values, pairs at 2^(fri_log_n - 1), digit-length edges mixed in; the
     first 64 of each against hashlib), the FRI fold at the first fold's
     (2^(fri_log_n - 1), 2) coefficients and the Goldilocks powers kernel
     alone at the same shape (phase_fri_kernels); the
     fixed-base kernel at 2^msm_log_n and 2^log_n + 3 scalars (the edge
     scalars 0, 1, r - 1, 2^256 - 1 and zero digits among random ones)
     against its plain loop (every projective word, every affine point), 64
     against host scalar multiplication, with its kernel-only ms, bound and
     share, timed beside the loop it replaced (32 gathers and proj_add
     launches), and Srs.new_from_secret of 2^msm_log_n points with the
     kernel, the former loop and the plain loop (phase_fixed_base).  With
     --parent, the fixed-base multiply, the scans and Srs.new of the other
     checkout are timed in turns with this one's, their words equal;
  3. small proof: a 4-gate circuit proved with every tensor path forced,
     once on the GPU and once on the CPU; the proofs must be equal;
  4. PLONK path: synthetic_mul_chain(log_n) and its SRS on the GPU, prove,
     verify, and reject a tampered proof; its kernels must have launched,
     proj_double must not have (the Horner combine replaces it), and no
     plain carry scan (fields/limbs.py resolve) may have run on the card
     during prove and verify; then,
     outside the count, one more prove traced by torch.profiler for its
     total CUDA kernel launches;
  5. MSM path: zktpu_torch.bench's inputs at 2^msm_log_n (SRS-like points in
     affine form), msm_proj and msm_affine on the same scalars, equal to each
     other and to the host's tau-power sum; its kernels must have launched.
     Then, outside the count, a spot check of the first 64 points against
     host curve arithmetic, and proj_madd and proj_add against their plain
     versions on the operands msm_affine gives them and proj_add on the
     first step of msm_proj's doubling scan at 2^msm_log_n, timed.
     Last the chained-multiply tool (zktpu_torch.tools.prof_mulkernels),
     its three bodies for Fq and Fr and base for Goldilocks, as a path of
     its own;
  6. FRI path: generate_proof on the card for 2^(fri_log_n - 1) Goldilocks
     coefficients (blowup 2, 32 queries) and the host verify; the Goldilocks
     NTT, the hash, the fold and the scans (the domains' power tables) must
     have launched, the Goldilocks mont_mul and add/sub must not have
     (from_mont rides in the NTT, the fold is one kernel).  Outside the
     count: the verifier rejects
     one changed evaluation and one changed root; layer 0's root equals a
     hashlib tree over its evaluations from the card, 64 of which equal
     host evaluations; a 2^12-domain proof from the card equals the CPU's;
     mont_mul, the add/sub and the powers over Goldilocks timed at the
     path's shapes; prove and verify seconds at 2^12, 2^16 and 2^fri_log_n
     (median of 3 warm runs) beside the card's power limit;
  7. Nova path: (a) zktpu's 4-step IVC (x^3 + x + 5, SRS secret 424242)
     on the card equals the committed golden of zktpu's run
     (tests/goldens/nova.json) in every hash, com_T, r, instance and
     opening; (b) a 2^7 squaring chain for 4 steps with every tensor path
     forced, GPU == CPU; (c) the squaring chain at m = 2^nova_log_m
     constraints (dense (m, m + 3, 8) matrices on the card,
     zktpu_torch.tools.prof_nova) for nova_steps steps: every step
     verifies, a changed com_T and a changed public x are rejected, the
     first fold satisfies the relaxed R1CS, the final state equals the
     host's; setup, per-step prove and verify medians, launches, the split
     of one fold step, the idle share of a traced two-step run, peak
     memory; its kernels must have launched, matvec_fr once a
     matrix-vector product (6 a fold, 3 in the first fold's satisfaction
     check); (d) outside the count, matvec_fr against its plain version on
     A's first 64 rows, 64 random rows and 16 rows of p - 1 words at the
     full n, then at the full shape in turns with the former pair (the
     product against z[None], then the axis-1 sum), same words, beside the
     bounds;
  8. parser path: a sum-of-products equation of 2^log_n gates parsed with
     seeded witnesses, proved and verified on the card, a proof of another
     equation rejected, CPIGenerator's eight commitments equal to the
     prover's; its kernels must have launched;
  9. dist path (zktpu_torch.dist): (a) at world size 1 over NCCL, a path
     of its own: the four-step NTT at 2^22 (fft and ifft, word for word
     against get_domain's), the sharded MSM at 2^20 (against msm_proj),
     dist_fri_layer at a 2^20 Goldilocks domain (evaluations, levels,
     root against FriLayer.from_poly) and ShardedWireCommitter at 2^16
     (against interpolate-then-commit, commit_blinded against committing
     the blinded polynomials), each timed beside its single-device
     counterpart; (b) 4 gloo ranks sharing the card at 2^16, 2^14, 2^14
     and 2^10: every rank's results equal the single-device ones;
 10. compat: phase 4's SRS and proof and phase 6's FRI proof saved and
     loaded on the card (the SRS commits equally, the proofs verify, a
     changed bar_a is rejected); an IVC at 2^10 constraints saved after
     step 4 of 8, resumed in a fresh circuit, equal to the uninterrupted
     run;
 11. profiling: a prove of phase 4's circuit under ZKTPU_PROFILE writes a
     trace naming the NTT and group-law kernels; under ZKTPU_DEBUG=1
     phase 3's proof raises nothing and an off-curve point raises;
 12. the five examples as subprocesses on the card, the dist example at
     world 1 (NCCL) and as 4 gloo ranks: each exits 0 with its accepted
     line.
Launches are set to 0 just before each path (phase 4, the bench, the tool,
the FRI prove, the Nova run, the parser path, the dist functions at world
size 1) and read just after; phases 4, 7 and 8 print their field kernels'
launches (mont_mul Fr and Fq, field_addsub Fr, field_lincomb), and
field_lincomb must have launched on each of the three.  Then one
JSON line with the kernels (launches summed over the seven paths; times and
bounds at the shapes the paths give them:
proj_madd at msm_affine's mixed add, proj_add at msm_proj's first scan step,
proj_double at K = 1, mont_mul Fr at the coset division's product, ntt_fr
at 2^17 x 7 (fft), horner_combine at (16, 1, 16), field_scan_fr at round
2's 2^14 cumprod, field_scan_fq at Srs.g1_affine's 2^20 batch_inv,
field_addsub_fr at the coset quotient's (2^17, 8) add, ntt_gl at FRI layer
0's coset_fft, sha256_field at its leaves, mont_mul_gl at the from_mont it
ran before the NTT took it, field_addsub_gl at the first fold's add it ran
before the fold kernel, fri_fold at the first fold, field_scan_gl at its
largest power table, fixed_base_mul at 2^msm_log_n scalars (an SRS of that
size), matvec_fr at Nova's full (2^nova_log_m, 2^nova_log_m + 3, 8) shape
with its plain_ms on A's first 64 rows (its "plain_shape"), field_lincomb
at compute_t's K = 4 over 2^log_n rows, the others at phase 2's shapes), the
card's name and power limit, and the final {"ok": true, ...} line.  Any
failure raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import random
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from zktpu_torch.tools import launches as launch_counts  # noqa: E402  (the checkout's package, on the path above)
from zktpu_torch.tools.trace import smi as _smi  # noqa: E402

SEED = 20261016
SRS_SECRET = 0x5EED5EED
CHAIN = 12

# The card's peak rates for the bounds (NVIDIA H100 SXM at its 700 W limit).
# Bytes: 3.35 TB/s of HBM3 (data sheet).  Operations: 32-bit integer
# multiply-adds, 64 per clock per SM on compute capability 9.0 (half the 128
# FP32 lanes behind the data sheet's 67 TFLOP/s) x 132 SMs x 1.98 GHz.  A
# 32 x 32 -> 64-bit word product costs two of them (low and high halves).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
# Other 32-bit integer operations (adds, logic, shifts, byte permutes,
# selects) issue to the integer ALU pipe, 64 a clock per SM, beside the
# multiply-add pipe, and the compiler moves adds and moves onto either: so
# a kernel of such operations takes at least their count over both pipes.
INT_OPS_PER_S = 2 * IMAD_PER_S


def _mont_words(limbs: int) -> int:
    """Word products of one CIOS Montgomery product: a b, then m p and m."""
    return 2 * limbs * limbs + limbs


# Word products of one Goldilocks product (field.cuh's gl_mul): the four of
# a b; its reduction is shifts and adds.
GL_PRODUCT_WORDS = 4


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


def _bound(nbytes: int, word_products: int, int_ops: int = 0) -> dict:
    """The least time for the work: bytes over HBM, or the multiply-adds (two
    a word product) over their pipe's rate, or those and the other 32-bit
    integer operations over both integer pipes, whichever is longest."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(2 * word_products / IMAD_PER_S, (2 * word_products + int_ops) / INT_OPS_PER_S)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _record(results: dict, key: str, n: int, err: int, ms: float, plain_ms: float, nbytes: int, words: int,
            phase: str = "phase 2:", int_ops: int = 0) -> None:
    results[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "n": n, **_bound(nbytes, words, int_ops)}
    print(f"{phase} {key} n={n} mismatches=0 kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={results[key]['bound_ms']:.5f} ({results[key]['bound_by']})", flush=True)


def _chain_variants(spec, f, a_ints, b_ints, A, B, results, parent=None) -> None:
    """The three bodies of kernel 5 at one shape: each against its own plain
    version (every word) and the base plain chain, its time with the
    wrapper (CUDA events) and kernel only (torch.profiler), its bound
    (prof_mulkernels.chain_bound: the busiest pipe); with `parent`, the
    parent's mxu and f32 kernel only in turns (this, parent, parent, this),
    its words equal to this checkout's.  The kernels line takes the Fq rows."""
    from zktpu_torch.fields.host import FQ
    from zktpu_torch.fields.mont_kernel import PLAIN_CHAINS, mont_mul_chain, mont_mul_chain_plain
    from zktpu_torch.tools.prof_mulkernels import chain_bound

    n = A.shape[0]
    p = spec.modulus
    base_plain = mont_mul_chain_plain(spec, A, B, CHAIN)
    for variant, plain in PLAIN_CHAINS.items():
        key = "mont_mul_chain" + ("" if variant == "base" else f"_{variant}")
        got = mont_mul_chain(spec, A, B, CHAIN, variant)
        err = _compare(f"{key} {spec.name}", [got], [base_plain if variant == "base" else plain(spec, A, B, CHAIN)])
        if variant != "base":
            _compare(f"{key} {spec.name} vs the base plain chain", [got], [base_plain])
        assert f.decode_ints(got[:8]) == [x * pow(y, CHAIN, p) % p for x, y in zip(a_ints[:8], b_ints[:8])]
        ms = _cuda_ms(lambda: mont_mul_chain(spec, A, B, CHAIN, variant), 50)
        plain_ms = _cuda_ms(lambda: plain(spec, A, B, CHAIN), 2)
        kernel = "mont_mul_chain_kernel" if variant == "base" else "mont_mma_chain_kernel"
        k_ms, count = _kernel_only_ms(lambda: mont_mul_chain(spec, A, B, CHAIN, variant), 50, kernel)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "n": n, "kernel_only_ms": k_ms,
               **chain_bound(spec, variant, n, CHAIN)}
        turns = ""
        if parent is not None and variant != "base":
            pmod = parent.fields.mont_kernel
            assert torch.equal(pmod.mont_mul_chain(spec, A, B, CHAIN, variant), got), f"{key}: the parent differs"
            fns = {"this": lambda: mont_mul_chain(spec, A, B, CHAIN, variant),
                   "parent": lambda: pmod.mont_mul_chain(spec, A, B, CHAIN, variant)}
            turns = "; kernel only in turns: " + _turns_text(
                _in_turns(fns, lambda fn: _kernel_only_ms(fn, 50, kernel)[0]))
        print(f"phase 2: {key} {spec.name} n={n} chain={CHAIN} mismatches=0 (own plain and base plain) "
              f"kernel_ms={ms:.4f} kernel_only_ms={k_ms:.4f} ({count} launches) plain_ms={plain_ms:.4f} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}: {row['bound_pipe']}; "
              f"{100 * row['bound_ms'] / k_ms:.1f}% kernel only) "
              f"Mmul/s={n * CHAIN / ms / 1e3:.1f} (kernel only {n * CHAIN / k_ms / 1e3:.1f}){turns}", flush=True)
        if spec is FQ:  # the microbench's field: its rows in the kernels line
            results[key] = row


def _edge_ints(rng, p: int, n: int):
    a = [0, 1, p - 1, p - 1] + [rng.randrange(p) for _ in range(n - 4)]
    b = [p - 1, p - 1, p - 1, 1] + [rng.randrange(p) for _ in range(n - 4)]
    return a, b


def phase_chain_sass() -> None:
    """The SASS of kernel 5's three bodies (cuobjdump, through
    tools/g1_budgets.py's sass_counts): IGMMA (the warpgroup's u8
    tensor-core products, wgmma), IMMA (mma.sync's), FFMA, IMAD and all
    instructions of each instance.  The mxu and f32 kernels must hold IGMMA
    (a product a tile and k-step of each constant convolution) and no IMMA,
    the f32 ones FFMA."""
    from zktpu_torch.fields.host import FQ, FR
    from zktpu_torch.fields.mont_kernel import mont_mma_design
    from zktpu_torch.tools.g1_budgets import sass_counts

    print("phase 1: mont_mma design " + "; ".join(
        f"{v} {spec.name}: {json.dumps(mont_mma_design(spec, v))}" for spec in (FQ, FR) for v in ("mxu", "f32")),
        flush=True)

    kernels = [("base<12>", r"21mont_mul_chain_kernelILi12E"), ("base<8>", r"21mont_mul_chain_kernelILi8E")]
    kernels += [(f"{v}<{L}>", rf"21mont_mma_chain_kernelILi{L}ELb{int(v == 'f32')}E")
                for L in (12, 8) for v in ("mxu", "f32")]
    counts = sass_counts(kernels=kernels)
    for label, _ in kernels:
        c = counts[label]
        top = sorted(c["by_op"].items(), key=lambda kv: -kv[1])[:10]
        print(f"phase 1: SASS {label}: {c['by_op'].get('IGMMA', 0)} IGMMA, {c['by_op'].get('IMMA', 0)} IMMA, "
              f"{c['by_op'].get('FFMA', 0)} FFMA, {c.get('IMAD', 0)} IMAD, {c['total']} instructions; "
              f"by opcode {dict(top)}", flush=True)
    for L, spec in ((12, FQ), (8, FR)):
        k_steps = -(-2 * spec.num_digits // 32)  # 32 of the element's 2D bytes each
        for v in ("mxu", "f32"):
            c = counts[f"{v}<{L}>"]["by_op"]
            assert c.get("IGMMA", 0) >= 2 * 2 * k_steps, f"{v}<{L}>: no warpgroup tensor-core products in its SASS: {c}"
            assert c.get("IMMA", 0) == 0, f"{v}<{L}>: mma.sync products in its SASS: {c}"
        assert counts[f"f32<{L}>"]["by_op"].get("FFMA", 0) > 0, f"f32<{L}>: no FFMA in its SASS"


def phase_ntt_gl_sass(log_n: int) -> None:
    """The Goldilocks NTT's plan at 2^log_n and 2^22 (passes, threads,
    shared memory, radix steps) and its SASS: per butterfly of one radix
    step (tools/ntt_tiles.py's probe: IMAD, LDS, STS), the kernel's BAR, and
    BAR per butterfly at 2^log_n from the plan (a barrier after the load and
    one between steps; ns 2^(K-1) butterflies a thread a pass).  The step
    must hold at most 4 IMAD.WIDE a butterfly (gl_mul's four word products)
    and no BAR."""
    from zktpu_torch.poly.ntt_kernel import gl_plan
    from zktpu_torch.tools.g1_budgets import sass_counts
    from zktpu_torch.tools.ntt_tiles import butterfly_sass

    for lg in sorted({log_n, 22}):
        print(f"phase 1: ntt Goldilocks plan 2^{lg}: {json.dumps(gl_plan(lg))}", flush=True)
    step = butterfly_sass()
    kernel = sass_counts(kernels=(("ntt_gl_kernel", r"13ntt_gl_kernel"),))["ntt_gl_kernel"]
    plan = gl_plan(log_n)
    radix = step["radix_log"]
    bars = sum(p["steps"] for p in plan)
    butterflies = sum(p["ns"] << (radix - 1) for p in plan)
    by = step["by_op"]
    full = {k: round(v, 2) for k, v in list(step["by_full_op"].items())[:16]}
    print(f"phase 1: SASS ntt Goldilocks, per butterfly of a radix-{1 << radix} step: {step['IMAD.WIDE']:.2f} "
          f"IMAD.WIDE (the product's word products), {step['IMAD']:.2f} IMAD in all, "
          f"{by.get('LDS', 0):.2f} LDS, {by.get('STS', 0):.2f} STS, {by.get('BAR', 0):.2f} BAR, "
          f"{step['instructions']:.2f} instructions; by opcode {json.dumps(full)}; "
          f"the kernel holds {kernel['by_op'].get('BAR', 0)} BAR, {kernel['total']} instructions; at 2^{log_n} a "
          f"thread passes {bars} barriers over {butterflies} butterflies: {bars / butterflies:.4f} BAR a butterfly",
          flush=True)
    assert step["IMAD.WIDE"] <= 4.0 and by.get("BAR", 0) == 0, f"the radix step is not what its design says: {step}"


def phase_ntt_fr_design() -> None:
    """The Fr NTT's design (the radix cut, tiles, blocks per SM, the thread
    floor), its plan at the paths' shapes (passes, threads, shared memory,
    radix steps, radix), and the SASS per butterfly of one of its radix-4
    steps (tools/ntt_tiles.py's probe: the multiply-add families, IADD3.X,
    LDS, STS, LDG, BAR) with the multiply-adds a word product of its
    product and of field.cuh's, the parent design's and the other
    kernels'.  A middle step must read no twiddle from device memory (no
    LDG), and a block of a multi-pass plan must fill a warp."""
    from zktpu_torch.poly.ntt_kernel import fr_design, fr_plan
    from zktpu_torch.tools.ntt_tiles import fr_butterfly_sass

    print(f"phase 1: ntt Fr design {json.dumps(fr_design())}", flush=True)
    for lg, batch in ((14, 1), (14, 3), (17, 7), (20, 1), (11, 2048)):
        plan = fr_plan(lg, batch)
        print(f"phase 1: ntt Fr plan 2^{lg} x {batch}: {json.dumps(plan)}", flush=True)
        assert len(plan) == 1 or min(p["threads"] for p in plan) >= 32, f"a block below a warp: {plan}"
    c = fr_butterfly_sass()
    fam = {k: round(v, 2) for k, v in c["per_butterfly"].items()}
    prods = {who: f"{c[key]['instructions']} instructions, {c[key]['multiply_adds_per_word_product']:.3f} "
                  f"multiply-adds a word product " + json.dumps({k: round(v, 3) for k, v in
                                                                  c[key]["per_word_product"].items()})
             for who, key in (("ntt_mul", "product"), ("field.cuh mont_mul_lazy", "field_product"))}
    print(f"phase 1: SASS ntt Fr, per butterfly of a radix-4 step ({c['butterflies']} butterflies): "
          f"{c['instructions']:.2f} instructions; {json.dumps(fam)}; the product: {prods['ntt_mul']}; "
          f"field.cuh's: {prods['field.cuh mont_mul_lazy']}", flush=True)
    assert fam["LDG"] == 0, f"the Fr radix step reads device memory: {fam}"


def phase_kernels(device, parent=None) -> dict:
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.g1_kernel import (
        proj_add, proj_add_plain, proj_double, proj_double_plain, proj_madd, proj_madd_plain,
    )
    from zktpu_torch.curves.host_curve import G1Affine
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FQ, FR, GOLDILOCKS
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_chain, mont_mul_chain_plain, mont_mul_plain

    rng = random.Random(SEED)
    results = {}
    n = (1 << 16) + 3
    for spec, key in ((FR, "mont_mul_fr"), (FQ, "mont_mul_fq"), (GOLDILOCKS, "mont_mul_gl")):
        f = field(spec, device)
        p, L = spec.modulus, spec.num_digits // 2
        a, b = _edge_ints(rng, p, n)
        A, B = f.encode_ints(a), f.encode_ints(b)
        err = _compare(key, [mont_mul(spec, A, B)], [mont_mul_plain(spec, A, B)])
        assert f.decode_ints(mont_mul(spec, A[:8], B[:8])) == [x * y % p for x, y in zip(a[:8], b[:8])]
        ms = _cuda_ms(lambda: mont_mul(spec, A, B), 50)
        plain_ms = _cuda_ms(lambda: mont_mul_plain(spec, A, B), 5)
        _record(results, key, n, err, ms, plain_ms, 3 * n * 4 * L,
                n * (GL_PRODUCT_WORDS if spec is GOLDILOCKS else _mont_words(L)))

        # kernel 5 at the same shape: CHAIN products by b, each body (mxu and f32 need D >= 16)
        if spec is GOLDILOCKS:
            got = mont_mul_chain(spec, A, B, CHAIN)
            _compare(f"mont_mul_chain {spec.name}", [got], [mont_mul_chain_plain(spec, A, B, CHAIN)])
            assert f.decode_ints(got[:8]) == [x * pow(y, CHAIN, p) % p for x, y in zip(a[:8], b[:8])]
            print(f"phase 2: mont_mul_chain {spec.name} n={n} chain={CHAIN} mismatches=0", flush=True)
        else:
            _chain_variants(spec, f, a, b, A, B, results, parent)

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
    plane = n * 4 * 12
    got = proj_add(P1, P2)
    err = _compare("proj_add", got, proj_add_plain(P1, P2))
    assert g1.proj_to_affine_host(tuple(t[:4] for t in got)) == [x + y for x, y in zip(host_p1, host_p2)]
    assert all(int(t[4].abs().sum()) == 0 for t in got)
    ms = _cuda_ms(lambda: proj_add(P1, P2), 20)
    plain_ms = _cuda_ms(lambda: proj_add_plain(P1, P2), 3)
    _record(results, "proj_add", n, err, ms, plain_ms, 9 * plane, 12 * n * _mont_words(12))

    got = proj_double(P1)
    err = _compare("proj_double", got, proj_double_plain(P1))
    assert g1.proj_to_affine_host(tuple(t[:4] for t in got)) == [x + x for x in host_p1]
    ms = _cuda_ms(lambda: proj_double(P1), 20)
    plain_ms = _cuda_ms(lambda: proj_double_plain(P1), 3)
    _record(results, "proj_double", n, err, ms, plain_ms, 6 * plane, 8 * n * _mont_words(12))

    # mixed add: P1 (general Z) + affine points of the chain, with edge lanes
    # 0 and 3: P1 = O; 1: A2 = (0, 0); 2: A2 = affine(P1) (doubling);
    # 5: A2 = -affine(P1); 4: all-zero padding (P1 and A2), which maps to all zero
    Xa, Ya = (t[perm].clone() for t in g1.proj_to_affine_dev(A))
    aff = g1.proj_to_affine_dev(tuple(t[[2, 5]] for t in P1))
    Xa[1] = 0
    Ya[1] = 0
    Xa[2], Ya[2] = aff[0][0], aff[1][0]
    Xa[5], Ya[5] = aff[0][1], fq.neg(aff[1][1])
    Xa[4] = 0
    Ya[4] = 0
    A2 = (Xa, Ya)
    lanes = [0, 1, 2, 3, 5]
    host_m1 = g1.proj_to_affine_host(tuple(t[lanes] for t in P1))
    host_a2 = [G1Affine.identity() if i == 1 else G1Affine(x, y) for i, x, y in
               zip(lanes, fq.decode_ints(Xa[lanes]), fq.decode_ints(Ya[lanes]))]
    assert host_a2[2] == host_m1[2] and host_a2[4] == -host_m1[4]
    got = proj_madd(P1, A2)
    err = _compare("proj_madd", got, proj_madd_plain(P1, A2))
    assert g1.proj_to_affine_host(tuple(t[lanes] for t in got)) == [x + y for x, y in zip(host_m1, host_a2)]
    assert all(int(t[4].abs().sum()) == 0 for t in got)
    ms = _cuda_ms(lambda: proj_madd(P1, A2), 20)
    plain_ms = _cuda_ms(lambda: proj_madd_plain(P1, A2), 3)
    _record(results, "proj_madd", n, err, ms, plain_ms, 8 * plane, 11 * n * _mont_words(12))
    for key, kernel, plain, second in (("proj_add", proj_add, proj_add_plain, P2),
                                       ("proj_madd", proj_madd, proj_madd_plain, A2)):
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"], _strided_lanes(key, kernel, plain, P1, second))
    return results


def _strided_lanes(key: str, kernel, plain, first, second) -> int:
    """The redesigned adds on operands they read in place: for each operand
    coordinate, a (3, n + 5, 12) plane whose row b holds the phase-2 operand
    rolled by b, sliced [:, :n] (first) or [:, 5:] (second); then a broadcast
    second operand, out= into fresh planes, n = 1 and n = 333 (not a multiple
    of the 128-thread block).  The edge lanes come along.  Each against the
    plain version on the same inputs; returns the largest word error (0)."""
    n = first[0].shape[0]

    def planes(coords, lo):
        out = []
        for c in coords:
            t = torch.zeros((3, n + 5, 12), dtype=torch.int32, device=c.device)
            for b in range(3):
                t[b, lo:lo + n] = torch.roll(c, b, 0)
            out.append(t)
        return out

    F, S = planes(first, 0), planes(second, 5)
    err = 0
    for m in (n, 1, 333):
        a1, a2 = tuple(t[:, :m] for t in F), tuple(t[:, 5:5 + m] for t in S)
        err = max(err, _compare(f"{key} strided n={m}", kernel(a1, a2), plain(a1, a2)))
    a1 = tuple(t[:, :n] for t in F)
    one = tuple(t[1, 7] for t in S)  # one point broadcast against every row
    err = max(err, _compare(f"{key} broadcast", kernel(a1, one), plain(a1, one)))
    out = tuple(torch.empty((3, n, 12), dtype=torch.int32, device=F[0].device) for _ in range(3))
    a2 = tuple(t[:, 5:] for t in S)
    assert kernel(a1, a2, out=out) is out
    err = max(err, _compare(f"{key} out=", out, plain(a1, a2)))
    try:
        kernel(a1, a2, out=(F[0][:, 1:n + 1], out[1], out[2]))
    except ValueError:
        pass
    else:
        raise AssertionError(f"{key}: out= overlapping an input was accepted")
    print(f"phase 2: {key} strided (3, n + 5, 12) slices n = {n}, 1, 333, broadcast, out=: mismatches=0; "
          f"overlapping out= raises", flush=True)
    return err


def phase_small_path_shapes(device, results: dict) -> None:
    """proj_double at the (K, 12) accumulators the Horner combine doubled
    before it became one launch (K = 8, the largest commit_many of the PLONK
    path, then K = 1, every MSM's and single commit's; the kernels line takes
    K = 1), mont_mul over Fr at one butterfly stage of the 2^17 coset NTT
    before the NTT kernel (m = 2^9: 2^16 products of a strided odd half by a
    2^8-row twiddle table, the wrapper's copy included), and mont_mul over Fr
    at the coset division's (2^17, 8) pointwise product, which the path
    still runs (the kernels line takes this one; phase_field_turns times its
    kernel alone); each against its plain version."""
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.g1_kernel import proj_double, proj_double_plain
    from zktpu_torch.curves.host_curve import G1Affine
    from zktpu_torch.fields.host import FR
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_plain
    from zktpu_torch.poly.domain import Radix2Domain

    rng = random.Random(SEED + 1)
    G = G1Affine.generator()
    pts = g1.host_points_to_device([G.mul(rng.randrange(1, 1 << 20)) for _ in range(8)], device)
    for K in (8, 1):
        P = tuple(t[:K].clone() for t in pts)
        err = _compare(f"proj_double K={K}", proj_double(P), proj_double_plain(P))
        ms = _cuda_ms(lambda: proj_double(P), 200)
        plain_ms = _cuda_ms(lambda: proj_double_plain(P), 10)
        _record(results, "proj_double", K, max(err, results["proj_double"]["max_abs_err"]), ms, plain_ms,
                6 * K * 48, 8 * K * _mont_words(12), phase=f"phase 2: Horner combine (K={K}, 12):")

    n, m = 1 << 17, 1 << 9
    dom = Radix2Domain(FR, n, device=device)
    fr = dom.df
    x = fr.encode_ints([rng.randrange(FR.modulus) for _ in range(n)])
    odd = x.reshape(n // m, m, 8)[:, m // 2:, :]
    table = dom._fwd_tw[:: n // m][: m // 2]
    err = _compare("mont_mul Fr NTT stage", [mont_mul(FR, odd, table)], [mont_mul_plain(FR, odd, table)])
    ms = _cuda_ms(lambda: mont_mul(FR, odd, table), 50)
    plain_ms = _cuda_ms(lambda: mont_mul_plain(FR, odd, table), 5)
    print(f"phase 2: mont_mul Fr at a 2^17 NTT stage m=2^9 ({n // m}, {m // 2}, 8) x ({m // 2}, 8) (off the "
          f"path since the NTT kernel): mismatches=0 kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
    err = max(err, results["mont_mul_fr"]["max_abs_err"])
    # the coset division's pointwise product by 1/Z_H (plonk/prover.py _coset_divide_zh) at 8n = 2^17
    y = fr.encode_ints([rng.randrange(FR.modulus) for _ in range(n)])
    err = max(err, _compare("mont_mul Fr (2^17, 8) x (2^17, 8)", [mont_mul(FR, x, y)], [mont_mul_plain(FR, x, y)]))
    ms = _cuda_ms(lambda: mont_mul(FR, x, y), 50)
    plain_ms = _cuda_ms(lambda: mont_mul_plain(FR, x, y), 5)
    _record(results, "mont_mul_fr", n, err, ms, plain_ms, 3 * n * 32, n * _mont_words(8),
            phase="phase 2: coset division's product (2^17, 8) x (2^17, 8):")


def _kernel_only_ms(fn, reps: int, name: str) -> tuple[float, int]:
    """Mean device time of the kernels whose name holds `name` over `reps`
    calls of fn, from torch.profiler's trace, and their count.  A trace that
    holds no device event of the kernel (torch.profiler on the H100 machine
    has returned one, after other traces in the same process had worked) is
    taken again, at most three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in events)
        if count:
            return sum(e.self_device_time_total for e in events) / 1e3 / count, count
    raise AssertionError(f"the profiler saw no {name} launch in three traces")


def _ntt_products(n: int, batch: int, factors: int) -> int:
    """Fr products of a batch of transforms: (n/2) log n butterflies and n
    per fused factor, for each row."""
    return batch * ((n // 2) * (n.bit_length() - 1) + factors * n)


def phase_ntt_horner(device, results: dict, ntt_sizes=((17, 7), (20, 1), (16, 9), (14, 3), (17, 1), (1, 3), (8, 3)),
                     horner_shapes=((13, 1, 20), (13, 3, 20), (13, 8, 20), (16, 1, 16)), parent=None) -> None:
    """The NTT kernel against ntt_plain and the one-launch Horner combine
    against its plain loop, 0 mismatching words on every lane.  ntt_sizes:
    (log n, batch), rows 0 and 1 all zero and all p - 1 where the batch has
    three rows or more; the kernels line takes ntt_fr from the first one's
    fft (the path's: _batched_coset_fft's 8n = 2^17 transform of 7
    polynomials at 2^14 gates).  At every call of 2^14 elements or more each
    transform is timed beside its bound (the table's: (n/2) log n products
    and n a factor) and the fft's kernel alone (torch.profiler) beside the
    bound of the products the design issues (ntt_kernel.fr_products); with
    `parent` the fft of the parent's design in turns (this, parent, parent,
    this), its words equal.  horner_shapes: (c, K, W), the PLONK and Nova commits'
    at 2^14 (c = 13, W = 20; K = 1, 3, 8) and the MSM bench's at 2^20; the
    kernels line takes horner_combine from the last.  Each prints ms, the
    microseconds a dependent product step ((W - 1)(2c + 2) of them) and the
    depth figure: the steps times one product's latency, timed alone as a
    chain of dependent products in one warp (tools/horner_lanes.py)."""
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.g1_kernel import horner_combine, horner_combine_plain
    from zktpu_torch.curves.host_curve import G1Affine
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FR
    from zktpu_torch.curves.g1_kernel import proj_add, proj_double
    from zktpu_torch.poly.domain import Radix2Domain
    from zktpu_torch.poly.ntt_kernel import fr_plan, fr_products, ntt, ntt_plain, stage_loop

    fr = field(FR, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def rows(batch, n):
        """Canonical Fr limbs (top limb < 2^29 keeps them < 2^253 < p); row 0
        all zero and row 1 all p - 1 when the batch has them."""
        t = torch.randint(-(1 << 31), 1 << 31, (batch, n, 8), dtype=torch.int64, device=device, generator=gen)
        t[..., 7] &= (1 << 29) - 1
        t = t.to(torch.int32)
        if batch > 2:
            t[0] = 0
            t[1] = fr.encode_int(FR.modulus - 1)
        return t

    err = 0
    for log_n, batch in ntt_sizes:
        n = 1 << log_n
        dom = Radix2Domain(FR, n, device=device)
        x = rows(batch, n)
        g = FR.generator
        lanes = (("fft", False, None, None), ("ifft", True, None, None),
                 ("coset_fft", False, dom.offset_powers(g), None), ("coset_ifft", True, None, dom._coset_out(g)))
        for name, inverse, fin, fout in lanes:
            table = dom._inv_tw if inverse else dom._fwd_tw
            got = ntt(x, table, inverse, fin, fout)
            err = max(err, _compare(f"ntt {name} 2^{log_n} x {batch}", [got], [ntt_plain(x, table, inverse, fin, fout)]))
            if batch << log_n < 1 << 14:
                continue
            run = functools.partial(ntt, x, table, inverse, fin, fout)
            nf = (fin is not None) + (fout is not None) + (inverse and fout is None)
            b = _bound((2 * batch * n + n // 2 + nf * n) * 32, _ntt_products(n, batch, nf) * _mont_words(8))
            if name != "fft":
                print(f"phase 2: ntt {name} (2^{log_n}, 8) x batch {batch}: mismatches=0 "
                      f"kernel_ms={_cuda_ms(run, 20):.4f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']})", flush=True)
                continue
            fns = {"this": run}
            if parent is not None:
                fns["parent"] = functools.partial(parent.poly.ntt_kernel.ntt, x, table, inverse, fin, fout)
                assert torch.equal(fns["parent"](), got), f"ntt fft 2^{log_n} x {batch}: the parent's words differ"
            passes = {"this": len(fr_plan(log_n, batch))}
            if parent is not None:
                before = parent.poly.ntt_kernel.ntt.launches[FR.name]
                fns["parent"]()
                passes["parent"] = parent.poly.ntt_kernel.ntt.launches[FR.name] - before
            turns = _in_turns(fns, lambda fn: _cuda_ms(fn, 50))
            # kernel only, a call: a launch's mean (torch.profiler) times the launches a call
            only = _in_turns(fns, lambda fn: _kernel_only_ms(fn, 50, "ntt_pass_kernel")[0] * passes[
                "this" if fn is run else "parent"])
            issued = _bound(0, fr_products(log_n, batch, 0) * _mont_words(8))["bound_ms"]
            k_only = statistics.fmean(only["this"])
            print(f"phase 2: ntt fft (2^{log_n}, 8) x batch {batch}: mismatches=0, launches {json.dumps(passes)}; with "
                  f"the wrapper, in turns: {_turns_text(turns)}; kernel only {_turns_text(only)}; bound "
                  f"{b['bound_ms']:.5f} ms ({b['bound_by']}), {100 * b['bound_ms'] / k_only:.1f}% of it; the products "
                  f"this design issues ({fr_products(log_n, batch, 0)} against {_ntt_products(n, batch, 0)}) "
                  f"{issued:.5f} ms, {100 * issued / k_only:.1f}%"
                  f"{'' if parent is not None else '; parent not measured (no --parent)'}", flush=True)
            if (log_n, batch) == ntt_sizes[0]:
                plain_ms = _cuda_ms(lambda: ntt_plain(x, table, inverse, fin, fout), 3)
                _record(results, "ntt_fr", n * batch, err, statistics.fmean(turns["this"]), plain_ms,
                        (2 * batch * n + n // 2) * 32, _ntt_products(n, batch, 0) * _mont_words(8),
                        phase=f"phase 2: ntt fft (2^{log_n}, 8) x batch {batch}:")
                results["ntt_fr"]["kernel_only_ms"] = k_only
                # what the kernel replaced: the stage loop over kernel 1 (the Goldilocks route)
                err = max(err, _compare("stage loop over kernel 1", [stage_loop(FR, fr.mont_mul, x, table, inverse)],
                                        [got]))
                loop_ms = _cuda_ms(lambda: stage_loop(FR, fr.mont_mul, x, table, inverse), 5)
                print(f"phase 2: the stage loop over kernel 1 it replaced, same fft: mismatches=0 ms={loop_ms:.4f}",
                      flush=True)
        print(f"phase 2: ntt 2^{log_n} x batch {batch}: fft, ifft, coset_fft, coset_ifft mismatches=0", flush=True)
        del x, dom
    results["ntt_fr"]["max_abs_err"] = err
    torch.cuda.empty_cache()

    from zktpu_torch import cuda_lib
    from zktpu_torch.curves.g1_kernel import FQ, kernel_attrs
    from zktpu_torch.fields.mont_kernel import mont_mul_chain_plain
    from zktpu_torch.tools import horner_lanes

    lib = cuda_lib.load()
    a1, b1 = (torch.randint(0, 1 << 31, (1, 12), dtype=torch.int32, device=device, generator=gen) for _ in range(2))
    a1[..., 11] &= (1 << 28) - 1  # < 2^380 < p
    b1[..., 11] &= (1 << 28) - 1
    _compare("horner product chain", [horner_lanes.mul_chain(lib, a1, b1, 64)], [mont_mul_chain_plain(FQ, a1, b1, 64)])
    chain = 2000
    us_product = 1e3 * _cuda_ms(lambda: horner_lanes.mul_chain(lib, a1, b1, chain), 3) / chain
    P, Gs = horner_lanes.design_of(lib)
    regs = kernel_attrs("horner_combine")["registers"]
    print(f"phase 2: horner_combine design: {P} lanes a product, {Gs} products at once, {regs} registers; one "
          f"product alone (a chain of {chain} in one warp, mismatches=0): {us_product:.4f} us", flush=True)

    rng = random.Random(SEED + 2)
    G = G1Affine.generator()
    err = 0
    for c, K, W in horner_shapes:
        pts = [G.mul(rng.randrange(1, 1 << 30)) for _ in range(W * K)]
        pts[K] = G1Affine.identity()  # window 1, point 0
        if W * K > 2:
            pts[W * K - 1] = G1Affine.identity()  # the top window's last point: the accumulator starts at O
        parts = tuple(t.reshape(W, K, 12) for t in g1.host_points_to_device(pts, device))
        got = horner_combine(parts, c)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = horner_combine_plain(parts, c)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        err = max(err, _compare(f"horner_combine c={c} K={K}", got, want))
        ms = _cuda_ms(lambda: horner_combine(parts, c), 20)

        def launch_loop():  # what the kernel replaced: (W - 1)(c + 1) launches of kernels 2 and 4
            acc = tuple(a[W - 1] for a in parts)
            for w in range(W - 2, -1, -1):
                for _ in range(c):
                    acc = proj_double(acc)
                acc = proj_add(acc, tuple(a[w] for a in parts))
            return acc

        err = max(err, _compare(f"launch loop c={c} K={K}", launch_loop(), got))
        print(f"phase 2: the loop of {(W - 1) * (c + 1)} proj_double/proj_add launches it replaced, c={c} K={K}: "
              f"mismatches=0 ms={_cuda_ms(launch_loop, 5):.4f}", flush=True)
        products = K * (W - 1) * (8 * c + 12)
        steps = horner_lanes.steps(c, W)
        depth_ms = steps * us_product * 1e-3
        _record(results, "horner_combine", K, err, ms, plain_ms, 3 * (W + 1) * K * 48, products * _mont_words(12),
                phase=f"phase 2: horner_combine c={c} K={K} W={W} ({steps} product steps, "
                      f"{1e3 * ms / steps:.4f} us each; {regs} registers; depth {depth_ms:.4f} ms = "
                      f"{100 * depth_ms / ms:.1f}% of the time):")


def _field_rows(f, gen, n: int, cols: int = 1, nonzero: bool = False) -> torch.Tensor:
    """(n, cols, L) canonical Montgomery limbs made on the card (the top limb
    below p's keeps them < p), with 0, 1 and p - 1 in the first rows (1 in
    place of 0 when `nonzero`)."""
    L, p = f.num_limbs, f.spec.modulus
    t = torch.randint(-(1 << 31), 1 << 31, (n, cols, L), dtype=torch.int64, device=f.device, generator=gen)
    t[..., L - 1] &= (1 << ((p.bit_length() - 1) % 32)) - 1
    t = t.to(torch.int32)
    for i, v in enumerate((1 if nonzero else 0, 1, p - 1)[:n]):
        t[i] = f.encode_int(v)
    return t


def _only(kernel_ms, bound_ms: float) -> str:
    """A kernel-only time and its share of the bound, or "not measured"."""
    if not kernel_ms:
        return "not measured (the profiler saw no device event)"
    return f"{kernel_ms:.4f} ms, {100 * bound_ms / kernel_ms:.2f}% of the bound"


def _timed_once(fn):
    """(result, ms) of one call, CUDA events around it (for the slow plain versions)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_field_ops(device, results: dict, log_n: int = 14, fq_log_n: int = 20, parent=None) -> None:
    """Kernels A and B (fields/field_kernel.py) against their plain versions
    at the shapes the paths give them, 0 mismatching words each, with the
    kernel's ms (CUDA events, the wrapper and batch_inv's host copy
    included), its kernel-only ms (torch.profiler, each launch of a call),
    its launches a call, the plain version's ms and the bound; with
    `parent` (another checkout's package, tools/parent.py), the parent
    design's ms and launches, timed in turns (kernel, parent, parent,
    kernel), its words equal.  Fr at 2^log_n gates: the round-2 grand
    product (cumprod, n x 1), the cumsum of divide_by_linear (reverse), the
    powers of Poly.evaluate and of the 8n coset's offsets, the sums of
    evaluate (axis 0) and evaluate_many (axis 1 of (8, n + 3, 8)), the batch
    inversion of round 2, a scan of many tiles (cumprod at 2^20) and one of
    a few rows (5), and the adds of the coset quotient ((8n, 8) operands and
    a broadcast constant) and a sub; Fq: the batch inversion of
    Srs.g1_affine at 2^fq_log_n, a reverse scan and add/sub at 2^16 + 3.
    The kernels line takes field_scan_fr from the grand product,
    field_scan_fq from the Fq batch inversion and field_addsub_fr from the
    (8n, 8) add."""
    from zktpu_torch.fields import field_kernel as fk
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FQ, FR
    from zktpu_torch.tools.trace import launch_device_ms

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    n = 1 << log_n
    fr, fq = field(FR, device), field(FQ, device)
    pk = parent.fields.field_kernel if parent is not None else None

    def check(key, f, name, make, plain, nbytes, words, reps=20, rows=0):
        """make(ops): the call through a field_kernel module's functions,
        against plain on the same inputs; `key`: record it for the kernels
        line."""
        kernel = make(fk)
        before = fk.launches["field_scan"][f.spec.name] + fk.launches["field_addsub"][f.spec.name]
        got = kernel()
        launched = fk.launches["field_scan"][f.spec.name] + fk.launches["field_addsub"][f.spec.name] - before
        plain_out, plain_ms = _timed_once(plain)
        err = _compare(f"{f.spec.name} {name}", [got], [plain_out])
        del plain_out
        turns = {"kernel": []}
        if pk is not None:
            other = make(pk)
            before = pk.launches["field_scan"][f.spec.name] + pk.launches["field_addsub"][f.spec.name]
            assert torch.equal(other(), got), f"{f.spec.name} {name}: the parent design differs"
            parent_launched = pk.launches["field_scan"][f.spec.name] + pk.launches["field_addsub"][f.spec.name] - before
            turns["parent"] = []
            for order in (("kernel", "parent"), ("parent", "kernel")):
                for who in order:
                    turns[who].append(_cuda_ms(kernel if who == "kernel" else other, reps))
        else:
            turns["kernel"].append(_cuda_ms(kernel, reps))
        ms = sum(turns["kernel"]) / len(turns["kernel"])
        kname = "field_addsub_kernel" if name.startswith(("add", "sub", "neg")) else "field_"
        each = launch_device_ms(kernel, kname, reps=2)
        b = _bound(nbytes, words)
        if key:
            _record(results, key, rows, err, ms, plain_ms, nbytes, words, phase=f"phase 2: {f.spec.name} {name}:")
            results[key]["kernel_only_ms"] = sum(each) or None
        parent_txt = (f"parent {sum(turns['parent']) / 2:.4f} ms in {parent_launched} launches (turns "
                      f"{[round(v, 4) for v in turns['parent']]} against {[round(v, 4) for v in turns['kernel']]})"
                      if pk is not None else "parent not measured (no --parent)")
        print(f"phase 2: {f.spec.name} {name}: mismatches=0 kernel_ms={ms:.4f} in {launched} launches, kernel only "
              f"{_only(sum(each), b['bound_ms'])} {[round(v, 4) for v in each]}; {parent_txt}; plain_ms={plain_ms:.4f} "
              f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})", flush=True)
        return err

    E = 32  # bytes of an Fr element; an add counts as L word operations
    mul_w, add_w = _mont_words(8), 8
    err = 0
    x = _field_rows(fr, gen, n)[:, 0]
    err = max(err, check("field_scan_fr", fr, f"cumprod ({n}, 8) (round 2's grand product)",
                         lambda ops: lambda: ops.scan(fr, x, ops.OP_MUL), lambda: fk.scan_plain(fr, x, fk.OP_MUL),
                         2 * n * E, (n - 1) * mul_w, rows=n))
    for rev in (False, True):
        err = max(err, check(None, fr, f"cumsum ({n}, 8) reverse={rev} (divide_by_linear)",
                             lambda ops: lambda: ops.scan(fr, x, ops.OP_ADD, 0, rev),
                             lambda: fk.scan_plain(fr, x, fk.OP_ADD, 0, rev), 2 * n * E, (n - 1) * add_w))
    err = max(err, check(None, fr, f"cumprod ({n}, 8) reverse",
                         lambda ops: lambda: ops.scan(fr, x, ops.OP_MUL, 0, True),
                         lambda: fk.scan_plain(fr, x, fk.OP_MUL, 0, True), 2 * n * E, (n - 1) * mul_w))
    for rows_ in (5, 1 << 20):
        xs = _field_rows(fr, gen, rows_)[:, 0]
        err = max(err, check(None, fr, f"cumprod ({rows_}, 8) ({'a few rows' if rows_ < 32 else 'many tiles'})",
                             lambda ops: lambda: ops.scan(fr, xs, ops.OP_MUL), lambda: fk.scan_plain(fr, xs, fk.OP_MUL),
                             2 * rows_ * E, (rows_ - 1) * mul_w, reps=10))
        del xs
    z = 0x1234567 % FR.modulus
    for count, where in ((n + 3, "Poly.evaluate"), (8 * n, "the 8n coset's offset powers")):
        err = max(err, check(None, fr, f"powers({count}) ({where})", lambda ops: lambda: ops.powers(fr, z, count),
                             lambda: fk.powers_plain(fr, z, count), count * E, (count - 1) * mul_w))
    y = _field_rows(fr, gen, n + 3, 8)
    err = max(err, check(None, fr, f"sum axis 0 of ({n + 3}, 8) (Poly.evaluate)",
                         lambda ops: lambda: ops.field_sum(fr, y[:, 0]), lambda: fk.sum_plain(fr, y[:, 0]),
                         (n + 4) * E, (n + 2) * add_w))
    yt = y.transpose(0, 1)  # (8, n + 3, 8), as evaluate_many stacks its polynomials
    err = max(err, check(None, fr, f"sum axis 1 of (8, {n + 3}, 8) (evaluate_many)",
                         lambda ops: lambda: ops.field_sum(fr, yt, 1), lambda: fk.sum_plain(fr, yt, 1),
                         8 * (n + 4) * E, 8 * (n + 2) * add_w))
    d = _field_rows(fr, gen, n, nonzero=True)[:, 0]
    err = max(err, check(None, fr, f"batch_inv ({n}, 8) (round 2)", lambda ops: lambda: ops.batch_inv(fr, d, FR.inv),
                         lambda: fk.batch_inv_plain(fr, d, FR.inv), 2 * n * E, 3 * (n - 1) * mul_w, reps=10))
    results["field_scan_fr"]["max_abs_err"] = err

    err = 0
    a, b = (_field_rows(fr, gen, 8 * n)[:, 0] for _ in range(2))
    err = max(err, check("field_addsub_fr", fr, f"add ({8 * n}, 8) + ({8 * n}, 8) (the coset quotient)",
                         lambda ops: lambda: ops.add(fr, a, b), lambda: fk.add_plain(fr, a, b), 3 * 8 * n * E,
                         8 * n * add_w, rows=8 * n))
    err = max(err, check(None, fr, f"sub ({8 * n}, 8) - ({8 * n}, 8)", lambda ops: lambda: ops.sub(fr, a, b),
                         lambda: fk.sub_plain(fr, a, b), 3 * 8 * n * E, 8 * n * add_w))
    c = b[5]
    err = max(err, check(None, fr, f"add ({n}, 8) + one constant (round 2's + gamma)",
                         lambda ops: lambda: ops.add(fr, a[:n], c), lambda: fk.add_plain(fr, a[:n], c),
                         (2 * n + 1) * E, n * add_w))
    err = max(err, check(None, fr, f"neg ({n}, 8)", lambda ops: lambda: ops.sub(fr, fr.zero, a[:n]),
                         lambda: fk.sub_plain(fr, torch.zeros_like(a[:n]), a[:n]), 2 * n * E, n * add_w))
    results["field_addsub_fr"]["max_abs_err"] = err
    del a, b, x, y, yt, d

    E = 48
    mul_w, add_w = _mont_words(12), 12
    m = 1 << fq_log_n
    d = _field_rows(fq, gen, m, nonzero=True)[:, 0]
    err = check("field_scan_fq", fq, f"batch_inv ({m}, 12) (Srs.g1_affine)",
                lambda ops: lambda: ops.batch_inv(fq, d, FQ.inv), lambda: fk.batch_inv_plain(fq, d, FQ.inv),
                2 * m * E, 3 * (m - 1) * mul_w, reps=5, rows=m)
    del d
    torch.cuda.empty_cache()
    k = (1 << 16) + 3
    a, b = (_field_rows(fq, gen, k)[:, 0] for _ in range(2))
    err = max(err, check(None, fq, f"cumprod ({k}, 12) reverse", lambda ops: lambda: ops.scan(fq, a, ops.OP_MUL, 0, True),
                         lambda: fk.scan_plain(fq, a, fk.OP_MUL, 0, True), 2 * k * E, (k - 1) * mul_w))
    err = max(err, check(None, fq, f"cumsum ({k}, 12)", lambda ops: lambda: ops.scan(fq, a, ops.OP_ADD),
                         lambda: fk.scan_plain(fq, a, fk.OP_ADD), 2 * k * E, (k - 1) * add_w))
    err = max(err, check(None, fq, f"powers({k})", lambda ops: lambda: ops.powers(fq, z, k),
                         lambda: fk.powers_plain(fq, z, k), k * E, (k - 1) * mul_w))
    err = max(err, check(None, fq, f"sum axis 0 of ({k}, 12)", lambda ops: lambda: ops.field_sum(fq, a),
                         lambda: fk.sum_plain(fq, a), (k + 1) * E, (k - 1) * add_w))
    results["field_scan_fq"]["max_abs_err"] = err
    err = 0
    for name, plain in (("add", fk.add_plain), ("sub", fk.sub_plain)):
        err = max(err, check(None, fq, f"{name} ({k}, 12) (no path adds in Fq: the group-law kernels fuse theirs)",
                             lambda ops: lambda: getattr(ops, name)(fq, a, b), lambda: plain(fq, a, b), 3 * k * E,
                             k * add_w))
    print(f"phase 2: field_addsub Fq mismatches=0 (max_abs_err {err})", flush=True)
    torch.cuda.empty_cache()


def _in_turns(fns: dict, measure) -> dict:
    """{who: [ms, ...]}: measure(fn) of "this" and, when given, "parent", in
    turns (this, parent, parent, this)."""
    order = ("this", "parent", "parent", "this") if "parent" in fns else ("this",)
    out = {who: [] for who in fns}
    for who in order:
        out[who].append(measure(fns[who]))
    return out


def _turns_text(turns: dict) -> str:
    return "; ".join(f"{who} {statistics.fmean(v):.4f} ms {[round(x, 4) for x in v]}" for who, v in turns.items())


def phase_field_turns(device, results: dict, parent=None) -> None:
    """Rows 1 Fr, 1 Fq and 1a Fr with their wrappers (CUDA events) and kernel
    only (torch.profiler), this checkout's and, with `parent`, the parent's,
    in turns, their words equal: mont_mul Fr at the coset division's (2^17,
    8) x (2^17, 8), mont_mul Fq at (2^16 + 3, 12), the Fr add at (2^17, 8).
    Then mont_mul Fr's kernel alone at the shapes whose operand broadcasts,
    in turns with the parent's: (2^20, 8) x (1, 8) (the MSM scalars'
    from_mont: one row, read at 0) and (2^14, 8, 8) x (8, 8) (the coset
    division's 1/Z_H in place: a period of 8, a mask), beside (2^17, 8) x
    (2^17, 8); the parent reads every broadcast row by a 64-bit modulo."""
    from zktpu_torch.fields import field_kernel as fk
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FQ, FR
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 13)
    rows = {}
    for key, spec, n in (("mont_mul_fr", FR, 1 << 17), ("mont_mul_fq", FQ, (1 << 16) + 3), ("field_addsub_fr", FR,
                                                                                             1 << 17)):
        f = field(spec, device)
        a, b = (_field_rows(f, gen, n)[:, 0] for _ in range(2))
        rows[key] = (f, a, b)
        if key.startswith("mont_mul"):
            fns, kname = {"this": lambda: mont_mul(spec, a, b)}, "mont_mul_kernel"
            if parent is not None:
                fns["parent"] = lambda: parent.fields.mont_kernel.mont_mul(spec, a, b)
        else:
            fns, kname = {"this": lambda: fk.add(f, a, b)}, "field_addsub_kernel"
            if parent is not None:
                fns["parent"] = lambda: parent.fields.field_kernel.add(f, a, b)
        got = {who: fn() for who, fn in fns.items()}
        assert all(torch.equal(g, got["this"]) for g in got.values()), f"{key}: the parent's words differ"
        turns = _in_turns(fns, lambda fn: _cuda_ms(fn, 200))
        only = _in_turns(fns, lambda fn: _kernel_only_ms(fn, 50, kname)[0])
        results[key]["ms"] = statistics.fmean(turns["this"])  # the kernels line takes the times in turns
        results[key]["kernel_only_ms"] = statistics.fmean(only["this"])
        print(f"phase 2: {key} ({n}, {f.num_limbs}) with the wrapper, in turns: {_turns_text(turns)}; kernel only "
              f"{_turns_text(only)}; bound {results[key]['bound_ms']:.5f} ms"
              f"{'' if parent is not None else '; parent not measured (no --parent)'}", flush=True)
    f, x, y = rows["mont_mul_fr"]
    big = _field_rows(f, gen, 1 << 20)[:, 0]
    for label, a, b in (("(2^17, 8) x (2^17, 8)", x, y), ("(2^20, 8) x (1, 8)", big, f._one_raw),
                        ("(2^14, 8, 8) x (8, 8)", x.reshape(1 << 14, 8, 8), y[:8])):
        fns = {"this": lambda: mont_mul(FR, a, b)}
        if parent is not None:
            fns["parent"] = lambda: parent.fields.mont_kernel.mont_mul(FR, a, b)
        _compare(f"mont_mul Fr {label}", [fns["this"]()], [mont_mul_plain(FR, a, b)])
        only = _in_turns(fns, lambda fn: _kernel_only_ms(fn, 50, "mont_mul_kernel")[0])
        print(f"phase 2: mont_mul Fr {label} kernel only, in turns: {_turns_text(only)}", flush=True)
    del big


def _field_launches(launches: dict) -> str:
    """The field kernels' launches of a path: rows 1 Fr and Fq, 1a Fr, 1l."""
    return "field launches " + json.dumps({k: launches[k] for k in ("mont_mul_fr", "mont_mul_fq", "field_addsub_fr",
                                                                     "field_lincomb")})


# word products of one row of field_lincomb: 64 a product (a b, schoolbook), then the reduction's nine
# rounds of m_i = t_i (-p^{-1}) and m_i p (8 each) and its product by 2^32 R (a CIOS product)
def _lincomb_words(rows: int, products: int) -> int:
    return rows * (64 * products + 9 + 9 * 8 + _mont_words(8))


def phase_lincomb(device, results: dict, log_n: int = 14) -> None:
    """field_lincomb (fields/lincomb_kernel.py) against its plain chain on
    the card, every word, at the sites' shapes: compute_t's K = 4 at 2^log_n
    (the kernels line's row), fold_witness's two (E: two products by scalars
    and E1; W: one and W1, 2^log_n + 1 rows), w_ev_x's six unequal lengths
    with a row-0 constant, r(X)'s nine terms (two launches), and K + J = 8
    terms of rows 0, 1 and p - 1 with both signs (the accumulator's largest
    sums); each with its ms (CUDA events, the wrapper included), kernel-only
    ms, bound and the plain chain's ms, and the launch chain it replaced
    (row 1 and row 1a launches, as the port ran them before) timed beside."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FR
    from zktpu_torch.fields.lincomb_kernel import lincomb, lincomb_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 14)
    f = field(FR, device)
    p, n = FR.modulus, 1 << log_n
    rng = random.Random(SEED + 14)

    def rows(k):
        return _field_rows(f, gen, k)[:, 0]

    def scalars(k):
        enc = f.encode_ints([rng.randrange(p) for _ in range(k)])
        return [enc[i] for i in range(k)]

    def chain(products, addends):
        """The launches the port ran before: each product, then an add or sub a term, operands padded to the
        longest with zero rows (torch.cat) as Poly's ops pad them."""
        m = max(t.reshape(-1, 8).shape[0] for t in [a for a, _, _ in products] + [c for c, _ in addends])

        def pad(t):
            t = t.reshape(-1, 8)
            return t if t.shape[0] == m else torch.cat([t, zero[: m - t.shape[0]]])

        out = f.zero
        for x, sign in [(f.mont_mul(pad(a), b), sign) for a, b, sign in products] + [(pad(c), s) for c, s in addends]:
            out = (f.add if sign > 0 else f.sub)(out, x)
        return out

    s = scalars(8)
    top = f.encode_int(p - 1).expand(n, 8).contiguous()
    zero = torch.zeros((n + 5, 8), dtype=torch.int32, device=device)
    ev = (rows(n + 5), rows(n + 2), rows(n + 2), rows(n + 2), rows(n), rows(n))
    cases = {
        f"compute_t K=4 ({n}, 8)": ([(rows(n), rows(n), 1), (rows(n), rows(n), 1), (rows(n), s[0], -1),
                                     (rows(n), s[1], -1)], []),
        f"fold_witness E ({n}, 8)": ([(rows(n), s[2], 1), (rows(n), s[3], 1)], [(rows(n), 1)]),
        f"fold_witness W ({n + 1}, 8)": ([(rows(n + 1), s[2], 1)], [(rows(n + 1), 1)]),
        f"w_ev_x six lengths {[t.shape[0] for t in ev]}": ([(t, k, 1) for t, k in zip(ev[1:], s[3:8])],
                                                           [(ev[0], 1), (s[0], -1)]),
        "r(X) nine terms, two launches": ([(ev[k % 6], s[k], (-1) ** k) for k in range(7)], [(ev[2], 1), (s[7], 1)]),
        "edges: 8 terms of 0, 1, p - 1, +": ([(top, top, 1), (top, top, 1), (top, s[0], 1), (zero[:n], top, 1),
                                               (rows(n), top[:1], 1)], [(top, 1), (zero[:n], 1), (rows(n), 1)]),
        "edges: 8 terms of 0, 1, p - 1, -": ([(top, top, -1), (top, top, -1), (top, s[0], -1), (zero[:n], top, -1),
                                               (rows(n), top[:1], -1)], [(top, -1), (zero[:n], -1), (rows(n), -1)]),
    }
    err = 0
    for name, (products, addends) in cases.items():
        before = lincomb.launches
        got = lincomb(f, products, addends)
        launched = lincomb.launches - before
        want, plain_ms = _timed_once(lambda: lincomb_plain(f, products, addends))
        err = max(err, _compare(f"field_lincomb {name}", [got], [want]))
        m = got.shape[0]
        K = len(products)
        nbytes = 32 * (sum(a.shape[0] + b.reshape(-1, 8).shape[0] for a, b, _ in products)
                       + sum(c.reshape(-1, 8).shape[0] for c, _ in addends) + m)
        b = _bound(nbytes, _lincomb_words(m, K))
        ms = _cuda_ms(lambda: lincomb(f, products, addends), 200)
        k_ms, _ = _kernel_only_ms(lambda: lincomb(f, products, addends), 50, "lincomb_kernel")
        chain_ms = _cuda_ms(lambda: chain(products, addends), 50)
        assert torch.equal(chain(products, addends), got), f"field_lincomb {name}: the launch chain's words differ"
        if name.startswith("compute_t"):
            results["field_lincomb"] = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "n": m, **b,
                                        "kernel_only_ms": k_ms}
        print(f"phase 2: field_lincomb {name}: mismatches=0 in {launched} launch(es), kernel_ms={ms:.4f} kernel only "
              f"{_only(k_ms * launched, b['bound_ms'])}; the launch chain it replaced ({K} products, "
              f"{len(products) + len(addends) - 1} adds/subs) {chain_ms:.4f} ms; plain_ms={plain_ms:.4f} "
              f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})", flush=True)
    results["field_lincomb"]["max_abs_err"] = err


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
    from zktpu_torch.transcript.chacha import StdRng

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


def phase_plonk(device, log_n: int) -> tuple[dict, dict]:
    import dataclasses

    from zktpu_torch.fields.host import FR
    from zktpu_torch.kzg import Srs
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.plonk.synthetic import synthetic_mul_chain
    from zktpu_torch.plonk.verifier import PlonkVerificationError, verify
    from zktpu_torch.transcript.chacha import StdRng

    from zktpu_torch.fields.limbs import resolve

    launch_counts.reset()
    t0 = time.perf_counter()
    circuit = synthetic_mul_chain(log_n, seed=1, device=device)
    srs = Srs.new_from_secret(SRS_SECRET, circuit.size, device=device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    timings = {}
    resolve.cuda_calls = 0
    t0 = time.perf_counter()
    proof = generate_proof(circuit, srs, StdRng.from_seed_u64(SEED), timings=timings)
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify(circuit, srs, proof)
    t_verify = time.perf_counter() - t0
    plain_carries = resolve.cuda_calls
    launches = launch_counts.read()
    path = ("mont_mul_fr", "mont_mul_fq", "proj_add", "ntt_fr", "horner_combine", "field_scan_fr", "field_addsub_fr",
            "fixed_base_mul", "field_lincomb")
    assert all(launches[k] > 0 for k in path), f"a kernel of the PLONK path never launched: {launches}"
    assert launches["proj_double"] == 0, f"the PLONK path doubled outside the Horner combine: {launches}"
    # no plain version runs on the card: every carry scan of limbs.resolve on a CUDA tensor is one
    assert plain_carries == 0, f"prove + verify ran {plain_carries} plain carry scans (limbs.resolve) on the card"

    kept = dataclasses.replace(proof)  # phases 10 and 11 take the untampered proof
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
    print(f"phase 4: launches {json.dumps(launches)}; limbs.resolve on CUDA tensors during prove + verify: "
          f"{plain_carries}", flush=True)
    print(f"phase 4: {_field_launches(launches)}", flush=True)
    print(f"phase 4: one traced prove (outside the count): {_traced_prove(circuit, srs)}", flush=True)
    return launches, {"circuit": circuit, "srs": srs, "proof": kept}


def _traced_prove(circuit, srs) -> str:
    """One prove under torch.profiler (zktpu_torch.tools.prof_prove): its
    CUDA kernel launches, device time and wall time; the table by device
    time goes to stderr."""
    from zktpu_torch.tools.prof_prove import trace_prove

    t, table = trace_prove(circuit, srs, SEED)
    print(table, file=sys.stderr)
    scan_ms, scans = t["by_name_ms"].get("field_scan_kernel", (0.0, 0))
    return (f"{t['launch_calls']} kernel launch calls, {t['device_kernels']} device kernels, wall {t['wall_s']:.3f} s, "
            f"device {t['device_s']:.3f} s (idle {100 * t['idle_share']:.1f}%); field_scan_kernel {scan_ms:.4f} ms "
            f"over {scans} launches")


def phase_msm(device, log_n: int):
    """The MSM path at 2^log_n through zktpu_torch.bench (counted: the setup,
    the first call and 2 timed calls of each MSM), its checks (not counted),
    then the microbench as a path of its own (counted).  Returns the launches
    of both paths and the bench's inputs."""
    from zktpu_torch import bench
    from zktpu_torch.curves import g1, msm
    from zktpu_torch.curves.host_curve import G1Affine
    from zktpu_torch.fields.host import FQ, FR, GOLDILOCKS
    from zktpu_torch.tools import prof_mulkernels

    launch_counts.reset()
    t0 = time.perf_counter()
    inputs = bench.make_inputs(log_n, device)
    setup = {k: round(v, 3) for k, v in inputs["seconds"].items()}
    print(f"phase 5: setup 2^{log_n} points and scalars {time.perf_counter() - t0:.3f} s {json.dumps(setup)}",
          flush=True)
    r = bench.run(log_n, iters=2, device=device, inputs=inputs)  # asserts msm_affine == msm_proj
    launches = launch_counts.read()
    path = ("mont_mul_fq", "proj_add", "proj_madd", "horner_combine", "field_scan_fr", "field_scan_fq")
    assert all(launches[k] > 0 for k in path), f"a kernel of the MSM path never launched: {launches}"
    assert launches["proj_double"] == 0, f"the MSM path doubled outside the Horner combine: {launches}"

    # the whole 2^log_n result against the host: sum s_i tau^i G = (sum s_i tau^i) G
    t0 = time.perf_counter()
    e, pw = 0, 1
    for s in inputs["scalars"]:
        e = (e + s * pw) % FR.modulus
        pw = pw * bench.TAU % FR.modulus
    G = G1Affine.generator()
    assert r["result"] == G.mul(e), "the 2^n MSM differs from the host's tau-power sum"

    # spot check: the first 64 points against host curve arithmetic
    m = min(64, r["n"])
    sc, Xa, Ya = inputs["sc"][:m], inputs["Xa"][:m], inputs["Ya"][:m]
    pts = g1.proj_to_affine_host(g1.affine_to_proj(Xa, Ya))
    assert pts == [G.mul(pow(bench.TAU, i, FR.modulus)) for i in range(m)]
    want = G1Affine.identity()
    for s, p in zip(inputs["scalars"][:m], pts):
        want = want + p.mul(s)
    Z1 = g1.proj_identity((m,), device)[1]  # the Montgomery one
    c = msm.pick_window(m)
    got = g1.proj_to_affine_host(tuple(
        torch.stack([a, b]) for a, b in zip(msm.msm_affine(sc, Xa, Ya, c=c), msm.msm_proj(sc, Xa, Ya, Z1, c=c))
    ))
    assert got == [want, want], "the 64-point MSMs differ from host curve arithmetic"
    t_check = time.perf_counter() - t0
    print(
        f"phase 5: msm 2^{log_n} c={r['window']}: msm_proj {r['msm_proj_s']:.4f} s "
        f"({r['msm_proj_points_per_s']:.1f} points/s), msm_affine {r['msm_affine_s']:.4f} s "
        f"({r['msm_affine_points_per_s']:.1f} points/s); msm_affine == msm_proj == host tau-power sum, "
        f"first {m} points == host curve arithmetic (checks {t_check:.2f} s); "
        f"max_memory_allocated {r['max_memory_allocated']} bytes",
        flush=True,
    )
    print(f"phase 5: launches {json.dumps(launches)}", flush=True)

    launch_counts.reset()
    # the tool's field is Fq; Fr and Goldilocks for comparison (Goldilocks: base only, D < 16)
    for spec in (FQ, FR, GOLDILOCKS):
        variants = ("base",) if spec is GOLDILOCKS else prof_mulkernels.VARIANTS
        for row in prof_mulkernels.run(1 << 16, CHAIN, spec, variants, device=device):
            print(f"phase 5: prof_mulkernels {spec.name} {row['variant']} N={row['n']} CHAIN={row['chain']}: "
                  f"{row['ms_per_mul']:.5f} ms/mul, {row['mmul_per_s']:.2f} Mmul/s, MATCH", flush=True)
    tool = launch_counts.read()
    chains = ("mont_mul_chain", "mont_mul_chain_mxu", "mont_mul_chain_f32")
    assert all(tool[k] > 0 for k in chains), f"the microbench never launched a body's kernel: {tool}"
    print(f"phase 5: microbench launches {json.dumps(tool)}", flush=True)
    return launches, tool, inputs


def phase_path_shapes(device, inputs: dict, results: dict) -> None:
    """proj_madd and proj_add against their plain versions on the operands
    that the MSMs on the bench's inputs give them: msm_affine's last phase-1
    mixed add (every window's blocks at once) and the first step of its
    block-total scan, and the first step of msm_proj's doubling scan
    (curves/scan.py), where msm_proj spends its proj_add time, each into
    the out= planes the path gave it.  The kernels line takes proj_madd from
    the first shape and proj_add from the last.
    The plain versions run in chunks of 2^18 rows (their int64 temporaries)
    and are timed over all chunks.  These launches are outside the counted
    paths."""
    from zktpu_torch.curves import g1, msm, scan
    from zktpu_torch.curves.g1_kernel import proj_add_plain, proj_madd_plain

    real = {"proj_madd": scan.proj_madd, "proj_add": scan.proj_add}
    sc, Xa, Ya = inputs["sc"], inputs["Xa"], inputs["Ya"]
    c = msm.pick_window(sc.shape[0])

    def capture(run, name, keep_last):
        seen = {}

        def call(*args, **kwargs):
            if keep_last or name not in seen:
                seen[name] = args, kwargs
            return real[name](*args, **kwargs)

        setattr(scan, name, call)
        try:
            run()
        finally:
            setattr(scan, name, real[name])
        return seen[name]

    cases = (
        ("proj_madd", "msm_affine's operands", lambda: msm.msm_affine(sc, Xa, Ya, c=c), True),
        ("proj_add", "msm_affine's operands", lambda: msm.msm_affine(sc, Xa, Ya, c=c), False),
        ("proj_add", "msm_proj's first scan step",
         lambda: msm.msm_proj(sc, Xa, Ya, g1.proj_identity((sc.shape[0],), device)[1], c=c), False),
    )
    chunk = 1 << 18
    planes, muls = {"proj_madd": 8, "proj_add": 9}, {"proj_madd": 11, "proj_add": 12}
    for key, where, run, keep_last in cases:
        (a1, a2), kw = capture(run, key, keep_last)  # kw: the path's out= planes, if it gave them
        plain = proj_madd_plain if key == "proj_madd" else proj_add_plain
        kernel = real[key]
        shape = tuple(a1[0].shape[:-1])
        got = [t.reshape(-1, 12) for t in kernel(a1, a2, **kw)]
        f1, f2 = ([t.reshape(-1, 12) for t in a] for a in (a1, a2))
        n = f1[0].shape[0]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        parts = [plain(tuple(t[i:i + chunk] for t in f1), tuple(t[i:i + chunk] for t in f2))
                 for i in range(0, n, chunk)]
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        err = _compare(f"{key} at {where}", got, [torch.cat([p[j] for p in parts]) for j in range(3)])
        del got, parts, f1, f2
        ms = _cuda_ms(lambda: kernel(a1, a2, **kw), 20)
        prev = results[key]["max_abs_err"]
        _record(results, key, n, max(err, prev), ms, plain_ms, planes[key] * n * 4 * 12,
                muls[key] * n * _mont_words(12), phase=f"phase 5: at {where} {shape}:")
        del a1, a2, kw
        torch.cuda.empty_cache()


def _gl_rows(f, gen, batch: int, n: int) -> torch.Tensor:
    """(batch, n, 2) canonical Goldilocks Montgomery limbs made on the card
    (top limb below 2^31 keeps them < p); row 0 all zero and row 1 all
    p - 1 when the batch has three rows, else those values at the front."""
    t = torch.randint(-(1 << 31), 1 << 31, (batch, n, 2), dtype=torch.int64, device=f.device, generator=gen)
    t[..., 1] &= (1 << 31) - 1
    t = t.to(torch.int32)
    if batch >= 3:
        t[0] = 0
        t[1] = f.encode_int(f.spec.modulus - 1)
    else:
        t[0, : min(n, 2)] = torch.stack([f.zero, f.encode_int(f.spec.modulus - 1)])[: min(n, 2)]
    return t


def _hash_edge_values(gen, n: int, device) -> torch.Tensor:
    """n canonical Goldilocks values on the card ((n, 2) limbs), with every
    digit-length edge (10^k - 1, 10^k), 0, 2^32 +- 1 and p - 1 at the front
    and scattered through the rest."""
    from zktpu_torch.fields.fp import ints_to_limbs
    from zktpu_torch.fields.host import GOLDILOCKS

    p = GOLDILOCKS.modulus
    edges = [0, 2**32 - 1, 2**32, 2**32 + 1, p - 2, p - 1] + [v for k in range(1, 20) for v in (10**k - 1, 10**k)]
    t = torch.randint(-(1 << 31), 1 << 31, (n, 2), dtype=torch.int64, device=device, generator=gen)
    t[:, 1] &= (1 << 31) - 1
    t = t.to(torch.int32)
    e = torch.from_numpy(ints_to_limbs(edges, 2)).to(device)
    t[: len(edges)] = e
    pos = torch.randint(0, n, (8 * len(edges),), device=device, generator=gen)
    t[pos] = e.repeat(8, 1)
    return t


def phase_fri_kernels(device, results: dict, log_n: int = 20) -> None:
    """Kernels 1g (the Goldilocks NTT), 6 (the field hash) and the FRI fold
    against their plain versions on the card, 0 mismatching words: the
    NTT's fft, ifft, coset_fft, coset_ifft and coset_fft with the raw-1
    output factor (FRI's fused from_mont) at 2^log_n x 1, 2^13 x 3, n = 2 x
    3, 2^8 x 3, 2^16 and 2^22 (an all-zero row and a row of p - 1, or those
    values at the front of a single row), its coset_fft timed with the
    wrapper and kernel only (torch.profiler) at 2^16, 2^log_n and 2^22; the
    hash in single mode at 2^log_n values and in pair mode at 2^(log_n - 1)
    pairs, digit-length edges mixed in, and its first 64 outputs against
    hashlib; the fold at the first fold's 2^(log_n - 1) coefficients.  The
    NTT's bound: its bytes (input and output rows, the n/2 twiddles and the
    n offset powers once), or its products' multiply-adds, four word
    products a product (gl_mul), over the integer rate; the bound of the
    CIOS product it replaced (ten word products) is printed beside it.  The
    hash's bound counts the 32-bit integer instructions of one hash from
    the SASS of this build (prof_fri.hash_int_ops, cuobjdump) over both
    integer pipes.  The kernels line takes ntt_gl from FRI layer 0's
    coset_fft at 2^log_n, sha256_field from the single mode (layer 0's
    leaves) and fri_fold from the first fold."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import GOLDILOCKS
    from zktpu_torch.fri.fold_kernel import fold, fold_plain
    from zktpu_torch.hash import host_hash
    from zktpu_torch.hash.sha256_kernel import hash_field, hash_field_plain
    from zktpu_torch.poly.domain import Radix2Domain
    from zktpu_torch.poly.ntt_kernel import ntt, ntt_plain
    from zktpu_torch.tools.prof_fri import hash_int_ops

    gl = field(GOLDILOCKS, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    ops = hash_int_ops()
    print(f"phase 2: sha256_field SASS: {ops['single']} integer instructions a hash (single), {ops['pairs']} (pairs); "
          f"shifts and logic {ops['single_shf_lop3']} / {ops['pairs_shf_lop3']}", flush=True)
    err = 0
    for lg, batch in ((log_n, 1), (13, 3), (1, 3), (8, 3), (16, 1), (22, 1)):
        n = 1 << lg
        dom = Radix2Domain(GOLDILOCKS, n, device=device)
        x = _gl_rows(gl, gen, batch, n)
        g = GOLDILOCKS.generator
        lanes = (("fft", False, None, None), ("ifft", True, None, None),
                 ("coset_fft", False, dom.offset_powers(g), None), ("coset_ifft", True, None, dom._coset_out(g)),
                 ("coset_fft raw-1 out", False, dom.offset_powers(g), gl._one_raw))
        for name, inverse, fin, fout in lanes:
            table = dom._inv_tw if inverse else dom._fwd_tw
            got = ntt(x, table, inverse, fin, fout, GOLDILOCKS)
            want, plain_ms = _timed_once(lambda: ntt_plain(x, table, inverse, fin, fout, GOLDILOCKS))
            err = max(err, _compare(f"ntt Goldilocks {name} 2^{lg} x {batch}", [got], [want]))
            if batch == 1 and lg in (16, log_n, 22) and name == "coset_fft":  # FRI's transforms
                run = lambda: ntt(x, table, inverse, fin, fout, GOLDILOCKS)  # noqa: E731
                ms = _cuda_ms(run, 50)
                k_ms, count = _kernel_only_ms(run, 50, "ntt_gl_kernel")
                products = _ntt_products(n, batch, 1)
                nbytes = (2 * batch * n + n // 2 + n) * 8
                old = _bound(nbytes, products * _mont_words(2))
                where = f"phase 2: ntt Goldilocks coset_fft (2^{lg}, 2) x {batch}:"
                if lg == log_n:  # FRI layer 0's transform: its row in the kernels line
                    _record(results, "ntt_gl", n * batch, err, ms, plain_ms, nbytes, products * GL_PRODUCT_WORDS,
                            phase=where)
                    results["ntt_gl"]["kernel_only_ms"] = k_ms * count / 50
                    b = results["ntt_gl"]
                else:
                    b = _bound(nbytes, products * GL_PRODUCT_WORDS)
                    print(f"{where} mismatches=0 kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                          f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})", flush=True)
                print(f"{where} kernel only (torch.profiler) {k_ms * count / 50:.4f} ms a transform "
                      f"({count // 50} launches); {b['bound_ms'] / (k_ms * count / 50):.1%} of the bound "
                      f"(the CIOS count's bound: {old['bound_ms']:.5f} ms, {old['bound_by']})", flush=True)
        print(f"phase 2: ntt Goldilocks 2^{lg} x batch {batch}: fft, ifft, coset_fft, coset_ifft, coset_fft with "
              f"the raw-1 output factor mismatches=0", flush=True)
        del x, dom
    results["ntt_gl"]["max_abs_err"] = err
    torch.cuda.empty_cache()

    # the fold at the first fold's shape: 2^(log_n - 1) coefficients in, 2^(log_n - 2) out
    m = 1 << (log_n - 1)
    c = _gl_rows(gl, gen, 1, m)[0]
    r = GOLDILOCKS.modulus - 1
    got = fold(GOLDILOCKS, c, r)
    want, plain_ms = _timed_once(lambda: fold_plain(GOLDILOCKS, c, r))
    err = _compare("fri fold", [got], [want])
    for rr in (0, 1, 12345):
        err = max(err, _compare(f"fri fold r={rr}", [fold(GOLDILOCKS, c[:-1], rr)], [fold_plain(GOLDILOCKS, c[:-1], rr)]))
    ms = _cuda_ms(lambda: fold(GOLDILOCKS, c, r), 50)
    _record(results, "fri_fold", m, err, ms, plain_ms, (m + m // 2) * 8, (m // 2) * GL_PRODUCT_WORDS,
            phase=f"phase 2: fri fold ({m}, 2) -> ({m // 2}, 2) (and {m - 1} coefficients, odd):")
    k_ms, count = _kernel_only_ms(lambda: fold(GOLDILOCKS, c, r), 50, "fri_fold_kernel")
    results["fri_fold"]["kernel_only_ms"] = k_ms
    print(f"phase 2: fri fold kernel only (torch.profiler, {count} launches): {k_ms:.4f} ms", flush=True)
    del c, got, want

    # row 1s Goldilocks: the powers kernel at the largest table the FRI path builds, (2^(log_n - 1), 2)
    from zktpu_torch.fields import field_kernel as fk

    z, count = GOLDILOCKS.root_of_unity(1 << log_n), 1 << (log_n - 1)
    _compare("field_scan Goldilocks powers", [gl.powers(z, count)], [fk.powers_plain(gl, z, count)])
    ms = _cuda_ms(lambda: gl.powers(z, count), 50)
    k_ms, launches = _kernel_only_ms(lambda: gl.powers(z, count), 50, "field_powers_kernel")
    b = _bound(count * 8, (count - 1) * GL_PRODUCT_WORDS)
    print(f"phase 2: field_scan Goldilocks powers({count}) ({count}, 2): mismatches=0 kernel_ms={ms:.4f} "
          f"field_powers_kernel only (torch.profiler, {launches} launches) {k_ms:.4f} ms, "
          f"{100 * b['bound_ms'] / k_ms:.1f}% of the bound {b['bound_ms']:.5f} ({b['bound_by']})", flush=True)

    n = 1 << log_n
    x = _hash_edge_values(gen, n, device)
    err = 0
    for pairs in (False, True):
        got = hash_field(x, pairs)
        want, plain_ms = _timed_once(lambda: hash_field_plain(x, pairs))
        mode = "pairs" if pairs else "single"
        err = max(err, _compare(f"sha256_field {mode} n={n}", [got], [want]))
        vals = x[:128].cpu().numpy().view("<u8")[:, 0].tolist()
        ints = got[:64].cpu().numpy().view("<u8")[:, 0].tolist()
        host = ([host_hash.hash_slice(GOLDILOCKS, vals[2 * i : 2 * i + 2]) for i in range(64)] if pairs
                else [host_hash.hash_elem(GOLDILOCKS, v) for v in vals[:64]])
        assert ints == host, f"sha256_field {mode}: the first 64 hashes differ from hashlib"
        ms = _cuda_ms(lambda: hash_field(x, pairs), 20)
        out_rows = n // 2 if pairs else n
        nbytes, int_ops = n * 8 + out_rows * 8, out_rows * ops["pairs" if pairs else "single"]
        if not pairs:
            _record(results, "sha256_field", n, err, ms, plain_ms, nbytes, 0,
                    phase=f"phase 2: sha256_field single ({n}, 2):", int_ops=int_ops)
        else:
            b = _bound(nbytes, 0, int_ops)
            print(f"phase 2: sha256_field pairs ({n // 2} pairs): mismatches=0 kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']})", flush=True)
    results["sha256_field"]["max_abs_err"] = err
    print(f"phase 2: sha256_field: first 64 hashes of each mode == hashlib", flush=True)
    del x
    torch.cuda.empty_cache()


def _host_merkle_root(values: list[int]) -> int:
    """The reference tree's root with hashlib alone (fri/src/merkle_tree.rs:
    level 0 hashes each value, each level above hashes pairs)."""
    import hashlib

    p = (1 << 64) - (1 << 32) + 1

    def h(data: bytes) -> int:
        return int.from_bytes(hashlib.sha256(data).digest(), "little") % p

    level = [h(str(v).encode()) for v in values]
    while len(level) > 1:
        level = [h(b"".join(str(v).encode() for v in level[i : i + 2])) for i in range(0, len(level), 2)]
    return level[0]


def phase_fri(device, log_n: int, results: dict) -> tuple[dict, object]:
    """The FRI path: generate_proof on the card for 2^(log_n - 1) Goldilocks
    coefficients from SEED (blowup 2: a 2^log_n domain, log_n layers) and 32
    queries, then the host verify; launches counted from 0 just before the
    prove and read just after the verify.  Outside the count: the verifier
    rejects the proof with one evaluation and with one root changed; layer
    0's root equals a hashlib Merkle root over layer 0's evaluations read
    from the card, 64 of which equal host evaluations at coset w^i; a
    2^12-domain proof from the card equals the CPU's; mont_mul and the
    add/sub over Goldilocks timed at the path's shapes (from_mont at
    2^log_n, the first fold's (2^(log_n - 2), 2)) and the powers at the
    domain's twiddle table (2^(log_n - 1)); prove and verify seconds
    at 2^12, 2^16 and 2^log_n (median of 3 warm runs)."""
    import copy

    from zktpu_torch.convert import fri_proof_to_ints
    from zktpu_torch.fields import field_kernel as fk
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import GOLDILOCKS
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_plain
    from zktpu_torch.fri.layer import FriLayer
    from zktpu_torch.fri.prover import generate_proof
    from zktpu_torch.fri.verifier import FriVerificationError, verify
    from zktpu_torch.poly.poly import Poly
    from zktpu_torch.tools.prof_fri import QUERIES, fri_poly, timed_runs

    p = GOLDILOCKS.modulus
    poly, coeffs = fri_poly(log_n - 1, SEED, device)
    torch.cuda.synchronize()
    launch_counts.reset()
    t0 = time.perf_counter()
    proof = generate_proof(poly, 2, QUERIES)
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify(proof)
    t_verify = time.perf_counter() - t0
    launches = launch_counts.read()
    path = ("ntt_gl", "sha256_field", "fri_fold", "field_scan_gl")
    assert all(launches[k] > 0 for k in path), f"a kernel of the FRI path never launched: {launches}"
    assert launches["fri_fold"] == log_n - 1, f"the fold did not launch once a layer: {launches}"
    assert launches["mont_mul_gl"] == launches["field_addsub_gl"] == 0, \
        f"the FRI path launched the Goldilocks product or add/sub: {launches}"
    assert proof.domain_size == 1 << log_n and len(proof.layers_root) == log_n
    print(f"phase 6: FRI 2^{log_n} domain, {log_n} layers, {QUERIES} queries: first prove {t_prove:.3f} s "
          f"(domain tables built), verify {t_verify:.3f} s; the host verifier accepts", flush=True)
    print(f"phase 6: launches {json.dumps(launches)}", flush=True)

    evaluation, root = copy.deepcopy(proof), copy.deepcopy(proof)
    evaluation.decommitment_list[3].evaluations[5] = (evaluation.decommitment_list[3].evaluations[5] + 1) % p
    root.layers_root[7] = (root.layers_root[7] + 1) % p
    for what, bad in (("one evaluation", evaluation), ("one root", root)):
        try:
            verify(bad)
        except FriVerificationError:
            continue
        raise AssertionError(f"FRI: a proof with {what} changed was accepted")
    print("phase 6: the verifier rejects the proof with one evaluation changed and with one root changed", flush=True)

    t0 = time.perf_counter()
    layer0 = FriLayer.from_poly(poly, GOLDILOCKS.generator, 1 << log_n)
    assert layer0.merkle_tree.root() == proof.layers_root[0]
    evals = layer0.evaluations.cpu().numpy().view("<u8")[:, 0].tolist()
    assert _host_merkle_root(evals) == proof.layers_root[0], "layer 0's root differs from the hashlib tree's"
    w = GOLDILOCKS.root_of_unity(1 << log_n)
    cs = [int(c) for c in coeffs]
    for i in random.Random(SEED).sample(range(1 << log_n), 64):
        x = GOLDILOCKS.generator * pow(w, i, p) % p
        acc = 0
        for c in reversed(cs):
            acc = (acc * x + c) % p
        assert evals[i] == acc, f"layer 0 evaluation {i} differs from the host's p(coset w^i)"
    print(f"phase 6: layer 0's root == hashlib Merkle root over its 2^{log_n} evaluations from the card; 64 of them "
          f"== host p(coset w^i) ({time.perf_counter() - t0:.1f} s)", flush=True)

    small = [int(v) for v in coeffs[:1 << 11]]
    gpu = generate_proof(Poly.from_ints(GOLDILOCKS, small, device=device), 2, QUERIES)
    cpu = generate_proof(Poly.from_ints(GOLDILOCKS, small, device="cpu"), 2, QUERIES)
    assert fri_proof_to_ints(gpu) == fri_proof_to_ints(cpu), "the 2^12-domain FRI proof from the card differs from the CPU's"
    print("phase 6: 2^12-domain proof from the card == the CPU's (fri_proof_to_ints)", flush=True)

    # the Goldilocks product and add/sub at the shapes the path gave them before the NTT took from_mont and
    # the fold became one kernel (their rows in the kernels line)
    gl = field(GOLDILOCKS, device)
    ev = FriLayer.from_poly(poly, GOLDILOCKS.generator, 1 << log_n, force_device=True).evaluations
    mont = gl.to_mont(ev)
    one = gl._one_raw
    got = mont_mul(GOLDILOCKS, mont, one)
    want, plain_ms = _timed_once(lambda: mont_mul_plain(GOLDILOCKS, mont, one))
    err = max(_compare("mont_mul Goldilocks from_mont", [got], [want]), results["mont_mul_gl"]["max_abs_err"])
    ms = _cuda_ms(lambda: mont_mul(GOLDILOCKS, mont, one), 50)
    n = mont.shape[0]
    _record(results, "mont_mul_gl", n, err, ms, plain_ms, (2 * n + 1) * 8, n * GL_PRODUCT_WORDS,
            phase=f"phase 6: mont_mul Goldilocks at from_mont ({n}, 2) x (2,):")
    even, odd = poly.coeffs[0::2].contiguous(), poly.coeffs[1::2].contiguous()
    odd_r = gl.mont_mul(odd, gl.encode_int(12345))
    got = gl.add(even, odd_r)
    want, plain_ms = _timed_once(lambda: fk.add_plain(gl, even, odd_r))
    err = _compare("field_addsub Goldilocks fold", [got], [want])
    ms = _cuda_ms(lambda: gl.add(even, odd_r), 50)
    m = even.shape[0]
    _record(results, "field_addsub_gl", m, err, ms, plain_ms, 3 * m * 8, m * 2,
            phase=f"phase 6: field_addsub Goldilocks at the first fold ({m}, 2) + ({m}, 2):")
    # the largest power table the path builds: the 2^log_n domain's n/2 twiddles
    g, count = GOLDILOCKS.root_of_unity(1 << log_n), 1 << (log_n - 1)
    got = gl.powers(g, count)
    want, plain_ms = _timed_once(lambda: fk.powers_plain(gl, g, count))
    err = _compare("field_scan Goldilocks powers", [got], [want])
    ms = _cuda_ms(lambda: gl.powers(g, count), 50)
    _record(results, "field_scan_gl", count, err, ms, plain_ms, count * 8, (count - 1) * GL_PRODUCT_WORDS,
            phase=f"phase 6: field_scan Goldilocks powers({count}) (the 2^{log_n} domain's twiddles):")
    del ev, mont, got, want, even, odd, odd_r, layer0

    for lg in sorted({12, 16, log_n}):
        pl = poly if lg == log_n else fri_poly(lg - 1, SEED, device)[0]
        generate_proof(pl, 2, QUERIES)  # warm: this size's domain tables
        r = timed_runs(pl, 2, QUERIES, 3)
        print(f"phase 6: FRI 2^{lg} domain ({QUERIES} queries): prove median {r['prove_median_s']:.4f} s "
              f"{[round(v, 4) for v in r['prove_s']]}, verify median {r['verify_median_s']:.4f} s "
              f"{[round(v, 4) for v in r['verify_s']]}; {_smi()}", flush=True)
    torch.cuda.empty_cache()
    return launches, proof


def _json_ints(obj):
    return json.loads(json.dumps(obj))


def phase_nova_parity(device) -> None:
    """7(a): zktpu's 4-step IVC (inputs 3, 4, 1, 2 on the x^3 + x + 5 R1CS,
    SRS secret 424242) on the card, step by step equal to the committed
    golden of zktpu's run (tests/goldens/nova.json): every hash, com_T, r,
    instance and NIFS opening, and the states; and the opening of an
    all-zero E."""
    from zktpu_torch.kzg import KzgScheme, Srs
    from zktpu_torch.nova.nifs import NIFS, gen_test_values
    from zktpu_torch.nova.r1cs import FWitness
    from zktpu_torch.tools.prof_nova import cubic_circuit, run_ivc
    from zktpu_torch.transcript.transcripts import NovaTranscript

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens", "nova.json")) as f:
        golden = json.load(f)
    inputs = [3, 4, 1, 2]
    r1cs, witnesses, xs = gen_test_values(inputs, device=device)
    scheme = KzgScheme(Srs.new_from_secret(424242, len(witnesses[0]) + len(xs[0]) + 1, device=device))
    run = run_ivc(scheme, r1cs, cubic_circuit(), lambda s: (witnesses[s], xs[s]), len(inputs), device)
    assert _json_ints(run["records"]) == golden["records"], "the card's 4-step IVC differs from zktpu's golden"
    assert run["states"] == golden["states"][: len(inputs)] + [golden["states"][len(inputs)]]
    w0 = FWitness.new(witnesses[0], r1cs.matrix_a.shape[0], device)
    proof = NIFS.prove(5, w0, w0.commit(scheme, xs[0]), scheme, NovaTranscript())
    e = proof.opening_e
    assert [proof.opening_point, [e.point.x, e.point.y, e.point.infinity, e.evaluation]] == \
        [golden["zero_e"]["opening_point"], golden["zero_e"]["opening_e"]] == [golden["zero_e"]["opening_point"],
                                                                              [0, 0, True, 0]]
    print(f"phase 7: (a) zktpu's 4-step IVC on the card == its golden in every hash, com_T, r, instance and "
          f"opening ({len(run['records']) - 2} folds); every step verified; an all-zero E opens to the identity",
          flush=True)


def phase_nova_gpu_cpu(device, log_m: int = 7, steps: int = 4) -> None:
    """7(b): a 2^log_m squaring chain for `steps` steps with every tensor
    path forced (HOST_MSM_MAX = HOST_POLY_MAX = 0), on the card and on the
    CPU: equal in every record, state and folded word."""
    import zktpu_torch.config as cfg
    from zktpu_torch.kzg import KzgScheme, Srs
    from zktpu_torch.tools import prof_nova as pn

    saved = (cfg.HOST_MSM_MAX, cfg.HOST_POLY_MAX)
    cfg.HOST_MSM_MAX = cfg.HOST_POLY_MAX = 0
    runs, secs = {}, {}
    try:
        inputs = pn.chain_inputs(steps, SEED)
        for dev in (device, torch.device("cpu")):
            t0 = time.perf_counter()
            r1cs = pn.chain_r1cs(log_m, dev)
            scheme = KzgScheme(Srs.new_from_secret(SRS_SECRET, (1 << log_m) + 3, device=dev))
            runs[dev.type] = pn.run_ivc(scheme, r1cs, pn.chain_circuit(), pn.chain_step_witness(log_m, inputs),
                                        steps, dev)
            secs[dev.type] = time.perf_counter() - t0
    finally:
        cfg.HOST_MSM_MAX, cfg.HOST_POLY_MAX = saved
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert _json_ints(gpu["records"]) == _json_ints(cpu["records"]), "the card's IVC records differ from the CPU's"
    assert gpu["states"] == cpu["states"]
    for a, b in zip(gpu["folded"][0].__dict__.values(), cpu["folded"][0].__dict__.values()):
        assert torch.equal(a.cpu(), b), "the card's folded witness differs from the CPU's"
    print(f"phase 7: (b) 2^{log_m} squaring chain, {steps} steps, tensor paths forced: GPU == CPU in every record, "
          f"state and folded word (gpu {secs['cuda']:.2f} s, cpu {secs['cpu']:.2f} s)", flush=True)


def phase_nova(device, log_m: int, steps: int) -> tuple[dict, dict]:
    """7(c): the squaring chain at m = 2^log_m constraints for `steps` steps
    (zktpu_torch.tools.prof_nova): every step's IVC.verify accepts; at step
    2 a changed com_T and a changed public x are rejected; the first fold
    satisfies the relaxed R1CS; the final state equals the host's
    recomputation.  Launches counted from 0 just before the run and read
    just after; then, outside the count, one traced two-step run."""
    from zktpu_torch.kzg import KzgCommitment, KzgScheme, Srs
    from zktpu_torch.curves.host_curve import G1Affine
    from zktpu_torch.nova.ivc import ZkIVCProof
    from zktpu_torch.nova.r1cs import FInstance, NovaError, is_r1cs_satisfied
    from zktpu_torch.tools import prof_nova as pn
    from zktpu_torch.transcript.transcripts import NovaTranscript

    m = 1 << log_m
    inputs = pn.chain_inputs(steps, SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.reset()
    t0 = time.perf_counter()
    r1cs = pn.chain_r1cs(log_m, device)
    scheme = KzgScheme(Srs.new_from_secret(SRS_SECRET, m + 3, device=device))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    checks = {}

    def check_verify(step, ivc, zk):
        if step != 2:
            return
        u = zk.u_i
        bad_t = ZkIVCProof(u, zk.big_u_i, KzgCommitment(zk.com_t.point + G1Affine.generator()), zk.folded_u_proof)
        bad_x = ZkIVCProof(FInstance(u.com_e, u.u, u.com_w, [(u.x[0] + 1)]), zk.big_u_i, zk.com_t, zk.folded_u_proof)
        for what, bad in (("com_T", bad_t), ("public x", bad_x)):
            try:
                ivc.verify(bad, NovaTranscript())
            except NovaError as e:
                checks[what] = str(e)
                continue
            raise AssertionError(f"Nova: a step with a changed {what} was accepted")

    def after_fold(step, fw, fu):
        if step == 0:
            is_r1cs_satisfied(r1cs, fu, fw, scheme)
            checks["satisfied"] = True

    t0 = time.perf_counter()
    run = pn.run_ivc(scheme, r1cs, pn.chain_circuit(), pn.chain_step_witness(log_m, inputs), steps, device,
                     check_verify=check_verify, after_fold=after_fold)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = launch_counts.read()
    peak = torch.cuda.max_memory_allocated()
    assert len(checks) == 3 or steps < 3, f"Nova checks missing: {checks}"
    assert run["states"][-1] == pn.host_final_state(log_m, inputs), "the final state differs from the host's"
    path = ("mont_mul_fr", "field_scan_fr", "field_lincomb", "horner_combine", "proj_add", "matvec_fr")
    assert all(launches[k] > 0 for k in path), f"a kernel of the Nova path never launched: {launches}"
    # six products a fold (compute_t) over steps - 1 folds, and three in the first fold's satisfaction check
    products = 6 * (steps - 1) + 3 * (steps > 1)
    assert launches["matvec_fr"] == products, f"matvec_fr launched {launches['matvec_fr']} times, not {products}"
    t = run["times"]
    prove_med, verify_med = statistics.median(t["prove_s"]), statistics.median(t["verify_s"][1:])
    print(f"phase 7: (c) Nova IVC, squaring chain m = 2^{log_m} ({m} constraints, n = {m + 3}), {steps} steps: "
          f"setup {t_setup:.3f} s, run {t_run:.1f} s; per step prove median {prove_med:.4f} s, verify median "
          f"{verify_med:.4f} s; every step verified, rejected: {checks.get('com_T')!r} (changed com_T), "
          f"{checks.get('public x')!r} (changed x); the first fold satisfies the relaxed R1CS; final state == "
          f"host; peak memory {peak / 1e9:.2f} GB (max_memory_allocated); {_smi()}", flush=True)
    print(f"phase 7: prove_s {[round(v, 4) for v in t['prove_s']]}", flush=True)
    print(f"phase 7: verify_s {[round(v, 4) for v in t['verify_s']]}", flush=True)
    print(f"phase 7: launches {json.dumps(launches)}", flush=True)
    print(f"phase 7: {_field_launches(launches)}", flush=True)
    del run
    split = pn.split_step(scheme, r1cs, inputs, log_m, device)
    print(f"phase 7: split of one fold step (s): {json.dumps({k: round(v, 4) for k, v in split.items()})}", flush=True)
    summary, table = pn.trace_step(scheme, r1cs, inputs, log_m, device)
    print(table, file=sys.stderr)
    print(f"phase 7: one traced two-step run (one fold, outside the count): {summary['launch_calls']} kernel launch "
          f"calls, {summary['device_kernels']} device kernels, wall {summary['wall_s']:.3f} s, device "
          f"{summary['device_s']:.3f} s (idle {100 * summary['idle_share']:.1f}%); by kernel ms "
          f"{json.dumps({k: round(v, 3) for k, v in summary['by_kernel_ms'].items()})}; field_scan_kernel "
          f"{json.dumps(summary['by_name_ms'].get('field_scan_kernel', (0.0, 0)))} (ms, launches)", flush=True)
    return launches, {"r1cs": r1cs, "z": pn.chain_witness(inputs[0], m)}


def phase_nova_kernels(device, nova: dict, results: dict) -> None:
    """7(d), outside the counted path: the matvec kernel (matvec_fr) against
    its plain version (the plain product against z[None], then the plain
    axis-1 sum) on A's first 64 rows, on 64 random rows and on 16 rows whose
    every word is p - 1 (z too), each at the full n; then at the full
    (m, n, 8) shape with CUDA events, in turns with the former pair (kernel
    1's product, kernel A's axis-1 sum over its (m, n, 8) output), which must
    give the same words, beside the bounds."""
    from zktpu_torch.fields.fp import field, ints_to_limbs
    from zktpu_torch.fields.host import FR
    from zktpu_torch.fields.mont_kernel import mont_mul
    from zktpu_torch.nova.matvec_kernel import kernel_attrs, matvec, matvec_plain

    f = field(FR, device)
    A = nova["r1cs"].matrix_a
    m, n = A.shape[0], A.shape[1]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 7)
    z = torch.cat([f.encode_ints(nova["z"]), f.encode_ints([nova["z"][-1], 1])])  # [W || x || u]
    assert z.shape[0] == n
    top = torch.from_numpy(ints_to_limbs([FR.modulus - 1], 8))[0].to(device)
    slices = (("A's first 64 rows", A[:64], z),
              ("64 random rows", _field_rows(f, gen, 64 * n)[:, 0].reshape(64, n, 8), z),
              ("16 rows of p - 1 words, z of p - 1 words", top.expand(16, n, 8).contiguous(),
               top.expand(n, 8).contiguous()))
    err, plain = 0, {}
    for name, mat, vec in slices:
        got = matvec(mat, vec)
        want, plain[name] = _timed_once(lambda: matvec_plain(f, mat, vec))
        err = max(err, _compare(f"matvec_fr on {name}", [got], [want]))
        ms = _cuda_ms(lambda: matvec(mat, vec), 20)
        print(f"phase 7: (d) matvec_fr on {name} ({mat.shape[0]}, {n}, 8): mismatches=0 kernel_ms={ms:.4f} "
              f"plain_ms={plain[name]:.4f}", flush=True)
    del slices, got, want
    torch.cuda.empty_cache()
    # at the full shape a launch runs for milliseconds and the host enqueues the next ones meanwhile, so
    # CUDA events over a few calls time the kernels alone; kernel, pair, pair, kernel
    E = 32
    pair = lambda: f.sum(mont_mul(FR, A, z[None]), axis=1)  # noqa: E731
    assert torch.equal(matvec(A, z), pair()), "matvec_fr differs from the former pair at the full shape"
    ms = [_cuda_ms(lambda: matvec(A, z), 5)]
    ms_pair = [_cuda_ms(pair, 5), _cuda_ms(pair, 5)]
    ms.append(_cuda_ms(lambda: matvec(A, z), 5))
    full = mont_mul(FR, A, z[None])
    ms_mul = _cuda_ms(lambda: mont_mul(FR, A, z[None]), 5)
    ms_sum = _cuda_ms(lambda: f.sum(full, axis=1), 5)
    del full
    torch.cuda.empty_cache()
    nbytes = (m * n + n + m) * E
    b = _bound(nbytes, m * n * 64)  # the schoolbook a z: 64 word products an element
    b_cios = _bound(nbytes, m * n * _mont_words(8))  # a CIOS product an element, for comparison
    b_pair = _bound((2 * m * n + n) * E, m * n * _mont_words(8))["bound_ms"] + \
        _bound((m * n + m) * E, (n - 1) * m * 8)["bound_ms"]
    mean = statistics.mean(ms)
    attrs = kernel_attrs()
    results["matvec_fr"] = {"max_abs_err": err, "ms": mean, "plain_ms": plain["A's first 64 rows"], "n": m * n,
                            "plain_shape": f"(64, {n}, 8), A's first 64 rows", **b}
    print(f"phase 7: (d) full shape (m, n, 8) = ({m}, {n}, 8) x ({n}, 8), CUDA events over 5 calls, in turns: "
          f"matvec_fr {ms[0]:.4f} / {ms[1]:.4f} ms; the former pair (mont_mul Fr, then field_scan Fr's axis-1 sum) "
          f"{ms_pair[0]:.4f} / {ms_pair[1]:.4f} ms (mont_mul alone {ms_mul:.4f} ms, the sum alone {ms_sum:.4f} ms), "
          f"same words; bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {100 * b['bound_ms'] / mean:.1f}% reached), "
          f"the CIOS count {b_cios['bound_ms']:.4f} ms, the schoolbook count "
          f"{2 * m * n * 64 / IMAD_PER_S * 1e3:.4f} ms, the former pair's bound {b_pair:.4f} ms; "
          f"{attrs['rows']} rows and {attrs['threads']} threads a block, {attrs['registers']} registers; {_smi()}",
          flush=True)


def sum_of_products(terms: int, seed: int, constant: int = 3):
    """An equation 'constant*c^2 + a0*b0 + ... = out' in parse_string's
    grammar with witnesses from numpy's default_rng(seed), out its value:
    2 terms + 4 gates."""
    import numpy as np

    from zktpu_torch.fields.host import FR

    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(2 * terms + 1, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR.modulus for row in words]
    wit = {"c": vals[0]}
    out = constant * vals[0] * vals[0]
    parts = [f"{constant}*c^2"]
    for i in range(terms):
        a, b = vals[1 + 2 * i], vals[2 + 2 * i]
        wit[f"a{i}"], wit[f"b{i}"] = a, b
        out += a * b
        parts.append(f"a{i}*b{i}")
    wit["out"] = out % FR.modulus
    return " + ".join(parts) + " = out", wit


def phase_parser(device, log_n: int) -> dict:
    """8: a sum-of-products equation that compiles to 2^log_n gates, parsed
    (zktpu_torch.plonk.parser) with witnesses from SEED, proved and verified
    on the card; a proof of a different equation (another constant) is
    rejected; CPIGenerator's eight commitments (MSMs on the card) equal the
    prover's commitments of the same polynomials.  Launches counted from 0
    just before the parse and read just after the CPI."""
    from zktpu_torch.kzg import KzgScheme, Srs
    from zktpu_torch.plonk.cpi import CPIGenerator
    from zktpu_torch.plonk.parser import Parser
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.plonk.verifier import PlonkVerificationError, verify
    from zktpu_torch.transcript.chacha import StdRng

    terms = ((1 << log_n) - 4) // 2
    launch_counts.reset()
    t0 = time.perf_counter()
    compiled = {}
    for const in (3, 5):
        eq, wit = sum_of_products(terms, SEED, const)
        p = Parser()
        for k, v in wit.items():
            p.add_witness(k, v)
        circuit = p.parse(eq)
        assert len(circuit.gates) == 2 * terms + 4
        compiled[const] = eq, circuit.compile(device)
    t_parse = time.perf_counter() - t0
    eq, c3 = compiled[3]
    assert c3.size == 1 << log_n, c3.size
    srs = Srs.new_from_secret(SRS_SECRET, c3.size, device=device)
    t0 = time.perf_counter()
    proof = generate_proof(c3, srs, StdRng.from_seed_u64(SEED))
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify(c3, srs, proof)
    t_verify = time.perf_counter() - t0
    other = generate_proof(compiled[5][1], srs, StdRng.from_seed_u64(SEED))
    verify(compiled[5][1], srs, other)
    try:
        verify(c3, srs, other)
    except PlonkVerificationError:
        pass
    else:
        raise AssertionError("a proof of another equation was accepted")
    scheme = KzgScheme(srs)
    t0 = time.perf_counter()
    cpi = CPIGenerator().compute_common_preprocessed_input(eq, scheme)
    t_cpi = time.perf_counter() - t0
    launches = launch_counts.read()
    gc, cc = c3.gate_constraints, c3.copy_constraints
    polys = (gc.q_lx, gc.q_rx, gc.q_mx, gc.q_ox, gc.q_cx, cc.s_sigma_1, cc.s_sigma_2, cc.s_sigma_3)
    names = ("com_q_lx", "com_q_rx", "com_q_mx", "com_q_ox", "com_q_cx", "com_s_sigma_1", "com_s_sigma_2",
             "com_s_sigma_3")
    for name, com in zip(names, scheme.commit_many(list(polys))):
        assert getattr(cpi, name) == com, f"CPI's {name} differs from the prover's commitment"
    assert (cpi.n, cpi.k1, cpi.k2) == (c3.size, cc.k1, cc.k2) and cpi.pi_x == gc.pi_x
    path = ("mont_mul_fr", "proj_add", "ntt_fr", "horner_combine", "field_scan_fr", "field_addsub_fr", "field_lincomb")
    assert all(launches[k] > 0 for k in path), f"a kernel of the parser path never launched: {launches}"
    print(f"phase 8: parser + CPI, '{eq[:40]} ...' ({terms} products, {c3.size} gates): parse + compile of two "
          f"equations {t_parse:.2f} s, prove {t_prove:.3f} s, verify {t_verify:.3f} s, CPI {t_cpi:.2f} s; the proof "
          f"verifies, a proof of another equation is rejected, CPI's 8 commitments == the prover's", flush=True)
    print(f"phase 8: launches {json.dumps(launches)}", flush=True)
    print(f"phase 8: {_field_launches(launches)}", flush=True)
    return launches


def _random_words(n: int, rows: int, seed: int, top_bits: int = 32):
    """(rows, n) uint32 words from default_rng(seed), the last word cut to top_bits bits."""
    import numpy as np

    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(rows, n), dtype=np.uint32)
    w[:, -1] &= np.uint32((1 << top_bits) - 1)
    return w


def phase_fixed_base(device, results: dict, log_n: int = 20, srs_log_n: int = 14, parent=None) -> None:
    """Phase 2, the fixed-base kernel: [s_i] G for 2^log_n scalars (an SRS
    of that size) and 2^srs_log_n + 3 (the PLONK SRS's), the first four 0, 1,
    r - 1, 2^256 - 1 and a zero digit in every third of the random ones
    (tools/fixed_base_tiles.scalars), against fixed_base_mul_plain, every
    projective word, and every point but the zero scalar's identity after
    proj_to_affine_dev; 64 against host G1Affine.mul.  At each size its ms
    (CUDA events, the wrapper included), kernel-only ms (torch.profiler), the
    parent design's ms in turns when `parent` (another checkout's package,
    tools/parent.py) is given, the bound (32 n adds of 11 products: every
    table row but O is affine) and its share, and the 12-product figure of
    a complete add beside it; at 2^log_n the former loop's (32 gathers and
    proj_add launches) and the plain loop's.  Then Srs.new_from_secret of
    2^log_n points once each with the kernel, the former loop, the plain
    loop and the parent's kernel (the SRSs equal), and three times in turns
    with the parent's, each split where the multiply ends
    (fixed_base_tiles.srs_turns)."""
    from zktpu_torch.curves import g1, g1_kernel
    from zktpu_torch.curves.host_curve import G1Affine
    from zktpu_torch.fields.fp import limbs_to_ints
    from zktpu_torch.kzg import Srs
    from zktpu_torch.tools.fixed_base_tiles import bound_ms, scalars, srs_turns, zero_digits
    from zktpu_torch.tools.trace import launch_device_ms

    G = G1Affine.generator()
    tables = g1.fixed_base_tables(G, 8, device)
    for n in ((1 << srs_log_n) + 3, 1 << log_n):
        sc = scalars(n, SEED + n, device)
        got = g1_kernel.fixed_base_mul(tables, sc, 8)
        want, plain_ms = _timed_once(lambda: g1_kernel.fixed_base_mul_plain(tables, sc, 8))
        err = _compare("fixed_base_mul", got, want)
        _compare("fixed_base_mul affine", g1.proj_to_affine_dev(tuple(t[1:] for t in got)),
                 g1.proj_to_affine_dev(tuple(t[1:] for t in want)))
        del want
        ints = limbs_to_ints(sc[:64].cpu().numpy())
        assert g1.proj_to_affine_host(tuple(t[:64] for t in got)) == [G.mul(k) for k in ints], \
            "fixed_base_mul differs from host scalar multiplication"
        calls = {"kernel": lambda: g1_kernel.fixed_base_mul(tables, sc, 8)}
        if parent is not None:
            calls["parent"] = lambda: parent.curves.g1_kernel.fixed_base_mul(tables, sc, 8)
            assert all(torch.equal(x, y) for x, y in zip(calls["parent"](), got)), "the parent design differs"
        turns = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):  # in turns, then back
            for k in order:
                turns[k].append(_cuda_ms(calls[k], 3 if n > 1 << 16 else 20))
        ms = {k: sum(v) / len(v) for k, v in turns.items()}
        kernel_ms = sum(launch_device_ms(calls["kernel"], "fixed_base_kernel", reps=2)) or None
        parent_txt = f"parent design {ms['parent']:.4f} ms in turns ({turns['parent']} against {turns['kernel']})" \
            if parent is not None else "parent design not measured (no --parent)"
        print(f"phase 2: fixed_base_mul n={n}: every projective word and every affine point (but the identity) == "
              f"fixed_base_mul_plain, 64 == host G1Affine.mul; kernel_ms={ms['kernel']:.4f} kernel only "
              f"{_only(kernel_ms, bound_ms(n))} (profiler); {parent_txt}; plain {plain_ms:.4f} ms; bound "
              f"{bound_ms(n):.5f} ms (32 n adds of 11 products; of 12, a complete add's: {bound_ms(n, 12):.5f} "
              f"ms); {zero_digits(sc)} zero digits", flush=True)
        if n == 1 << log_n:
            former_ms = _cuda_ms(lambda: g1_kernel.fixed_base_mul_plain(tables, sc, 8, g1_kernel.proj_add), 3)
            table_bytes = sum(t.numel() * 4 for t in tables)
            _record(results, "fixed_base_mul", n, err, ms["kernel"], plain_ms, n * 32 + table_bytes + 3 * n * 48,
                    32 * 11 * n * _mont_words(12))
            results["fixed_base_mul"]["kernel_only_ms"] = kernel_ms
            print(f"phase 2: fixed_base_mul n={n}: the former loop (32 gathers and proj_add launches) "
                  f"{former_ms:.4f} ms", flush=True)
        del got
        torch.cuda.empty_cache()

    n = 1 << log_n
    loops = {"kernel": None,
             "former loop": functools.partial(g1_kernel.fixed_base_mul_plain, add=g1_kernel.proj_add),
             "plain loop": g1_kernel.fixed_base_mul_plain}
    if parent is not None:
        loops["parent kernel"] = lambda t, s, w: parent.curves.g1_kernel.fixed_base_mul(t, s, w)
    secs, planes = {}, {}
    saved = g1.fixed_base_mul_u32
    try:
        for name, loop in loops.items():
            g1.fixed_base_mul_u32 = saved if loop is None else (lambda base, s, window=8, loop=loop: loop(
                g1.fixed_base_tables(base, window, s.device), s, window))
            Srs.new_from_secret(SRS_SECRET, 1 << 12, device=device)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srs = Srs.new_from_secret(SRS_SECRET, n - 3, device=device)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            planes[name] = srs.g1_proj
    finally:
        g1.fixed_base_mul_u32 = saved
    for name in loops:
        if name != "kernel":
            _compare(f"Srs.new with the {name}", planes["kernel"], planes[name])
    print(f"phase 2: Srs.new_from_secret({n - 3}) ({n} points) seconds, one call each: "
          f"{json.dumps({k: round(v, 4) for k, v in secs.items()})}; the SRSs equal word for word", flush=True)
    turns = srs_turns(parent, log_n, 3, device)
    print(f"phase 2: Srs.new_from_secret({n - 3}) in turns with the parent's, seconds (total: as a caller sees "
          f"it; then a call split where the multiply ends: to_multiply, and after, the host's G2 multiplication): "
          f"{json.dumps(turns)}", flush=True)


def _fr_rows(shape, seed: int, device) -> torch.Tensor:
    """Canonical Fr Montgomery limbs below 2^254 from default_rng(seed): (*shape, 8)."""
    import numpy as np

    n = int(np.prod(shape))
    return torch.from_numpy(_random_words(8, n, seed, 30).view(np.int32).reshape(*shape, 8)).to(device)


def _dist_inputs(device, log_ntt: int, log_msm: int, log_fri: int, log_wires: int) -> dict:
    """The dist functions' inputs from SEED: NTT values, MSM scalars and SRS
    points, a FRI polynomial of 2^(log_fri - 1) coefficients, three wire
    columns and an SRS of 2^log_wires + 3 points, and the blinds."""
    from zktpu_torch.kzg import Srs
    from zktpu_torch.tools.prof_fri import fri_poly

    nw = 1 << log_wires
    return {
        "x": _fr_rows((1 << log_ntt,), SEED, device),
        "sc": _fr_rows((1 << log_msm,), SEED + 1, device),
        "points": Srs.new_from_secret(SRS_SECRET, (1 << log_msm) - 3, device=device).g1_proj,
        "poly": fri_poly(log_fri - 1, SEED, device)[0],
        "evals3": _fr_rows((3, nw), SEED + 2, device),
        "wsrs": Srs.new_from_secret(SRS_SECRET + 1, nw, device=device),
        "blinds": [(SEED + 11 * i, SEED + 13 * i + 1) for i in range(3)],
    }


def _dist_run(mesh, inp: dict, log_ntt: int, log_fri: int, log_wires: int) -> dict:
    """The four dist functions on this rank: the four-step fft and ifft of
    its rows, the sharded MSM, dist_fri_layer, the wire commitments and the
    blinded ones; each result and its seconds (the card synchronized)."""
    from zktpu_torch import dist as zd
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.msm import pick_window
    from zktpu_torch.fields.host import FR, GOLDILOCKS

    out, secs = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return r

    nw = 1 << log_wires
    fs = zd.get_four_step(FR, 1 << log_ntt, mesh)
    x = zd.shard_leading(mesh, inp["x"])
    out["fft"] = timed("four_step_fft", lambda: fs.fft(x))
    out["ifft"] = timed("four_step_ifft", lambda: fs.ifft(x))
    n_msm = inp["sc"].shape[0]
    out["msm"] = timed("msm_jacobian_sharded", lambda: zd.msm_jacobian_sharded(
        zd.shard_leading(mesh, inp["sc"]), *(zd.shard_leading(mesh, a) for a in inp["points"]), mesh=mesh,
        c=pick_window(n_msm)))
    out["fri"] = timed("dist_fri_layer", lambda: zd.dist_fri_layer(inp["poly"], GOLDILOCKS.generator, 1 << log_fri,
                                                                    mesh))
    committer = zd.ShardedWireCommitter(FR, nw, mesh, c=pick_window(nw))
    evals3 = torch.stack([zd.shard_leading(mesh, e) for e in inp["evals3"]])
    wsrs = inp["wsrs"]
    out["wires"] = timed("wire_commits", lambda: committer(evals3, *(zd.shard_leading(mesh, a[:nw])
                                                                     for a in wsrs.g1_proj)))
    out["blinded"] = timed("commit_blinded", lambda: committer.commit_blinded(evals3, wsrs, inp["blinds"]))
    out["msm"] = g1.proj_to_affine_host(tuple(a[None] for a in out["msm"]))[0]
    out["wires"] = g1.proj_to_affine_host(tuple(torch.stack([w[k] for w in out["wires"]]) for k in range(3)))
    out["fri"] = _fri_summary(out["fri"])
    out["fft"], out["ifft"] = out["fft"].cpu(), out["ifft"].cpu()
    out["secs"] = secs
    return out


def _fri_summary(layer) -> tuple:
    """A FRI layer as (evaluations on the CPU, every Merkle level as ints, the root)."""
    return layer.evaluations.cpu(), layer.merkle_tree.internal_nodes, layer.merkle_tree.root()


def _dist_check(name: str, got: dict, want: dict, rows: slice | None = None) -> None:
    """A dist run's results (of one rank: rows, its NTT rows) against the single-device ones."""
    for k in ("fft", "ifft"):
        w = want[k] if rows is None else want[k][rows]
        assert torch.equal(got[k], w), f"{name}: the four-step {k} differs from the domain's"
    assert got["msm"] == want["msm"], f"{name}: the sharded MSM differs from msm_proj"
    (eg, ng, rg), (ew, nw, rw) = got["fri"], want["fri"]
    assert torch.equal(eg, ew), f"{name}: FRI evaluations differ"
    assert ng == nw, f"{name}: FRI Merkle levels differ"
    assert rg == rw, f"{name}: FRI roots differ"
    assert got["wires"] == want["wires"], f"{name}: the wire commitments differ"
    assert got["blinded"] == want["blinded"], f"{name}: the blinded wire commitments differ"


def _dist_reference(device, inp: dict, log_ntt: int, log_fri: int, log_wires: int) -> dict:
    """The single-device results: get_domain's fft and ifft, msm_proj,
    FriLayer.from_poly, interpolate-then-commit of each wire (msm_proj), and
    KzgScheme.commit of each blinded wire polynomial."""
    from zktpu_torch.curves import g1, msm
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FR, GOLDILOCKS
    from zktpu_torch.fri.layer import FriLayer
    from zktpu_torch.kzg import KzgScheme
    from zktpu_torch.poly.domain import get_domain
    from zktpu_torch.poly.poly import Poly

    fr = field(FR, device)
    dom = get_domain(FR, 1 << log_ntt, device)
    nw = 1 << log_wires
    dw = get_domain(FR, nw, device)
    n_msm = inp["sc"].shape[0]
    wsrs = inp["wsrs"]
    coeffs = [dw.ifft(e, force_device=True) for e in inp["evals3"]]
    sc = torch.stack([fr.to_u32_limbs(c) for c in coeffs])
    scheme = KzgScheme(wsrs)
    return {
        "fft": dom.fft(inp["x"], force_device=True).cpu(),
        "ifft": dom.ifft(inp["x"], force_device=True).cpu(),
        "msm": g1.proj_to_affine_host(tuple(a[None] for a in msm.msm_proj(
            inp["sc"], *inp["points"], c=msm.pick_window(n_msm))))[0],
        "fri": _fri_summary(FriLayer.from_poly(inp["poly"], GOLDILOCKS.generator, 1 << log_fri, force_device=True)),
        "wires": g1.proj_to_affine_host(msm.msm_proj_many(sc, *(a[:nw] for a in wsrs.g1_proj),
                                                          c=msm.pick_window(nw))),
        "blinded": [scheme.commit(Poly(FR, c) + Poly.from_ints(FR, [b_lo, b_hi], device).mul_by_vanishing(nw)).point
                    for c, (b_hi, b_lo) in zip(coeffs, inp["blinds"])],
    }


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"


DIST_FULL = (22, 20, 20, 16)  # log2 of the NTT, MSM, FRI domain and wire sizes at world size 1
DIST_GLOO = (16, 14, 14, 10)  # the same for 4 gloo ranks sharing the card
DIST_GLOO_WORLD = 4


def _dist_gloo_rank(mesh, sizes) -> dict:
    """One of the gloo ranks that share the card: the whole inputs, its shard's results."""
    return _dist_run(mesh, _dist_inputs(mesh.device, *sizes), sizes[0], sizes[2], sizes[3])


def phase_dist(device) -> dict:
    """Phase 9: zktpu_torch.dist.  (a) At world size 1 over NCCL, a path of
    its own (launches counted from 0 just before the four functions and
    read just after): FourStepNTT fft and ifft at a 2^22 Fr domain (R = C =
    2^11) against get_domain(FR, 2^22), word for word; msm_jacobian_sharded
    at 2^20 against msm_proj (the same affine point); dist_fri_layer at a
    2^20 Goldilocks domain against FriLayer.from_poly (every evaluation,
    level and the root); ShardedWireCommitter at n = 2^16 against
    interpolating and committing each wire, commit_blinded against
    KzgScheme.commit of the blinded polynomials; each timed beside its
    single-device counterpart.  (b) 4 gloo ranks sharing the card
    (collectives staged through the host) at 2^16 (NTT), 2^14 (MSM, FRI) and
    2^10 (wires): every rank's results equal the single-device ones."""
    import torch.distributed as tdist

    from zktpu_torch import dist as zd

    log_ntt, log_msm, log_fri, log_wires = DIST_FULL
    inp = _dist_inputs(device, *DIST_FULL)
    torch.cuda.synchronize()
    backend = "nccl" if device.type == "cuda" else "gloo"
    mesh = zd.init(0, 1, zd.mesh.free_port(), backend=backend, device=device)
    try:
        launch_counts.reset()
        got = _dist_run(mesh, inp, log_ntt, log_fri, log_wires)
        launches = launch_counts.read()
    finally:
        tdist.destroy_process_group()
    path = ("ntt_fr", "mont_mul_fr", "field_scan_fr", "proj_add", "horner_combine", "ntt_gl", "sha256_field",
            "mont_mul_gl", "field_scan_gl")
    assert all(launches[k] > 0 for k in path), f"a kernel of the dist path never launched: {launches}"
    want = _dist_reference(device, inp, log_ntt, log_fri, log_wires)
    _dist_check(f"world 1 ({backend})", got, want)

    from zktpu_torch.curves import msm
    from zktpu_torch.fields.host import FR, GOLDILOCKS
    from zktpu_torch.fri.layer import FriLayer
    from zktpu_torch.poly.domain import get_domain

    dom = get_domain(FR, 1 << log_ntt, device)
    single = {
        "fft": _cuda_ms(lambda: dom.fft(inp["x"], force_device=True), 5),
        "ifft": _cuda_ms(lambda: dom.ifft(inp["x"], force_device=True), 5),
        "msm_proj": _cuda_ms(lambda: msm.msm_proj(inp["sc"], *inp["points"], c=msm.pick_window(1 << log_msm)), 2),
        "FriLayer.from_poly": _cuda_ms(lambda: FriLayer.from_poly(inp["poly"], GOLDILOCKS.generator, 1 << log_fri,
                                                                     force_device=True), 3),
    }
    print(f"phase 9: (a) dist at world size 1 ({backend}): four-step 2^{log_ntt} fft and ifft == get_domain's word for "
          f"word; msm_jacobian_sharded 2^{log_msm} == msm_proj; dist_fri_layer 2^{log_fri} == FriLayer.from_poly "
          f"(evaluations, levels, root); wire commitments 2^{log_wires} == interpolate + msm_proj, commit_blinded == "
          f"KzgScheme.commit of the blinded polynomials", flush=True)
    print(f"phase 9: (a) dist seconds (first call) {json.dumps({k: round(v, 4) for k, v in got['secs'].items()})}; "
          f"single-device ms (warm, CUDA events) {json.dumps({k: round(v, 4) for k, v in single.items()})}", flush=True)
    print(f"phase 9: (a) launches {json.dumps(launches)}", flush=True)
    del got, want, inp
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = zd.spawn(_dist_gloo_rank, DIST_GLOO_WORLD, DIST_GLOO, backend="gloo", device=device.type)
    t_spawn = time.perf_counter() - t0
    log_ntt, log_msm, log_fri, log_wires = DIST_GLOO
    inp = _dist_inputs(device, *DIST_GLOO)
    want = _dist_reference(device, inp, log_ntt, log_fri, log_wires)
    rows = (1 << log_ntt) // DIST_GLOO_WORLD
    for r, res in enumerate(ranks):
        _dist_check(f"gloo rank {r}", res, want, slice(r * rows, (r + 1) * rows))
    print(f"phase 9: (b) world {DIST_GLOO_WORLD}, backend gloo, all ranks on {_device_name(device)}: "
          f"four-step 2^{log_ntt}, sharded MSM 2^{log_msm}, dist_fri_layer 2^{log_fri}, wires 2^{log_wires}: every "
          f"rank == the single-device results ({t_spawn:.1f} s with the spawn); rank seconds "
          f"{json.dumps([{k: round(v, 4) for k, v in res['secs'].items()} for res in ranks])}", flush=True)
    return launches


def phase_compat(device, plonk_ctx: dict, fri_proof, tmp: str, log_m: int = 10, steps: int = 8) -> None:
    """Phase 10: checkpoint round trips on the card.  Phase 4's SRS saved and
    loaded (on the card) commits as the original does; phase 4's proof loads
    and verifies, and with bar_a changed is rejected; phase 6's FRI proof
    loads and verifies; an IVC over the squaring chain at m = 2^log_m saved
    after step 4 of `steps`, loaded into a fresh augmented circuit and
    finished: every later record and the final state equal the run without
    the checkpoint."""
    import dataclasses

    from zktpu_torch import compat
    from zktpu_torch.convert import fri_proof_to_ints
    from zktpu_torch.fields.host import FR
    from zktpu_torch.fri.verifier import verify as fri_verify
    from zktpu_torch.kzg import KzgScheme, Srs
    from zktpu_torch.plonk.verifier import PlonkVerificationError, verify
    from zktpu_torch.poly.poly import Poly
    from zktpu_torch.tools import prof_nova as pn

    srs, circuit, proof = plonk_ctx["srs"], plonk_ctx["circuit"], plonk_ctx["proof"]
    path = os.path.join(tmp, "srs.npz")
    compat.save_srs(path, srs)
    loaded = compat.load_srs(path, device)
    assert loaded.device == srs.device and all(torch.equal(a, b) for a, b in zip(loaded.g1_proj, srs.g1_proj))
    poly = Poly(FR, _fr_rows((srs.size - 3,), SEED + 3, device))
    assert KzgScheme(loaded).commit(poly) == KzgScheme(srs).commit(poly), "the loaded SRS commits differently"
    path = os.path.join(tmp, "plonk.json")
    compat.save_plonk_proof(path, proof)
    lp = compat.load_plonk_proof(path)
    assert lp == proof
    verify(circuit, loaded, lp)
    try:
        verify(circuit, loaded, dataclasses.replace(lp, bar_a=FR.add(lp.bar_a, 1)))
    except PlonkVerificationError:
        pass
    else:
        raise AssertionError("a loaded proof with bar_a changed was accepted")
    path = os.path.join(tmp, "fri.json")
    compat.save_fri_proof(path, fri_proof)
    lf = compat.load_fri_proof(path)
    fri_verify(lf)
    assert fri_proof_to_ints(lf) == fri_proof_to_ints(fri_proof)

    m = 1 << log_m
    inputs = pn.chain_inputs(steps, SEED)
    r1cs = pn.chain_r1cs(log_m, device)
    scheme = KzgScheme(Srs.new_from_secret(SRS_SECRET, m + 3, device=device))
    witness = pn.chain_step_witness(log_m, inputs)
    full = pn.run_ivc(scheme, r1cs, pn.chain_circuit(), witness, steps, device)
    path = os.path.join(tmp, "ivc.json")
    saved_at = []

    def checkpoint(step, augmented):
        if step != 3:
            return augmented
        compat.save_ivc_state(path, augmented)
        saved_at.append(augmented.i)
        return compat.load_ivc_state(path, pn.chain_circuit())

    resumed = pn.run_ivc(scheme, r1cs, pn.chain_circuit(), witness, steps, device, checkpoint=checkpoint)
    assert saved_at == [4], saved_at
    assert resumed["records"] == full["records"], "the resumed IVC's records differ"
    assert resumed["states"] == full["states"], "the resumed IVC's states differ"
    print(f"phase 10: compat on the card: phase 4's SRS ({srs.size} points) saved and loaded commits equally; "
          f"phase 4's proof loads and verifies, with bar_a changed rejected; phase 6's FRI proof "
          f"(2^{fri_proof.domain_size.bit_length() - 1} domain) loads and verifies; an IVC at m = 2^{log_m} saved "
          f"after step 4 of {steps}, loaded into a fresh circuit and finished == the uninterrupted run (every record, "
          f"the final state)", flush=True)


def phase_profiling(device, plonk_ctx: dict, tmp: str) -> None:
    """Phase 11: ZKTPU_PROFILE: one prove of phase 4's circuit under
    maybe_trace writes a Chrome trace that names the NTT and group-law
    kernels; ZKTPU_DEBUG=1: phase 3's 4-gate proof (tensor paths forced) on
    the card raises nothing; an off-curve point through proj_to_affine_host
    raises."""
    import glob

    import zktpu_torch.config as cfg
    from zktpu_torch import profiling
    from zktpu_torch.curves import g1
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FQ
    from zktpu_torch.kzg import Srs
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.plonk.verifier import verify
    from zktpu_torch.transcript.chacha import StdRng

    trace_dir = os.path.join(tmp, "traces")
    saved_env = {k: os.environ.get(k) for k in ("ZKTPU_PROFILE", "ZKTPU_DEBUG")}
    try:
        os.environ["ZKTPU_PROFILE"] = trace_dir
        with profiling.maybe_trace("plonk_prove"):
            generate_proof(plonk_ctx["circuit"], plonk_ctx["srs"], StdRng.from_seed_u64(SEED))
        del os.environ["ZKTPU_PROFILE"]
        (path,) = glob.glob(os.path.join(trace_dir, "plonk_prove-*.json"))
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
        assert any("ntt_pass_kernel" in k for k in names), f"the trace names no NTT kernel: {sorted(names)[:20]}"
        assert any("proj_add_kernel" in k for k in names) and any("horner_combine_kernel" in k for k in names), \
            f"the trace names no group-law kernel: {sorted(names)[:20]}"

        os.environ["ZKTPU_DEBUG"] = "1"
        limits = (cfg.HOST_MSM_MAX, cfg.HOST_NTT_MAX, cfg.HOST_POLY_MAX)
        cfg.HOST_MSM_MAX = cfg.HOST_NTT_MAX = cfg.HOST_POLY_MAX = 0
        try:
            compiled = _pythagorean_circuit().compile(device=device)
            srs = Srs.new_from_secret(SRS_SECRET, compiled.size, device=device)
            verify(compiled, srs, generate_proof(compiled, srs, StdRng.from_seed_u64(SEED), force="coset"))
        finally:
            cfg.HOST_MSM_MAX, cfg.HOST_NTT_MAX, cfg.HOST_POLY_MAX = limits
        one = field(FQ, device).one
        try:
            g1.proj_to_affine_host(tuple(one[None] for _ in range(3)))  # (1 : 1 : 1): off the curve
        except AssertionError as e:
            raised = str(e)
        else:
            raise AssertionError("ZKTPU_DEBUG: an off-curve point passed proj_to_affine_host")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"phase 11: ZKTPU_PROFILE: one prove of the {plonk_ctx['circuit'].size}-gate circuit traced to "
          f"{os.path.basename(path)} ({len(names)} kernel names, the NTT's and the group law's among them); "
          f"ZKTPU_DEBUG=1: the 4-gate proof with tensor paths forced proves and verifies, an off-curve point raises "
          f"{raised!r}", flush=True)


_EXAMPLES = (
    (("torch_kzg_example.py",), "KZG commit/open/verify: accepted"),
    (("torch_plonk_example.py",), "PLONK prove/verify: accepted"),
    (("torch_nova_example.py",), "Nova 4-step IVC: accepted"),
    (("torch_fri_example.py",), "Accepted!"),
    (("torch_dist_plonk_example.py",), "all 3 match single-device"),
    (("torch_dist_plonk_example.py", "--world", "4", "--backend", "gloo"), "all 3 match single-device"),
)


def phase_examples() -> None:
    """Phase 12: the five examples as subprocesses on the card (all at once),
    the dist example at world 1 (NCCL) and as 4 gloo ranks: each exits 0
    with its accepted line."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [(args, want, subprocess.Popen([sys.executable, os.path.join(here, "examples", args[0]), *args[1:]],
                                           cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for args, want in _EXAMPLES]
    lines = []
    try:
        for args, want, p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"{' '.join(args)} exited {p.returncode}:\n{err[-4000:]}"
            line = [ln for ln in out.splitlines() if want in ln]
            assert line, f"{' '.join(args)} printed no accepted line:\n{out[-2000:]}"
            lines.append(f"{' '.join(args)}: {line[-1]!r}")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"phase 12: examples on the card ({time.perf_counter() - t0:.1f} s, all at once): " + "; ".join(lines),
          flush=True)


# The kernels of the paths.
_SOURCES = {
    "mont_mul_fr": ("zktpu_torch/csrc/mont_mul.cu", "zktpu/fields/pallas_mont.py:363"),
    "mont_mul_fq": ("zktpu_torch/csrc/mont_mul.cu", "zktpu/fields/pallas_mont.py:363"),
    # the Goldilocks product (to_mont, decode); FRI's path no longer launches it: the NTT's last store makes
    # its from_mont and the fold kernel its r * odd
    "mont_mul_gl": ("zktpu_torch/csrc/mont_mul.cu", "zktpu/fields/pallas_mont.py:363"),
    "proj_add": ("zktpu_torch/csrc/g1.cu", "zktpu/curves/pallas_g1.py:125"),
    "proj_double": ("zktpu_torch/csrc/g1.cu", "zktpu/curves/pallas_g1.py:211"),
    "proj_madd": ("zktpu_torch/csrc/g1.cu", "zktpu/curves/pallas_g1.py:161"),
    "mont_mul_chain": ("zktpu_torch/csrc/mont_mul.cu", "tools/prof_mulkernels.py:191"),
    # the same Pallas call with the RowOpsMXU (:94) and RowOpsF32 (:133) bodies
    "mont_mul_chain_mxu": ("zktpu_torch/csrc/mont_mma.cu", "tools/prof_mulkernels.py:191"),
    "mont_mul_chain_f32": ("zktpu_torch/csrc/mont_mma.cu", "tools/prof_mulkernels.py:191"),
    # the stage loop of zktpu's _transform around kernel 1 (pallas_mont.py:363)
    "ntt_fr": ("zktpu_torch/csrc/ntt.cu", "zktpu/poly/domain.py:116"),
    # the fori_loop of _proj_double_call (pallas_g1.py:211) and proj_add in zktpu's msm_proj
    "horner_combine": ("zktpu_torch/csrc/g1.cu", "zktpu/curves/msm.py:139"),
    # the doubling scan over kernel 1 (pallas_mont.py:363) or the add: cumprod, cumsum, sum, powers, batch_inv
    "field_scan_fr": ("zktpu_torch/csrc/field_ops.cu", "zktpu/fields/fp.py:324"),
    "field_scan_fq": ("zktpu_torch/csrc/field_ops.cu", "zktpu/fields/fp.py:324"),
    # the fused jnp add/sub (RowOps.add/sub inside the Pallas kernels).  The Fq add is built and held
    # against its plain version in phase 2, but no path adds in Fq outside the group-law kernels
    "field_addsub_fr": ("zktpu_torch/csrc/field_ops.cu", "zktpu/fields/fp.py:270"),
    # the Goldilocks add; FRI's fold, which launched it, is one kernel of its own now
    "field_addsub_gl": ("zktpu_torch/csrc/field_ops.cu", "zktpu/fields/fp.py:270"),
    # the domains' twiddle and coset power tables above 2^12 points
    "field_scan_gl": ("zktpu_torch/csrc/field_ops.cu", "zktpu/fields/fp.py:324"),
    # the Goldilocks stage loop of zktpu's _transform around kernel 1 (pallas_mont.py:363): FRI's coset NTT
    "ntt_gl": ("zktpu_torch/csrc/ntt.cu", "zktpu/poly/domain.py:116"),
    # sha256_single_block (:53) with the numpy block building and the digest fold of the same file
    "sha256_field": ("zktpu_torch/csrc/sha256.cu", "zktpu/hash/sha256_vec.py:53"),
    # the jnp fold around kernel 1 (pallas_mont.py:363): r * odd, the padding and the add
    "fri_fold": ("zktpu_torch/csrc/fri_fold.cu", "zktpu/fri/prover.py:44"),
    # fixed_base_mul_u32's fori_loop of gathers and _proj_add_call (pallas_g1.py:125)
    "fixed_base_mul": ("zktpu_torch/csrc/g1.cu", "zktpu/curves/g1.py:300"),
    # Nova's matrix_vector_product (zktpu/nova/utils.py:28): kernel 1 against z[None], then the axis-1 sum
    "matvec_fr": ("zktpu_torch/csrc/matvec.cu", "zktpu/fields/pallas_mont.py:363"),
    # the chains of kernel 1 (pallas_mont.py:363) and the add/sub (fp.py:270) in zktpu/nova/nifs.py:31-52 and
    # zktpu/plonk/prover.py:184-191 and :493-
    "field_lincomb": ("zktpu_torch/csrc/lincomb.cu", "zktpu/fields/pallas_mont.py:363"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=14, help="log2 of the PLONK path's circuit size")
    ap.add_argument("--msm-log-n", type=int, default=20, help="log2 of the MSM path's point count")
    ap.add_argument("--fri-log-n", type=int, default=20, help="log2 of the FRI path's domain (blowup 2)")
    ap.add_argument("--nova-log-m", type=int, default=14, help="log2 of the Nova path's R1CS constraints")
    ap.add_argument("--nova-steps", type=int, default=64, help="IVC steps of the Nova path")
    ap.add_argument("--parent", default=None,
                    help="another checkout (a git archive unpacked) whose Fr NTT, fixed-base multiply and field "
                         "scans phase 2 times in turns with this one's")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from zktpu_torch import cuda_lib
    from zktpu_torch.curves.native_pairing import backend as pairing_backend

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = _smi()
    print(f"phase 1: device {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    cuda_lib.build(verbose=True)  # ptxas register and spill counts go to stderr
    print(f"phase 1: kernels built from zktpu_torch/csrc in {time.perf_counter() - t0:.1f} s "
          f"-> {os.path.relpath(cuda_lib.library_path())}", flush=True)
    print(f"phase 1: pairing backend {pairing_backend()}", flush=True)
    from zktpu_torch.curves import g1_kernel
    from zktpu_torch.fields import field_kernel, lincomb_kernel, mont_kernel
    from zktpu_torch.fields.host import FQ, FR, GOLDILOCKS
    from zktpu_torch.fri import fold_kernel
    from zktpu_torch.hash import sha256_kernel
    from zktpu_torch.nova import matvec_kernel
    from zktpu_torch.poly import ntt_kernel

    attrs = {k: g1_kernel.kernel_attrs(k) for k in ("proj_add", "proj_madd", "proj_double", "horner_combine")}
    attrs["ntt_fr"] = ntt_kernel.kernel_attrs(FR)
    attrs["ntt_fr radix-2"] = ntt_kernel.kernel_attrs(FR, radix_log=1)
    attrs["ntt_gl"] = ntt_kernel.kernel_attrs(GOLDILOCKS)
    attrs.update({k: field_kernel.kernel_attrs(k) for k in ("field_scan", "field_addsub")})
    attrs["sha256_field"] = sha256_kernel.kernel_attrs()
    attrs["fri_fold"] = fold_kernel.kernel_attrs()
    attrs["fixed_base_mul"] = g1_kernel.kernel_attrs("fixed_base_mul")
    attrs["matvec_fr"] = matvec_kernel.kernel_attrs()
    attrs["field_lincomb"] = lincomb_kernel.kernel_attrs()
    for spec in (FR, FQ):
        for variant in ("mxu", "f32"):
            attrs[f"mont_mul_chain_{variant} {spec.name}"] = mont_kernel.mont_mma_attrs(spec, variant)
    print("phase 1: registers " + "; ".join(
        f"{k}: {a['registers']} registers, {a['local_bytes']} local bytes, {a['shared_bytes']} shared bytes per block"
        for k, a in attrs.items()), flush=True)
    assert all(a["local_bytes"] == 0 for a in attrs.values()), f"a kernel spills: {attrs}"
    print(f"phase 1: matvec_fr design: {attrs['matvec_fr']['rows']} rows and {attrs['matvec_fr']['threads']} "
          f"threads a block", flush=True)
    fb = g1_kernel.fixed_base_design()
    print(f"phase 1: fixed_base_mul design: {fb['threads']} threads a block, launch bound {fb['min_blocks']} blocks a "
          f"SM; field_scan design: {cuda_lib.load().zk_field_scan_threads()} threads a block, a grid of at most "
          f"{field_kernel.SCAN_GRID} blocks before chunks grow, chunks of at most {field_kernel.SCAN_CHUNK_MAX} rows",
          flush=True)
    parent = None
    if args.parent:
        from zktpu_torch.tools.parent import load_parent

        t0 = time.perf_counter()
        parent = load_parent(args.parent)
        parent.cuda_lib.build()
        print(f"phase 1: the parent design's library built from {args.parent} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    phase_chain_sass()
    phase_ntt_gl_sass(args.fri_log_n)
    phase_ntt_fr_design()

    kernels = phase_kernels(device, parent)
    phase_small_path_shapes(device, kernels)
    phase_ntt_horner(device, kernels, ntt_sizes=((args.log_n + 3, 7), (20, 1), (args.log_n + 2, 9), (args.log_n, 3),
                                                 (args.log_n + 3, 1), (11, 2048), (1, 3), (8, 3)), parent=parent)
    phase_field_ops(device, kernels, args.log_n, args.msm_log_n, parent)
    phase_field_turns(device, kernels, parent)
    phase_lincomb(device, kernels, args.log_n)
    phase_fri_kernels(device, kernels, args.fri_log_n)
    phase_fixed_base(device, kernels, args.msm_log_n, args.log_n, parent)
    torch.cuda.empty_cache()
    phase_small_proof(device)
    plonk, plonk_ctx = phase_plonk(device, args.log_n)
    msm_path, tool, inputs = phase_msm(device, args.msm_log_n)
    phase_path_shapes(device, inputs, kernels)
    del inputs
    torch.cuda.empty_cache()
    fri, fri_proof = phase_fri(device, args.fri_log_n, kernels)
    torch.cuda.empty_cache()
    phase_nova_parity(device)
    phase_nova_gpu_cpu(device)
    nova_path, nova = phase_nova(device, args.nova_log_m, args.nova_steps)
    phase_nova_kernels(device, nova, kernels)
    del nova
    torch.cuda.empty_cache()
    parser = phase_parser(device, args.log_n)
    torch.cuda.empty_cache()
    dist = phase_dist(device)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase_compat(device, plonk_ctx, fri_proof, tmp)
        phase_profiling(device, plonk_ctx, tmp)
    del plonk_ctx, fri_proof
    torch.cuda.empty_cache()
    phase_examples()

    rows = []
    for name, (source, replaces) in _SOURCES.items():
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(path[name] for path in (plonk, msm_path, tool, fri, nova_path, parser, dist)),
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # no PyTorch call computes a Montgomery product, a curve add, a Montgomery NTT or SHA-256
            "library_ms": None,
            **({"plain_shape": k["plain_shape"]} if "plain_shape" in k else {}),
        })
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
