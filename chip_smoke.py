#!/usr/bin/env python3
"""Run the zktpu_torch main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py [--log-n 14] [--msm-log-n 20] [--fri-log-n 20]

Phases:
  1. device: the card's name and power limit (fails without CUDA); the
     kernels built from zktpu_torch/csrc (one nvcc per source, in parallel;
     ptxas's register and spill counts go to stderr), and the registers,
     local (spill) bytes and shared memory per block of the group-law
     kernels, the Horner combine, the NTT (Fr and Goldilocks), the field
     scans, the field add/sub, the field hash and the tensor-core chained
     products (mxu and f32, Fr and Fq) (fails if one spills); the SASS of
     the chained product's three bodies (IMMA, FFMA, IMAD: cuobjdump), the
     mxu and f32 kernels must hold IMMA and the f32 ones FFMA;
  2. kernels: holds each CUDA kernel against its plain PyTorch version on
     the card, bit for bit (mont_mul for Fr, Fq and Goldilocks and
     mont_mul_chain at N = 2^16 + 3 with the edge values 0, 1, p - 1, for
     Fr and Fq in each body, base, mxu and f32, each also against the base
     plain chain, timed with the wrapper and kernel only;
     proj_add, proj_double and proj_madd at N = 2^14 + 5 with identity,
     P + P, P + (-P), (0, 0) and padding lanes), with both times; proj_add
     and proj_madd also on strided slices of (3, n + 5, 12) planes (n = 2^14
     + 5, 1, 333), a broadcast operand and out= planes; proj_double at the
     Horner combine's (K, 12) for K = 8 and 1, and mont_mul over Fr at one
     stage of the 2^17 coset NTT (the shapes their paths gave them before
     the NTT kernel and the one-launch combine) and at the coset division's
     (2^17, 8) pointwise product, which the path still gives it; the NTT
     (ntt against ntt_plain) at the path's 2^17 x batch 7 for fft, ifft,
     coset_fft and coset_ifft, at 2^20 x 1, n = 2 and n = 2^8 (below one tile),
     with an all-zero row and a row of p - 1; the Horner combine against its
     plain loop at (c = 16, K = 1) and (c = 13, K = 8), parts holding the
     identity; mont_mul Fr's kernel-only time from torch.profiler beside its
     time with the wrapper; the field scans (cumprod, cumsum both ways, sum
     on axis 0 and 1, powers, batch_inv) and the field add/sub against their
     plain versions at the shapes the paths give them, Fr and Fq (phase_field_ops);
     the Goldilocks NTT (fft, ifft, coset_fft, coset_ifft at 2^fri_log_n x 1,
     2^13 x 3, n = 2 and 2^8, an all-zero row and a row of p - 1) and the
     field hash (single at 2^fri_log_n values, pairs at 2^(fri_log_n - 1),
     digit-length edges mixed in; the first 64 of each against hashlib)
     (phase_fri_kernels);
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
     NTT, the hash, mont_mul, the add/sub and the scans (the domains' power
     tables) must have launched.  Outside the count: the verifier rejects
     one changed evaluation and one changed root; layer 0's root equals a
     hashlib tree over its evaluations from the card, 64 of which equal
     host evaluations; a 2^12-domain proof from the card equals the CPU's;
     mont_mul, the add/sub and the powers over Goldilocks timed at the
     path's shapes; prove and verify seconds at 2^12, 2^16 and 2^fri_log_n
     (median of 3 warm runs) beside the card's power limit.
Launches are set to 0 just before each path (phase 4, the bench, the tool,
the FRI prove) and read just after.  Then one JSON line with the kernels
(launches summed over the four paths; times and bounds at the shapes the
paths give them:
proj_madd at msm_affine's mixed add, proj_add at msm_proj's first scan step,
proj_double at K = 1, mont_mul Fr at the coset division's product, ntt_fr
at 2^17 x 7 (fft), horner_combine at c = 16, K = 1, field_scan_fr at round
2's 2^14 cumprod, field_scan_fq at Srs.g1_affine's 2^20 batch_inv,
field_addsub_fr at the coset quotient's (2^17, 8) add, ntt_gl at FRI layer
0's coset_fft, sha256_field at its leaves, mont_mul_gl at its from_mont,
field_addsub_gl at its first fold, field_scan_gl at its largest power
table, the others at phase 2's shapes), the
card's name and power limit, and the final {"ok": true, ...} line.  Any
failure raises and exits non-zero.
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


def _chain_variants(spec, f, a_ints, b_ints, A, B, results) -> None:
    """The three bodies of kernel 5 at one shape: each against its own plain
    version (every word) and the base plain chain, its time with the
    wrapper (CUDA events) and kernel only (torch.profiler), its bound
    (prof_mulkernels.chain_bound: the busiest pipe).  The kernels line
    takes the Fq rows."""
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
        print(f"phase 2: {key} {spec.name} n={n} chain={CHAIN} mismatches=0 (own plain and base plain) "
              f"kernel_ms={ms:.4f} kernel_only_ms={k_ms:.4f} ({count} launches) plain_ms={plain_ms:.4f} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}: {row['bound_pipe']}) "
              f"Mmul/s={n * CHAIN / ms / 1e3:.1f} (kernel only {n * CHAIN / k_ms / 1e3:.1f})", flush=True)
        if spec is FQ:  # the microbench's field: its rows in the kernels line
            results[key] = row


def _edge_ints(rng, p: int, n: int):
    a = [0, 1, p - 1, p - 1] + [rng.randrange(p) for _ in range(n - 4)]
    b = [p - 1, p - 1, p - 1, 1] + [rng.randrange(p) for _ in range(n - 4)]
    return a, b


def phase_chain_sass() -> None:
    """The SASS of kernel 5's three bodies (cuobjdump, through
    tools/g1_budgets.py's sass_counts): IMMA (tensor-core u8 products),
    FFMA, IMAD and all instructions of each instance.  The mxu and f32
    kernels must hold IMMA, the f32 ones FFMA."""
    from zktpu_torch.fields.host import FQ, FR
    from zktpu_torch.fields.mont_mats import mma_products
    from zktpu_torch.tools.g1_budgets import sass_counts

    kernels = [("base<12>", r"21mont_mul_chain_kernelILi12E"), ("base<8>", r"21mont_mul_chain_kernelILi8E")]
    kernels += [(f"{v}<{L}>", rf"21mont_mma_chain_kernelILi{L}ELb{int(v == 'f32')}E")
                for L in (12, 8) for v in ("mxu", "f32")]
    counts = sass_counts(kernels=kernels)
    for label, _ in kernels:
        c = counts[label]
        top = sorted(c["by_op"].items(), key=lambda kv: -kv[1])[:10]
        print(f"phase 1: SASS {label}: {c['by_op'].get('IMMA', 0)} IMMA, {c['by_op'].get('FFMA', 0)} FFMA, "
              f"{c.get('IMAD', 0)} IMAD, {c['total']} instructions; by opcode {dict(top)}", flush=True)
    for L, spec in ((12, FQ), (8, FR)):
        for v in ("mxu", "f32"):
            c = counts[f"{v}<{L}>"]["by_op"]
            assert c.get("IMMA", 0) >= 2 * mma_products(spec), f"{v}<{L}>: no tensor-core products in its SASS: {c}"
        assert counts[f"f32<{L}>"]["by_op"].get("FFMA", 0) > 0, f"f32<{L}>: no FFMA in its SASS"


def phase_kernels(device) -> dict:
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
        _record(results, key, n, err, ms, plain_ms, 3 * n * 4 * L, n * _mont_words(L))

        # kernel 5 at the same shape: CHAIN products by b, each body (mxu and f32 need D >= 16)
        if spec is GOLDILOCKS:
            got = mont_mul_chain(spec, A, B, CHAIN)
            _compare(f"mont_mul_chain {spec.name}", [got], [mont_mul_chain_plain(spec, A, B, CHAIN)])
            assert f.decode_ints(got[:8]) == [x * pow(y, CHAIN, p) % p for x, y in zip(a[:8], b[:8])]
            print(f"phase 2: mont_mul_chain {spec.name} n={n} chain={CHAIN} mismatches=0", flush=True)
        else:
            _chain_variants(spec, f, a, b, A, B, results)

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
    still runs (the kernels line takes this one); each against its plain
    version."""
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
    k_ms, count = _kernel_only_ms(lambda: mont_mul(FR, x, y), 50, "mont_mul_kernel")
    print(f"phase 2: mont_mul Fr (2^17, 8) x (2^17, 8) kernel only (torch.profiler, {count} launches): "
          f"{k_ms:.4f} ms per launch against {ms:.4f} ms with the wrapper", flush=True)
    results["mont_mul_fr"]["kernel_only_ms"] = k_ms


def _kernel_only_ms(fn, reps: int, name: str) -> tuple[float, int]:
    """Mean device time of the kernels whose name holds `name` over `reps`
    calls of fn, from torch.profiler's trace, and their count."""
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
    return sum(e.self_device_time_total for e in events) / 1e3 / count, count


def _ntt_products(n: int, batch: int, factors: int) -> int:
    """Fr products of a batch of transforms: (n/2) log n butterflies and n
    per fused factor, for each row."""
    return batch * ((n // 2) * (n.bit_length() - 1) + factors * n)


def phase_ntt_horner(device, results: dict, ntt_sizes=((17, 7), (20, 1), (1, 3), (8, 3)),
                     horner_shapes=((13, 8, 20), (16, 1, 16))) -> None:
    """The NTT kernel against ntt_plain and the one-launch Horner combine
    against its plain loop, 0 mismatching words on every lane.  ntt_sizes:
    (log n, batch); the kernels line takes ntt_fr from the first one's fft
    (the path's: _batched_coset_fft's 8n = 2^17 transform of 7 polynomials
    at 2^14 gates).  horner_shapes: (c, K, W); the kernels line takes
    horner_combine from the last (the MSM bench's combine at 2^20)."""
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.g1_kernel import horner_combine, horner_combine_plain
    from zktpu_torch.curves.host_curve import G1Affine
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FR
    from zktpu_torch.curves.g1_kernel import proj_add, proj_double
    from zktpu_torch.poly.domain import Radix2Domain
    from zktpu_torch.poly.ntt_kernel import ntt, ntt_plain, stage_loop

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
            if (log_n, batch) == ntt_sizes[0] and name == "fft":
                ms = _cuda_ms(lambda: ntt(x, table, inverse, fin, fout), 50)
                plain_ms = _cuda_ms(lambda: ntt_plain(x, table, inverse, fin, fout), 3)
                _record(results, "ntt_fr", n * batch, err, ms, plain_ms, (2 * batch * n + n // 2) * 32,
                        _ntt_products(n, batch, 0) * _mont_words(8),
                        phase=f"phase 2: ntt fft (2^{log_n}, 8) x batch {batch}:")
                # what the kernel replaced: the stage loop over kernel 1 (the Goldilocks route)
                err = max(err, _compare("stage loop over kernel 1", [stage_loop(FR, fr.mont_mul, x, table, inverse)],
                                        [got]))
                loop_ms = _cuda_ms(lambda: stage_loop(FR, fr.mont_mul, x, table, inverse), 5)
                print(f"phase 2: the stage loop over kernel 1 it replaced, same fft: mismatches=0 ms={loop_ms:.4f}",
                      flush=True)
            elif batch * n >= 1 << 17:
                ms = _cuda_ms(lambda: ntt(x, table, inverse, fin, fout), 20)
                nf = (fin is not None) + (fout is not None) + (inverse and fout is None)
                b = _bound((2 * batch * n + n // 2 + nf * n) * 32, _ntt_products(n, batch, nf) * _mont_words(8))
                print(f"phase 2: ntt {name} (2^{log_n}, 8) x batch {batch}: mismatches=0 kernel_ms={ms:.4f} "
                      f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})", flush=True)
        print(f"phase 2: ntt 2^{log_n} x batch {batch}: fft, ifft, coset_fft, coset_ifft mismatches=0", flush=True)
        del x, dom
    results["ntt_fr"]["max_abs_err"] = err
    torch.cuda.empty_cache()

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
        _record(results, "horner_combine", K, err, ms, plain_ms, 3 * (W + 1) * K * 48, products * _mont_words(12),
                phase=f"phase 2: horner_combine c={c} K={K} W={W} ({(W - 1) * c} doubles, "
                      f"{1e3 * ms / ((W - 1) * c):.2f} us each with the adds):")


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


def _timed_once(fn):
    """(result, ms) of one call, CUDA events around it (for the slow plain versions)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_field_ops(device, results: dict, log_n: int = 14, fq_log_n: int = 20) -> None:
    """Kernels A and B (fields/field_kernel.py) against their plain versions
    at the shapes the paths give them, 0 mismatching words each, with the
    kernel's ms (CUDA events, the wrapper's passes and host copy included),
    the plain version's and the bound.  Fr at 2^log_n gates: the round-2
    grand product (cumprod, n x 1), the cumsum of divide_by_linear (reverse),
    the powers of Poly.evaluate and of the 8n coset's offsets, the sums of
    evaluate (axis 0) and evaluate_many (axis 1 of (8, n + 3, 8)), the
    batch inversion of round 2, and the adds of the coset quotient ((8n, 8)
    operands and a broadcast constant) and a sub; Fq: the batch inversion of
    Srs.g1_affine at 2^fq_log_n, a reverse scan and add/sub at 2^16 + 3.
    The kernels line takes field_scan_fr from the grand product,
    field_scan_fq from the Fq batch inversion and field_addsub_fr from the
    (8n, 8) add."""
    from zktpu_torch.fields import field_kernel as fk
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FQ, FR

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    n = 1 << log_n
    fr, fq = field(FR, device), field(FQ, device)

    def check(key, f, name, kernel, plain, nbytes, words, reps=20, rows=0):
        """Kernel against plain on the same inputs; `key`: record it for the kernels line."""
        got = kernel()
        plain_out, plain_ms = _timed_once(plain)
        err = _compare(f"{f.spec.name} {name}", [got], [plain_out])
        ms = _cuda_ms(kernel, reps)
        b = _bound(nbytes, words)
        if key:
            _record(results, key, rows, err, ms, plain_ms, nbytes, words, phase=f"phase 2: {f.spec.name} {name}:")
        else:
            print(f"phase 2: {f.spec.name} {name}: mismatches=0 kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})", flush=True)
        return err

    E = 32  # bytes of an Fr element; an add counts as L word operations
    mul_w, add_w = _mont_words(8), 8
    err = 0
    x = _field_rows(fr, gen, n)[:, 0]
    err = max(err, check("field_scan_fr", fr, f"cumprod ({n}, 8) (round 2's grand product)",
                         lambda: fr.cumprod(x), lambda: fk.scan_plain(fr, x, fk.OP_MUL),
                         2 * n * E, (n - 1) * mul_w, rows=n))
    for rev in (False, True):
        err = max(err, check(None, fr, f"cumsum ({n}, 8) reverse={rev} (divide_by_linear)",
                             lambda: fr.cumsum(x, reverse=rev), lambda: fk.scan_plain(fr, x, fk.OP_ADD, 0, rev),
                             2 * n * E, (n - 1) * add_w))
    err = max(err, check(None, fr, f"cumprod ({n}, 8) reverse",
                         lambda: fr.cumprod(x, reverse=True), lambda: fk.scan_plain(fr, x, fk.OP_MUL, 0, True),
                         2 * n * E, (n - 1) * mul_w))
    z = 0x1234567 % FR.modulus
    for count, where in ((n + 3, "Poly.evaluate"), (8 * n, "the 8n coset's offset powers")):
        err = max(err, check(None, fr, f"powers({count}) ({where})", lambda: fr.powers(z, count),
                             lambda: fk.powers_plain(fr, z, count), count * E, (count - 1) * mul_w))
    y = _field_rows(fr, gen, n + 3, 8)
    err = max(err, check(None, fr, f"sum axis 0 of ({n + 3}, 8) (Poly.evaluate)", lambda: fr.sum(y[:, 0]),
                         lambda: fk.sum_plain(fr, y[:, 0]), (n + 4) * E, (n + 2) * add_w))
    yt = y.transpose(0, 1)  # (8, n + 3, 8), as evaluate_many stacks its polynomials
    err = max(err, check(None, fr, f"sum axis 1 of (8, {n + 3}, 8) (evaluate_many)", lambda: fr.sum(yt, axis=1),
                         lambda: fk.sum_plain(fr, yt, 1), 8 * (n + 4) * E, 8 * (n + 2) * add_w))
    d = _field_rows(fr, gen, n, nonzero=True)[:, 0]
    err = max(err, check(None, fr, f"batch_inv ({n}, 8) (round 2)", lambda: fr.batch_inv(d, FR.inv),
                         lambda: fk.batch_inv_plain(fr, d, FR.inv), 2 * n * E, 3 * (n - 1) * mul_w, reps=10))
    results["field_scan_fr"]["max_abs_err"] = err

    err = 0
    a, b = (_field_rows(fr, gen, 8 * n)[:, 0] for _ in range(2))
    err = max(err, check("field_addsub_fr", fr, f"add ({8 * n}, 8) + ({8 * n}, 8) (the coset quotient)",
                         lambda: fr.add(a, b), lambda: fk.add_plain(fr, a, b), 3 * 8 * n * E, 8 * n * add_w,
                         rows=8 * n))
    err = max(err, check(None, fr, f"sub ({8 * n}, 8) - ({8 * n}, 8)", lambda: fr.sub(a, b),
                         lambda: fk.sub_plain(fr, a, b), 3 * 8 * n * E, 8 * n * add_w))
    c = b[5]
    err = max(err, check(None, fr, f"add ({n}, 8) + one constant (round 2's + gamma)", lambda: fr.add(a[:n], c),
                         lambda: fk.add_plain(fr, a[:n], c), (2 * n + 1) * E, n * add_w))
    err = max(err, check(None, fr, f"neg ({n}, 8)", lambda: fr.neg(a[:n]),
                         lambda: fk.sub_plain(fr, torch.zeros_like(a[:n]), a[:n]), 2 * n * E, n * add_w))
    results["field_addsub_fr"]["max_abs_err"] = err
    del a, b, x, y, yt, d

    E = 48
    mul_w, add_w = _mont_words(12), 12
    m = 1 << fq_log_n
    d = _field_rows(fq, gen, m, nonzero=True)[:, 0]
    err = check("field_scan_fq", fq, f"batch_inv ({m}, 12) (Srs.g1_affine)", lambda: fq.batch_inv(d, FQ.inv),
                lambda: fk.batch_inv_plain(fq, d, FQ.inv), 2 * m * E, 3 * (m - 1) * mul_w, reps=5, rows=m)
    del d
    torch.cuda.empty_cache()
    k = (1 << 16) + 3
    a, b = (_field_rows(fq, gen, k)[:, 0] for _ in range(2))
    err = max(err, check(None, fq, f"cumprod ({k}, 12) reverse", lambda: fq.cumprod(a, reverse=True),
                         lambda: fk.scan_plain(fq, a, fk.OP_MUL, 0, True), 2 * k * E, (k - 1) * mul_w))
    err = max(err, check(None, fq, f"cumsum ({k}, 12)", lambda: fq.cumsum(a),
                         lambda: fk.scan_plain(fq, a, fk.OP_ADD), 2 * k * E, (k - 1) * add_w))
    err = max(err, check(None, fq, f"powers({k})", lambda: fq.powers(z, k), lambda: fk.powers_plain(fq, z, k),
                         k * E, (k - 1) * mul_w))
    err = max(err, check(None, fq, f"sum axis 0 of ({k}, 12)", lambda: fq.sum(a), lambda: fk.sum_plain(fq, a),
                         (k + 1) * E, (k - 1) * add_w))
    results["field_scan_fq"]["max_abs_err"] = err
    err = 0
    for name, op, plain in (("add", fq.add, fk.add_plain), ("sub", fq.sub, fk.sub_plain)):
        err = max(err, check(None, fq, f"{name} ({k}, 12) (no path adds in Fq: the group-law kernels fuse theirs)",
                             lambda: op(a, b), lambda: plain(fq, a, b), 3 * k * E, k * add_w))
    print(f"phase 2: field_addsub Fq mismatches=0 (max_abs_err {err})", flush=True)
    torch.cuda.empty_cache()


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


def _wrappers():
    from zktpu_torch.curves.g1_kernel import horner_combine, proj_add, proj_double, proj_madd
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_chain
    from zktpu_torch.hash.sha256_kernel import hash_field
    from zktpu_torch.poly.ntt_kernel import ntt

    return (mont_mul, ntt, mont_mul_chain), (proj_add, proj_double, proj_madd, horner_combine, hash_field)


def _reset_launches() -> None:
    from zktpu_torch.fields import field_kernel

    per_field, others = _wrappers()
    for w in per_field:
        for name in w.launches:
            w.launches[name] = 0
    for w in others:
        w.launches = 0
    for counts in field_kernel.launches.values():
        for name in counts:
            counts[name] = 0


def _read_launches() -> dict:
    from zktpu_torch.fields import field_kernel
    from zktpu_torch.fields.host import FQ, FR, GOLDILOCKS

    (mont_mul, ntt, mont_mul_chain), (proj_add, proj_double, proj_madd, horner_combine, hash_field) = _wrappers()
    return {
        "mont_mul_fr": mont_mul.launches[FR.name],
        "mont_mul_fq": mont_mul.launches[FQ.name],
        "mont_mul_gl": mont_mul.launches[GOLDILOCKS.name],
        "proj_add": proj_add.launches,
        "proj_double": proj_double.launches,
        "proj_madd": proj_madd.launches,
        "mont_mul_chain": mont_mul_chain.launches["base"],
        "mont_mul_chain_mxu": mont_mul_chain.launches["mxu"],
        "mont_mul_chain_f32": mont_mul_chain.launches["f32"],
        "ntt_fr": ntt.launches[FR.name],
        "ntt_gl": ntt.launches[GOLDILOCKS.name],
        "horner_combine": horner_combine.launches,
        "sha256_field": hash_field.launches,
        **{f"{k}_{short}": field_kernel.launches[k][spec.name]
           for k in ("field_scan", "field_addsub") for short, spec in (("fr", FR), ("fq", FQ), ("gl", GOLDILOCKS))},
    }


def phase_plonk(device, log_n: int) -> dict:
    from zktpu_torch.fields.host import FR
    from zktpu_torch.kzg import Srs
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.plonk.synthetic import synthetic_mul_chain
    from zktpu_torch.plonk.verifier import PlonkVerificationError, verify
    from zktpu_torch.transcript.chacha import StdRng

    from zktpu_torch.fields.limbs import resolve

    _reset_launches()
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
    launches = _read_launches()
    path = ("mont_mul_fr", "mont_mul_fq", "proj_add", "ntt_fr", "horner_combine", "field_scan_fr", "field_addsub_fr")
    assert all(launches[k] > 0 for k in path), f"a kernel of the PLONK path never launched: {launches}"
    assert launches["proj_double"] == 0, f"the PLONK path doubled outside the Horner combine: {launches}"
    # no plain version runs on the card: every carry scan of limbs.resolve on a CUDA tensor is one
    assert plain_carries == 0, f"prove + verify ran {plain_carries} plain carry scans (limbs.resolve) on the card"

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
    print(f"phase 4: one traced prove (outside the count): {_traced_prove(circuit, srs)}", flush=True)
    return launches


def _traced_prove(circuit, srs) -> str:
    """One prove under torch.profiler (zktpu_torch.tools.prof_prove): its
    CUDA kernel launches, device time and wall time; the table by device
    time goes to stderr."""
    from zktpu_torch.tools.prof_prove import trace_prove

    t, table = trace_prove(circuit, srs, SEED)
    print(table, file=sys.stderr)
    return (f"{t['launch_calls']} kernel launch calls, {t['device_kernels']} device kernels, wall {t['wall_s']:.3f} s, "
            f"device {t['device_s']:.3f} s (idle {100 * t['idle_share']:.1f}%)")


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

    _reset_launches()
    t0 = time.perf_counter()
    inputs = bench.make_inputs(log_n, device)
    setup = {k: round(v, 3) for k, v in inputs["seconds"].items()}
    print(f"phase 5: setup 2^{log_n} points and scalars {time.perf_counter() - t0:.3f} s {json.dumps(setup)}",
          flush=True)
    r = bench.run(log_n, iters=2, device=device, inputs=inputs)  # asserts msm_affine == msm_proj
    launches = _read_launches()
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

    _reset_launches()
    # the tool's field is Fq; Fr and Goldilocks for comparison (Goldilocks: base only, D < 16)
    for spec in (FQ, FR, GOLDILOCKS):
        variants = ("base",) if spec is GOLDILOCKS else prof_mulkernels.VARIANTS
        for row in prof_mulkernels.run(1 << 16, CHAIN, spec, variants, device=device):
            print(f"phase 5: prof_mulkernels {spec.name} {row['variant']} N={row['n']} CHAIN={row['chain']}: "
                  f"{row['ms_per_mul']:.5f} ms/mul, {row['mmul_per_s']:.2f} Mmul/s, MATCH", flush=True)
    tool = _read_launches()
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
    """Kernels 1g (the Goldilocks NTT) and 6 (the field hash) against their
    plain versions on the card, 0 mismatching words: the NTT's fft, ifft,
    coset_fft and coset_ifft at 2^log_n x 1, 2^13 x 3, n = 2 x 3 and 2^8 x 3
    (an all-zero row and a row of p - 1); the hash in single mode at
    2^log_n values and in pair mode at 2^(log_n - 1) pairs, digit-length
    edges mixed in, and its first 64 outputs against hashlib.  The hash's
    bound counts the 32-bit integer instructions of one hash from the SASS
    of this build (prof_fri.hash_int_ops, cuobjdump) over both integer
    pipes.  The kernels line takes ntt_gl from FRI layer 0's coset_fft at
    2^log_n and sha256_field from the single mode (layer 0's leaves)."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import GOLDILOCKS
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
    for lg, batch in ((log_n, 1), (13, 3), (1, 3), (8, 3)):
        n = 1 << lg
        dom = Radix2Domain(GOLDILOCKS, n, device=device)
        x = _gl_rows(gl, gen, batch, n)
        g = GOLDILOCKS.generator
        lanes = (("fft", False, None, None), ("ifft", True, None, None),
                 ("coset_fft", False, dom.offset_powers(g), None), ("coset_ifft", True, None, dom._coset_out(g)))
        for name, inverse, fin, fout in lanes:
            table = dom._inv_tw if inverse else dom._fwd_tw
            got = ntt(x, table, inverse, fin, fout, GOLDILOCKS)
            want, plain_ms = _timed_once(lambda: ntt_plain(x, table, inverse, fin, fout, GOLDILOCKS))
            err = max(err, _compare(f"ntt Goldilocks {name} 2^{lg} x {batch}", [got], [want]))
            if lg == log_n and name == "coset_fft":  # FRI layer 0's transform
                ms = _cuda_ms(lambda: ntt(x, table, inverse, fin, fout, GOLDILOCKS), 50)
                products = _ntt_products(n, batch, 1)
                _record(results, "ntt_gl", n * batch, err, ms, plain_ms, (2 * batch * n + n // 2 + n) * 8,
                        products * _mont_words(2), phase=f"phase 2: ntt Goldilocks coset_fft (2^{lg}, 2) x {batch}:")
        print(f"phase 2: ntt Goldilocks 2^{lg} x batch {batch}: fft, ifft, coset_fft, coset_ifft mismatches=0",
              flush=True)
        del x, dom
    results["ntt_gl"]["max_abs_err"] = err
    torch.cuda.empty_cache()

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


def phase_fri(device, log_n: int, results: dict) -> dict:
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
    _reset_launches()
    t0 = time.perf_counter()
    proof = generate_proof(poly, 2, QUERIES)
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify(proof)
    t_verify = time.perf_counter() - t0
    launches = _read_launches()
    path = ("ntt_gl", "sha256_field", "mont_mul_gl", "field_addsub_gl", "field_scan_gl")
    assert all(launches[k] > 0 for k in path), f"a kernel of the FRI path never launched: {launches}"
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

    # the Goldilocks product and add/sub at the path's shapes (their rows in the kernels line)
    gl = field(GOLDILOCKS, device)
    ev = FriLayer.from_poly(poly, GOLDILOCKS.generator, 1 << log_n, force_device=True).evaluations
    mont = gl.to_mont(ev)
    one = gl._one_raw
    got = mont_mul(GOLDILOCKS, mont, one)
    want, plain_ms = _timed_once(lambda: mont_mul_plain(GOLDILOCKS, mont, one))
    err = max(_compare("mont_mul Goldilocks from_mont", [got], [want]), results["mont_mul_gl"]["max_abs_err"])
    ms = _cuda_ms(lambda: mont_mul(GOLDILOCKS, mont, one), 50)
    n = mont.shape[0]
    _record(results, "mont_mul_gl", n, err, ms, plain_ms, (2 * n + 1) * 8, n * _mont_words(2),
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
    _record(results, "field_scan_gl", count, err, ms, plain_ms, count * 8, (count - 1) * _mont_words(2),
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
    return launches


# The kernels of the paths.
_SOURCES = {
    "mont_mul_fr": ("zktpu_torch/csrc/mont_mul.cu", "zktpu/fields/pallas_mont.py:363"),
    "mont_mul_fq": ("zktpu_torch/csrc/mont_mul.cu", "zktpu/fields/pallas_mont.py:363"),
    # FRI's from_mont and the fold's r * odd
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
    # the fold's even + r * odd
    "field_addsub_gl": ("zktpu_torch/csrc/field_ops.cu", "zktpu/fields/fp.py:270"),
    # the domains' twiddle and coset power tables above 2^12 points
    "field_scan_gl": ("zktpu_torch/csrc/field_ops.cu", "zktpu/fields/fp.py:324"),
    # the Goldilocks stage loop of zktpu's _transform around kernel 1 (pallas_mont.py:363): FRI's coset NTT
    "ntt_gl": ("zktpu_torch/csrc/ntt.cu", "zktpu/poly/domain.py:116"),
    # sha256_single_block (:53) with the numpy block building and the digest fold of the same file
    "sha256_field": ("zktpu_torch/csrc/sha256.cu", "zktpu/hash/sha256_vec.py:53"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=14, help="log2 of the PLONK path's circuit size")
    ap.add_argument("--msm-log-n", type=int, default=20, help="log2 of the MSM path's point count")
    ap.add_argument("--fri-log-n", type=int, default=20, help="log2 of the FRI path's domain (blowup 2)")
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
    from zktpu_torch.fields import field_kernel, mont_kernel
    from zktpu_torch.fields.host import FQ, FR, GOLDILOCKS
    from zktpu_torch.hash import sha256_kernel
    from zktpu_torch.poly import ntt_kernel

    attrs = {k: g1_kernel.kernel_attrs(k) for k in ("proj_add", "proj_madd", "proj_double", "horner_combine")}
    attrs["ntt_fr"] = ntt_kernel.kernel_attrs(FR)
    attrs["ntt_gl"] = ntt_kernel.kernel_attrs(GOLDILOCKS)
    attrs.update({k: field_kernel.kernel_attrs(k) for k in ("field_scan", "field_addsub")})
    attrs["sha256_field"] = sha256_kernel.kernel_attrs()
    for spec in (FR, FQ):
        for variant in ("mxu", "f32"):
            attrs[f"mont_mul_chain_{variant} {spec.name}"] = mont_kernel.mont_mma_attrs(spec, variant)
    print("phase 1: registers " + "; ".join(
        f"{k}: {a['registers']} registers, {a['local_bytes']} local bytes, {a['shared_bytes']} shared bytes per block"
        for k, a in attrs.items()), flush=True)
    assert all(a["local_bytes"] == 0 for a in attrs.values()), f"a kernel spills: {attrs}"
    phase_chain_sass()

    kernels = phase_kernels(device)
    phase_small_path_shapes(device, kernels)
    phase_ntt_horner(device, kernels, ntt_sizes=((args.log_n + 3, 7), (20, 1), (1, 3), (8, 3)))
    phase_field_ops(device, kernels, args.log_n, args.msm_log_n)
    phase_fri_kernels(device, kernels, args.fri_log_n)
    phase_small_proof(device)
    plonk = phase_plonk(device, args.log_n)
    msm_path, tool, inputs = phase_msm(device, args.msm_log_n)
    phase_path_shapes(device, inputs, kernels)
    del inputs
    torch.cuda.empty_cache()
    fri = phase_fri(device, args.fri_log_n, kernels)

    rows = []
    for name, (source, replaces) in _SOURCES.items():
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": plonk[name] + msm_path[name] + tool[name] + fri[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # no PyTorch call computes a Montgomery product, a curve add, a Montgomery NTT or SHA-256
            "library_ms": None,
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
