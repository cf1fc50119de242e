"""PLONK prover (counterpart of zktpu/plonk/prover.py): the five rounds of
the reference's plonk/src/prover.rs, on limb tensors.

  - grand product z(x): evaluation-form ratios, a batch inversion and a
    log-depth cumulative product;
  - quotient t(X): coefficient-space products for small circuits, coset
    evaluation and a pointwise division by Z_H for large ones (8n coset up
    to config.QUOTIENT_8N_MAX_N, the 4n evaluation-form path above);
  - openings: division by (X - z) with the reference's exactness asserts.

The nine blinding scalars come from a zktpu StdRng through fp_rand, so with
the same SRS secret and seed the proof equals zktpu's, field by field.
"""
from __future__ import annotations

import secrets
import time
from dataclasses import dataclass

import torch

from ..fields.host import FR
from ..transcript.ark_rand import fp_rand
from ..transcript.chacha import StdRng
from ..transcript.transcripts import PlonkChallengeGenerator
from .. import config
from ..kzg.scheme import KzgCommitment, KzgScheme
from ..poly.domain import get_domain
from ..poly.poly import Poly, evaluate_many, poly_from_evals
from .constraint import CompiledCircuit
from .slice_polynomial import SlicePoly


@dataclass
class Proof:
    a_commit: KzgCommitment
    b_commit: KzgCommitment
    c_commit: KzgCommitment
    z_commit: KzgCommitment
    t_lo_commit: KzgCommitment
    t_mid_commit: KzgCommitment
    t_hi_commit: KzgCommitment
    w_ev_x_commit: KzgCommitment
    w_ev_wx_commit: KzgCommitment
    bar_a: int
    bar_b: int
    bar_c: int
    bar_s_sigma_1: int
    bar_s_sigma_2: int
    bar_z_w: int
    u: int
    degree: int


def generate_proof(
    compiled_circuit: CompiledCircuit,
    srs,
    rng: StdRng | None = None,
    timings: dict | None = None,
    force: str | None = None,
) -> Proof:
    """rng: source of the 9 blinding scalars (seed it for a deterministic proof).

    timings: optional dict filled with wall seconds per dotted segment
    ("round1.wires", "round1.commits", ...) and per round ("round1" ...
    "round5"); the device is synchronised at each mark.
    force: "coset" | "coeff" | None, passed to compute_quotient_polynomial.
    """
    if rng is None:
        rng = StdRng(secrets.token_bytes(32))
    scheme = KzgScheme(srs)
    n = compiled_circuit.size
    gc = compiled_circuit.gate_constraints
    cc = compiled_circuit.copy_constraints
    device = gc.f_ax.device
    dom = get_domain(FR, n, device)
    t_round = time.perf_counter()

    def _mark(name: str):
        nonlocal t_round
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            timings[name] = now - t_round
            t_round = now

    def const_poly(values) -> Poly:
        return Poly.from_ints(FR, values, device)

    # ---- Round 1 (prover.rs:64-92) ----
    b = [fp_rand(FR, rng) for _ in range(6)]
    ax = gc.f_ax + const_poly([b[1], b[0]]).mul_by_vanishing(n)
    bx = gc.f_bx + const_poly([b[3], b[2]]).mul_by_vanishing(n)
    cx = gc.f_cx + const_poly([b[5], b[4]]).mul_by_vanishing(n)
    _mark("round1.wires")
    a_commit, b_commit, c_commit = scheme.commit_many([ax, bx, cx])
    _mark("round1.commits")

    # ---- Round 2 (prover.rs:94-127) ----
    challenge = PlonkChallengeGenerator()
    challenge.feed(a_commit)
    challenge.feed(b_commit)
    challenge.feed(c_commit)
    beta, gamma = challenge.generate_challenges(2)

    b7, b8, b9 = (fp_rand(FR, rng) for _ in range(3))
    w = dom.element(1)
    pre4 = const_poly([b9, b8, b7]).mul_by_vanishing(n)
    pre4w = const_poly([b9, FR.mul(b8, w), FR.mul(b7, dom.element(2))]).mul_by_vanishing(n)
    acc_x, acc_wx = compute_acc(beta, gamma, dom, compiled_circuit)
    z_x = pre4 + acc_x
    z_wx = pre4w + acc_wx
    _mark("round2.grand_product")
    z_commit = scheme.commit(z_x)
    _mark("round2.commit")

    # ---- Round 3 (prover.rs:129-150) ----
    challenge.feed(z_commit)
    (alpha,) = challenge.generate_challenges(1)
    tx = compute_quotient_polynomial(
        beta, gamma, alpha, ax, bx, cx, z_x, z_wx, dom, compiled_circuit, force=force
    )
    _mark("round3.quotient")
    slice_poly = SlicePoly(tx)
    t_lo_commit, t_mid_commit, t_hi_commit = slice_poly.commit(scheme)
    _mark("round3.commits")

    # ---- Round 4 (prover.rs:152-178) ----
    challenge.feed(t_lo_commit)
    challenge.feed(t_mid_commit)
    challenge.feed(t_hi_commit)
    (zeta,) = challenge.generate_challenges(1)
    (
        bar_a, bar_b, bar_c,
        bar_s_sigma_1, bar_s_sigma_2, bar_s_sigma_3,
        pi_e, z_zeta,
    ) = evaluate_many(
        [ax, bx, cx, cc.s_sigma_1, cc.s_sigma_2, cc.s_sigma_3, gc.pi_x, z_x], zeta
    )
    bar_z_w = z_x.evaluate(FR.mul(zeta, w))
    tx_compact = slice_poly.compact(zeta)
    _mark("round4.evals")

    # ---- Round 5 (prover.rs:180-272) ----
    for val in (bar_a, bar_b, bar_c, bar_s_sigma_1, bar_s_sigma_2, bar_z_w):
        challenge.feed(scheme.commit_para(val))
    (v,) = challenge.generate_challenges(1)

    r_x = compute_linearisation_polynomial(
        beta, gamma, alpha, zeta,
        bar_a, bar_b, bar_c, bar_s_sigma_1, bar_s_sigma_2, bar_z_w,
        pi_e, tx_compact, z_x, dom, compiled_circuit,
        bar_s_sigma_3=bar_s_sigma_3, z_zeta=z_zeta,
    )
    _mark("round5.linearisation")
    bar_r = r_x.evaluate(zeta)

    # w_ev_x = (r - bar_r) + sum_k v^k (P_k - bar_k) for P_k = a, b, c, s_sigma_1, s_sigma_2: one
    # field_lincomb of five products by scalars, r, and the constant -(bar_r + sum_k v^k bar_k) at row 0
    # (zktpu's chain: six subs, five scales, five adds; the same words, csrc/lincomb.cuh)
    polys = (ax, bx, cx, cc.s_sigma_1, cc.s_sigma_2)
    vk = [FR.pow(v, k) for k in range(1, 6)]
    const = bar_r
    for vi, bar in zip(vk, (bar_a, bar_b, bar_c, bar_s_sigma_1, bar_s_sigma_2)):
        const = FR.add(const, FR.mul(vi, bar))
    w_ev_x = _lincomb_poly(r_x.df, [(P, k, 1) for P, k in zip(polys, vk)], [(r_x, 1), (const, -1)])
    w_ev_x, rem = w_ev_x.divide_by_linear(zeta)
    assert rem == 0, "w_ev_x was computed incorrectly"

    w_ev_wx, rem = _sub_para(z_x, bar_z_w).divide_by_linear(FR.mul(zeta, w))
    assert rem == 0, "w_ev_wx was computed incorrectly"
    _mark("round5.witness_polys")

    w_ev_x_commit, w_ev_wx_commit = scheme.commit_many([w_ev_x, w_ev_wx])
    challenge.feed(w_ev_x_commit)
    challenge.feed(w_ev_wx_commit)
    (u,) = challenge.generate_challenges(1)
    _mark("round5.commits")
    if timings is not None:  # per-round totals from the dotted segment marks
        for rn in ("round1", "round2", "round3", "round4", "round5"):
            timings[rn] = sum(t for k, t in timings.items() if k.startswith(rn + "."))

    return Proof(
        a_commit, b_commit, c_commit, z_commit,
        t_lo_commit, t_mid_commit, t_hi_commit,
        w_ev_x_commit, w_ev_wx_commit,
        bar_a, bar_b, bar_c, bar_s_sigma_1, bar_s_sigma_2, bar_z_w,
        u, slice_poly.get_degree(),
    )


def _sub_para(poly: Poly, para: int) -> Poly:
    return poly - Poly.constant(FR, para, poly.device)


def _lincomb_poly(df, products, addends) -> Poly:
    """sum (+-) k P over `products` (Poly P, int k, sign) plus sum (+-) Q
    over `addends` (Poly Q or an int constant at X^0, sign): one
    field_lincomb (two past eight terms), its scalars and constants sent to
    the device in one copy, trimmed once as Poly.__add__ trims."""
    ints = [k % FR.modulus for _, k, _ in products] + [q % FR.modulus for q, _ in addends if isinstance(q, int)]
    enc = df.encode_ints(ints)
    prods = [(P.coeffs, enc[i:i + 1], s) for i, (P, _, s) in enumerate(products)]
    adds, j = [], len(products)
    for q, s in addends:
        if isinstance(q, int):
            adds.append((enc[j:j + 1], s))
            j += 1
        else:
            adds.append((q.coeffs, s))
    return Poly(FR, df.lincomb(prods, adds))


def compute_acc(beta: int, gamma: int, dom, compiled_circuit: CompiledCircuit):
    """Grand product z over the domain, in evaluation form.

    acc_e[0] = 1; acc_e[i] = prod_{j<i} num_j / den_j with
    num_j = (a_j + beta w^j + gamma)(b_j + beta k1 w^j + gamma)(c_j + beta k2 w^j + gamma)
    and den_j the same with the sigma evaluations.
    """
    cc = compiled_circuit.copy_constraints
    gc = compiled_circuit.gate_constraints
    n = compiled_circuit.size
    df = dom.df
    mul, add = df.mont_mul, df.add

    roots = dom.elements_device()
    a_e, b_e, c_e = (_eval_padded(gc.evals[k], n) for k in ("a", "b", "c"))
    s1, s2, s3 = (cc.evals[k] for k in ("s1", "s2", "s3"))
    beta_d, gamma_d = df.encode_int(beta), df.encode_int(gamma)

    broots = mul(roots, beta_d)
    num = mul(
        mul(add(add(a_e, broots), gamma_d), add(add(b_e, mul(broots, df.encode_int(cc.k1))), gamma_d)),
        add(add(c_e, mul(broots, df.encode_int(cc.k2))), gamma_d),
    )
    den = mul(
        mul(add(add(a_e, mul(s1, beta_d)), gamma_d), add(add(b_e, mul(s2, beta_d)), gamma_d)),
        add(add(c_e, mul(s3, beta_d)), gamma_d),
    )
    ratio = mul(num, df.batch_inv(den, host_inv=FR.inv))
    prefix = df.cumprod(ratio, axis=0)  # inclusive
    acc_e = torch.cat([df.one[None], prefix[: n - 1]], dim=0)
    acc_e_shifted = torch.roll(acc_e, -1, dims=0)  # rotate_left(1)
    return poly_from_evals(dom, acc_e), poly_from_evals(dom, acc_e_shifted)


def _eval_padded(arr: torch.Tensor, n: int) -> torch.Tensor:
    if arr.shape[0] == n:
        return arr
    pad = torch.zeros((n - arr.shape[0], arr.shape[1]), dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


def _div_vanishing_exact(poly: Poly, n: int) -> Poly:
    q, r = poly.divide_by_vanishing(n)
    if not r.is_zero():
        raise AssertionError("has remainder")  # reference expect("No remainder")
    return q


def compute_quotient_polynomial(
    beta, gamma, alpha, ax: Poly, bx: Poly, cx: Poly, z_x: Poly, z_wx: Poly, dom, compiled_circuit,
    force: str | None = None,
) -> Poly:
    """t(X) = [line1 + line2 - line3 + line4] / Z_H (prover.rs:381-444).

    Small circuits use coefficient-space products; large ones evaluate each
    part on a coset and divide pointwise (same coefficients).  Both raise
    AssertionError("has remainder") on a bad witness.

    force: "coset" | "coeff" | None, a test hook to pin the implementation.
    """
    use_coset = compiled_circuit.size >= 64 if force is None else force == "coset"
    if use_coset:
        return _quotient_coset(beta, gamma, alpha, ax, bx, cx, z_x, z_wx, dom, compiled_circuit)
    cc = compiled_circuit.copy_constraints
    gc = compiled_circuit.gate_constraints
    n = compiled_circuit.size
    device = ax.device

    def const(*values):
        return Poly.from_ints(FR, values, device)

    line1 = (ax * bx) * gc.q_mx + ax * gc.q_lx + bx * gc.q_rx + cx * gc.q_ox + gc.pi_x + gc.q_cx
    quotient1 = _div_vanishing_exact(line1, n)

    gb = const(gamma, beta)
    gbk1 = const(gamma, FR.mul(beta, cc.k1))
    gbk2 = const(gamma, FR.mul(beta, cc.k2))
    line2 = (((ax + gb) * (bx + gbk1)) * (cx + gbk2) * z_x).scale(alpha)

    g = const(gamma)
    line3 = (
        ((ax + cc.s_sigma_1.scale(beta) + g) * (bx + cc.s_sigma_2.scale(beta) + g))
        * (cx + cc.s_sigma_3.scale(beta) + g)
        * z_wx
    ).scale(alpha)
    quotient23 = _div_vanishing_exact(line2 - line3, n)

    line4 = ((z_x - const(1)) * l1_poly(dom)).scale(FR.mul(alpha, alpha))
    quotient4 = _div_vanishing_exact(line4, n)
    return quotient1 + quotient23 + quotient4


def _batched_coset_fft(dom_big, polys: list[Poly], offset: int) -> torch.Tensor:
    """Evaluate all polys on offset * <w> in one batched transform: (K, m, 8)."""
    m = dom_big.size
    stacked = torch.stack([p._padded(m) for p in polys])
    return dom_big.coset_fft(stacked, offset, force_device=True)


def _coset_divide_zh(dom_big, evals: torch.Tensor, offset: int, n: int, max_deg: int) -> Poly:
    """Evaluations of a numerator on offset * <w_m> -> numerator / (X^n - 1).

    Z_H(offset w_m^i) = offset^n w_k^(i mod k) - 1 with k = m / n takes k
    values (inverted on the host).  If the interpolated quotient has nonzero
    coefficients above max_deg, the division had a remainder: a bad witness
    raises as the reference's expect("No remainder") does.
    """
    m = dom_big.size
    k = m // n
    off_n = FR.pow(offset, n)
    w_k = FR.pow(dom_big.group_gen, n)  # order-k root
    zh_vals, cur = [], off_n
    for _ in range(k):
        zh_vals.append(FR.sub(cur, 1))
        cur = FR.mul(cur, w_k)
    assert all(v != 0 for v in zh_vals), "coset offset hits the domain"
    zh_inv = dom_big.df.encode_ints([FR.inv(v) for v in zh_vals])  # (k, 8)
    # zh_inv against each block of k rows in place: the kernel reads its (k, 8) rows by a mask
    t_evals = dom_big.df.mont_mul(evals.reshape(m // k, k, -1), zh_inv).reshape(m, -1)
    coeffs = dom_big.coset_ifft(t_evals, offset)
    if bool((coeffs[max_deg + 1 :] != 0).any()):
        raise AssertionError("has remainder")  # reference expect("No remainder")
    return Poly(FR, coeffs[: max_deg + 1])


def _quotient_coset(
    beta, gamma, alpha, ax: Poly, bx: Poly, cx: Poly, z_x: Poly, z_wx: Poly, dom, compiled_circuit
) -> Poly:
    """Coset-evaluation quotient: the gate and L1 parts on the 4n coset, the
    permutation part (numerator degree 4n + 5) on the 8n coset, or on the 4n
    coset in evaluation form above config.QUOTIENT_8N_MAX_N."""
    cc = compiled_circuit.copy_constraints
    gc = compiled_circuit.gate_constraints
    n = compiled_circuit.size
    device = ax.device
    df = dom.df
    mul, add, sub = df.mont_mul, df.add, df.sub
    off = FR.generator
    beta_d, gamma_d, alpha_d = (df.encode_int(v) for v in (beta, gamma, alpha))

    # -- part 1: gate constraints, deg(num) <= 3n + 1 -> 4n points
    dom4 = get_domain(FR, 4 * n, device)
    A, B, C, QM, QL, QR, QO, QC, PI = _batched_coset_fft(
        dom4, [ax, bx, cx, gc.q_mx, gc.q_lx, gc.q_rx, gc.q_ox, gc.q_cx, gc.pi_x], off
    )
    line1 = add(
        add(add(mul(mul(A, B), QM), mul(A, QL)), add(mul(B, QR), mul(C, QO))),
        add(PI, QC),
    )
    q1 = _coset_divide_zh(dom4, line1, off, n, max_deg=2 * n + 1)

    def perm_lines(Ax, Bx, Cx, Zx, Zw, S1x, S2x, S3x, bX):
        """alpha (z f - z_w g) pointwise on a coset (prover.rs:381-420)."""
        t2 = mul(
            mul(add(add(Ax, bX), gamma_d), add(add(Bx, mul(bX, df.encode_int(cc.k1))), gamma_d)),
            mul(add(add(Cx, mul(bX, df.encode_int(cc.k2))), gamma_d), Zx),
        )
        t3 = mul(
            mul(add(add(Ax, mul(S1x, beta_d)), gamma_d), add(add(Bx, mul(S2x, beta_d)), gamma_d)),
            mul(add(add(Cx, mul(S3x, beta_d)), gamma_d), Zw),
        )
        return mul(sub(t2, t3), alpha_d)

    if n <= config.QUOTIENT_8N_MAX_N:
        # -- parts 2-3 (exact path): deg(num) <= 4n + 5 -> 8n points
        dom8 = get_domain(FR, 8 * n, device)
        A8, B8, C8, Z8, S1, S2, S3 = _batched_coset_fft(
            dom8, [ax, bx, cx, z_x, cc.s_sigma_1, cc.s_sigma_2, cc.s_sigma_3], off
        )
        Z8w = torch.roll(Z8, -8, dims=0)  # z(wX), w = w_8n^8: a rotation
        X8 = mul(dom8.elements_device(), df.encode_int(off))  # coset points
        line23 = perm_lines(A8, B8, C8, Z8, Z8w, S1, S2, S3, mul(X8, beta_d))
        q23 = _coset_divide_zh(dom8, line23, off, n, max_deg=3 * n + 5)
        Z4, L1_4 = _batched_coset_fft(dom4, [z_x, l1_poly(dom)], off)
    else:
        # -- parts 2-3 (evaluation form): t23 = num23 / Z_H has degree
        # <= 3n + 5 < 4n, so its values on the 4n coset determine it; a bad
        # witness trips the tail check with overwhelming probability over
        # beta and gamma rather than with certainty as on the 8n path
        Z4, S1, S2, S3, L1_4 = _batched_coset_fft(
            dom4, [z_x, cc.s_sigma_1, cc.s_sigma_2, cc.s_sigma_3, l1_poly(dom)], off
        )
        Z4w = torch.roll(Z4, -4, dims=0)  # z(wX), w = w_4n^4
        X4 = mul(dom4.elements_device(), df.encode_int(off))
        line23 = perm_lines(A, B, C, Z4, Z4w, S1, S2, S3, mul(X4, beta_d))
        q23 = _coset_divide_zh(dom4, line23, off, n, max_deg=3 * n + 5)

    # -- part 4: L1 (z - 1), deg(num) <= 2n + 1 -> 4n points
    line4 = mul(mul(sub(Z4, df.one), L1_4), df.encode_int(FR.mul(alpha, alpha)))
    q4 = _coset_divide_zh(dom4, line4, off, n, max_deg=n + 1)
    return q1 + q23 + q4


def l1_poly(dom) -> Poly:
    """First Lagrange basis polynomial: its coefficients are all 1/n."""
    inv_n = dom.df.encode_int(FR.inv(dom.size % FR.modulus))
    return Poly(FR, inv_n.expand(dom.size, -1).contiguous(), trim=False)


def compute_linearisation_polynomial(
    beta, gamma, alpha, zeta,
    bar_a, bar_b, bar_c, bar_s_sigma_1, bar_s_sigma_2, bar_z_w,
    pi_e, tx_compact: Poly, z_x: Poly,
    dom, compiled_circuit: CompiledCircuit,
    *, bar_s_sigma_3: int, z_zeta: int,
) -> Poly:
    """r(X) per plonk/src/prover.rs:469-568, with the reference's sanity
    identity asserted on the scalar evaluations."""
    cc = compiled_circuit.copy_constraints
    gc = compiled_circuit.gate_constraints

    l2s = alpha
    for t in (
        FR.add(FR.add(bar_a, FR.mul(beta, zeta)), gamma),
        FR.add(FR.add(bar_b, FR.mul(FR.mul(beta, cc.k1), zeta)), gamma),
        FR.add(FR.add(bar_c, FR.mul(FR.mul(beta, cc.k2), zeta)), gamma),
    ):
        l2s = FR.mul(l2s, t)

    l3s = FR.mul(
        FR.mul(
            FR.add(FR.add(bar_a, FR.mul(beta, bar_s_sigma_1)), gamma),
            FR.add(FR.add(bar_b, FR.mul(beta, bar_s_sigma_2)), gamma),
        ),
        FR.mul(bar_z_w, alpha),
    )

    # reference sanity check (prover.rs:514-553) on scalars
    line22 = FR.mul(
        FR.mul(
            FR.mul(
                FR.add(bar_a, FR.add(gamma, FR.mul(beta, zeta))),
                FR.add(bar_b, FR.add(gamma, FR.mul(FR.mul(beta, cc.k1), zeta))),
            ),
            FR.add(bar_c, FR.add(gamma, FR.mul(FR.mul(beta, cc.k2), zeta))),
        ),
        FR.mul(alpha, z_zeta),
    )
    line32 = FR.mul(
        FR.mul(
            FR.mul(
                FR.add(bar_a, FR.add(FR.mul(bar_s_sigma_1, beta), gamma)),
                FR.add(bar_b, FR.add(FR.mul(bar_s_sigma_2, beta), gamma)),
            ),
            FR.add(bar_c, FR.add(FR.mul(bar_s_sigma_3, beta), gamma)),
        ),
        FR.mul(alpha, bar_z_w),
    )
    diff2 = FR.sub(line32, line22)
    ev_line3 = FR.mul(l3s, FR.add(FR.mul(beta, bar_s_sigma_3), FR.add(bar_c, gamma)))
    cur = FR.sub(ev_line3, FR.mul(l2s, z_zeta))
    assert diff2 == cur, "Wrong: line2 or line3 of round 5"

    # L1(zeta) = (zeta^n - 1) / (n (zeta - 1)); zeta = 1 has negligible
    # probability for a transcript challenge
    z_h_e = dom.evaluate_vanishing(zeta)
    if zeta != 1:
        l1_e = FR.mul(z_h_e, FR.inv(FR.mul(dom.size % FR.modulus, FR.sub(zeta, 1))))
    else:  # pragma: no cover
        l1_e = l1_poly(dom).evaluate(zeta)
    # r = line1 + line2 - line3 + line4 - line5 with
    #   line1 = q_m bar_a bar_b + q_l bar_a + q_r bar_b + q_o bar_c + q_c + pi_e,
    #   line2 = z l2s, line3 = (s_sigma_3 beta + bar_c + gamma) l3s,
    #   line4 = (z - 1) l1_e alpha^2, line5 = t_compact z_h(zeta):
    # seven products by scalars, q_c and one constant at X^0: two field_lincomb launches for the nine terms,
    # one when a polynomial among them is zero (zktpu's chain: about twenty scales, adds and subs; the same
    # words, csrc/lincomb.cuh)
    l4s = FR.mul(l1_e, FR.mul(alpha, alpha))
    const = FR.sub(FR.sub(pi_e, FR.mul(FR.add(bar_c, gamma), l3s)), l4s)
    return _lincomb_poly(z_x.df, [
        (gc.q_mx, FR.mul(bar_a, bar_b), 1), (gc.q_lx, bar_a, 1), (gc.q_rx, bar_b, 1), (gc.q_ox, bar_c, 1),
        (z_x, FR.add(l2s, l4s), 1), (cc.s_sigma_3, FR.mul(beta, l3s), -1), (tx_compact, z_h_e, -1),
    ], [(gc.q_cx, 1), (const, 1)])
