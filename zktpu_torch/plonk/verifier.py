"""PLONK verifier (counterpart of zktpu/plonk/verifier.py).

Recomputes the challenges from the proof's commitments, forms r0, [D], [F]
and [E] with host commitment algebra, and checks one pairing equation.  As
in the reference, the verifier re-commits the eight circuit polynomials from
the full compiled circuit (one batched MSM on the SRS's device here).
"""
from __future__ import annotations

from ..curves.pairing import Fq12, pairing_product
from ..fields.host import FR
from ..transcript.transcripts import PlonkChallengeGenerator
from ..kzg.scheme import KzgScheme
from .constraint import CompiledCircuit
from .prover import Proof


class PlonkVerificationError(Exception):
    pass


def verify(compiled_circuit: CompiledCircuit, srs, proof: Proof) -> None:
    """Raises PlonkVerificationError if the proof is rejected."""
    scheme = KzgScheme(srs)
    gc = compiled_circuit.gate_constraints
    cc = compiled_circuit.copy_constraints
    q_m_c, q_l_c, q_r_c, q_o_c, q_c_c, s1_c, s2_c, s3_c = _circuit_commitments(compiled_circuit, scheme)

    alpha, beta, gamma, zeta, v, u = _verify_challenges(proof, scheme)
    if u != proof.u:
        raise PlonkVerificationError("Verify: Challenge verification failed.")

    n = compiled_circuit.size
    w = FR.root_of_unity(n)

    z_h_e = FR.sub(FR.pow(zeta, n), 1)
    l_1_e = FR.mul(z_h_e, FR.inv(FR.mul(n % FR.modulus, FR.sub(zeta, 1))))
    p_i_e = gc.pi_x.evaluate(zeta)

    r_0 = FR.sub(
        FR.sub(p_i_e, FR.mul(l_1_e, FR.mul(alpha, alpha))),
        FR.mul(
            FR.mul(
                FR.mul(
                    FR.add(FR.add(proof.bar_a, FR.mul(proof.bar_s_sigma_1, beta)), gamma),
                    FR.add(FR.add(proof.bar_b, FR.mul(proof.bar_s_sigma_2, beta)), gamma),
                ),
                FR.mul(FR.add(proof.bar_c, gamma), proof.bar_z_w),
            ),
            alpha,
        ),
    )

    d_line1 = (
        q_m_c.mul(FR.mul(proof.bar_a, proof.bar_b))
        + q_l_c.mul(proof.bar_a)
        + q_r_c.mul(proof.bar_b)
        + q_o_c.mul(proof.bar_c)
        + q_c_c
    )
    d2s = FR.mul(
        FR.mul(
            FR.mul(
                FR.add(FR.add(proof.bar_a, FR.mul(beta, zeta)), gamma),
                FR.add(FR.add(proof.bar_b, FR.mul(FR.mul(beta, cc.k1), zeta)), gamma),
            ),
            FR.add(FR.add(proof.bar_c, FR.mul(FR.mul(beta, cc.k2), zeta)), gamma),
        ),
        alpha,
    )
    d_line2 = proof.z_commit.mul(FR.add(FR.add(d2s, FR.mul(l_1_e, FR.mul(alpha, alpha))), u))
    d_line3 = s3_c.mul(
        FR.mul(
            FR.mul(
                FR.mul(
                    FR.add(FR.add(proof.bar_a, FR.mul(beta, proof.bar_s_sigma_1)), gamma),
                    FR.add(FR.add(proof.bar_b, FR.mul(beta, proof.bar_s_sigma_2)), gamma),
                ),
                FR.mul(alpha, beta),
            ),
            proof.bar_z_w,
        )
    )
    deg = proof.degree
    d_line4 = (
        proof.t_lo_commit
        + proof.t_mid_commit.mul(FR.pow(zeta, deg + 1))
        + proof.t_hi_commit.mul(FR.pow(zeta, deg * 2 + 2))
    ).mul(z_h_e)
    d = d_line1 + d_line2 - d_line3 - d_line4

    f = (
        d
        + proof.a_commit.mul(v)
        + proof.b_commit.mul(FR.pow(v, 2))
        + proof.c_commit.mul(FR.pow(v, 3))
        + s1_c.mul(FR.pow(v, 4))
        + s2_c.mul(FR.pow(v, 5))
    )

    e_scalar = FR.neg(r_0)
    bars = (proof.bar_a, proof.bar_b, proof.bar_c, proof.bar_s_sigma_1, proof.bar_s_sigma_2)
    for i, bar in enumerate(bars):
        e_scalar = FR.add(e_scalar, FR.mul(FR.pow(v, i + 1), bar))
    e_scalar = FR.add(e_scalar, FR.mul(u, proof.bar_z_w))
    e = scheme.commit_para(e_scalar)

    left_g1 = (proof.w_ev_x_commit + proof.w_ev_wx_commit.mul(u)).point
    right_g1 = (
        proof.w_ev_x_commit.mul(zeta)
        + proof.w_ev_wx_commit.mul(FR.mul(FR.mul(u, zeta), w))
        + f
        - e
    ).point
    if pairing_product([(left_g1, srs.g2s()), (-right_g1, srs.g2())]) != Fq12.one():
        raise PlonkVerificationError("Verify: Pairing failed, rejected")


def _circuit_commitments(compiled_circuit: CompiledCircuit, scheme: KzgScheme):
    """[q_m], [q_l], [q_r], [q_o], [q_c], [s_sigma_1..3]: one batched commit."""
    gc = compiled_circuit.gate_constraints
    cc = compiled_circuit.copy_constraints
    return scheme.commit_many(
        [gc.q_mx, gc.q_lx, gc.q_rx, gc.q_ox, gc.q_cx, cc.s_sigma_1, cc.s_sigma_2, cc.s_sigma_3]
    )


def _verify_challenges(proof: Proof, scheme: KzgScheme):
    challenge = PlonkChallengeGenerator.from_commitments([proof.a_commit, proof.b_commit, proof.c_commit])
    beta, gamma = challenge.generate_challenges(2)
    challenge.feed(proof.z_commit)
    (alpha,) = challenge.generate_challenges(1)
    challenge.feed(proof.t_lo_commit)
    challenge.feed(proof.t_mid_commit)
    challenge.feed(proof.t_hi_commit)
    (zeta,) = challenge.generate_challenges(1)
    for bar in (proof.bar_a, proof.bar_b, proof.bar_c, proof.bar_s_sigma_1, proof.bar_s_sigma_2, proof.bar_z_w):
        challenge.feed(scheme.commit_para(bar))
    (v,) = challenge.generate_challenges(1)
    challenge.feed(proof.w_ev_x_commit)
    challenge.feed(proof.w_ev_wx_commit)
    (u,) = challenge.generate_challenges(1)
    return alpha, beta, gamma, zeta, v, u
