"""A plain PLONK prover for the multiplication-chain circuit, for the reference.

The circuit: n gates a_i b_i = c_i with a_{i+1} = c_i wired by the copy
permutation (k1 = 2, k2 = 3 coset shifts), the witness b_i drawn as 16-bit
integers from numpy's default_rng(witness seed), a_0 = the witness seed.
The protocol is sota-zk-labs/zkp-implementation's plonk/src/prover.rs: the
wires and z blinded by multiples of X^n - 1, the quotient t = (gate + alpha
permutation + alpha^2 L1 (z - 1)) / Z_H split into three slices of
ceil(len(t) / 3) coefficients, the linearisation r(X), the two opening
witnesses, and the SHA-256 challenge chain of ./transcript.py.

Every commitment is computed through the SRS's secret s: the commitment of
p is [p(s)] G, so no MSM is needed; an opening witness (p(X) - p(z)) / (X - z)
is committed as [(p(s) - p(z)) / (s - z)] G.  The quotient needs t's
coefficients, so it is evaluated on the 4n coset 7 <w_4n> and interpolated.
All vector work is ./field.py on 16-bit limbs; nothing here imports the
program under test.
"""
from __future__ import annotations

import numpy as np
import torch

from . import curve
from .curve import R
from .field import LIMBS, PlainField
from .transcript import StdRng, Transcript, fp_rand

K1, K2 = 2, 3
COSET = curve.FR_GENERATOR


def witness_b(seed: int, n: int) -> np.ndarray:
    """The multiplication chain's b_i: n integers in [1, 2^16) from default_rng(seed)."""
    return np.random.default_rng(seed).integers(1, 1 << 16, size=n, dtype=np.uint64)


class MulChainReference:
    def __init__(self, log_n: int, secret: int, device, scalar_bits: int = 256):
        """scalar_bits below 256 commits every coefficient vector cut to its
        low scalar_bits bits (a control that drops precision)."""
        self.n = n = 1 << log_n
        self.s = secret % R
        self.F = F = PlainField(R, device)
        self.scalar_bits = scalar_bits
        self.w = curve.root_of_unity(n)
        self.w4 = curve.root_of_unity(4 * n)
        roots = F.powers(self.w, n)
        self.s_pows = F.powers(self.s, n + 3)
        k1r, k2r = F.scale(roots, K1), F.scale(roots, K2)
        self.roots = roots
        self.sig_e = [
            torch.cat([roots[:, :1], k2r[:, :-1]], 1),
            k1r,
            torch.cat([roots[:, 1:], k2r[:, -1:]], 1),
        ]
        self.sig = [F.intt(e, self.w) for e in self.sig_e]
        self.sig_s = [self.commit_value(c) for c in self.sig]
        m = 4 * n
        self.gpow = F.powers(COSET, n + 3)
        self.ginv_pow = F.powers(pow(COSET, -1, R), m)
        self.x4 = F.scale(F.powers(self.w4, m), COSET)
        g_n, w4_n = pow(COSET, n, R), pow(self.w4, n, R)
        zh = [(g_n * pow(w4_n, j, R) - 1) % R for j in range(4)]
        self.zh4 = F.from_ints(zh).repeat(1, n)
        self.zh4_inv = F.from_ints([pow(v, -1, R) for v in zh]).repeat(1, n)
        self.x4z = F.mul(self.x4, self.zh4)  # x Z_H(x) and x^2 Z_H(x) on the coset
        self.x2z = F.mul(self.x4, self.x4z)
        self.sig4 = [self.coset_eval(c) for c in self.sig]
        self.l1_4 = self.coset_eval(F.const(pow(n, -1, R)).repeat(1, n))
        self._wit: dict[int, dict] = {}

    # -- helpers --

    def coset_eval(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Values at 7 w_4n^j, j < 4n, of the polynomial with these coefficients."""
        F, m = self.F, 4 * self.n
        c = F.mul(coeffs, self.gpow[:, : coeffs.shape[1]])
        c = torch.cat([c, torch.zeros((LIMBS, m - c.shape[1]), dtype=c.dtype, device=c.device)], 1)
        return F.ntt(c, self.w4)

    def coset_interp(self, values: torch.Tensor) -> torch.Tensor:
        return self.F.mul(self.F.intt(values, self.w4), self.ginv_pow)

    def commit_value(self, coeffs: torch.Tensor) -> int:
        """p(s) for the coefficient vector p."""
        return self.F.dot(coeffs, self.s_pows[:, : coeffs.shape[1]])

    def committed(self, exact: int, coeffs: torch.Tensor, *blind) -> int:
        """The scalar committed for p = coeffs + (blind_0 + blind_1 X + ...)(X^n - 1):
        p(s) (exact), or with scalar_bits below 256 the control's sum of
        every coefficient cut to its low scalar_bits bits times s^i."""
        if self.scalar_bits >= 256:
            return exact
        F, n = self.F, self.n
        width = max(coeffs.shape[1], n + len(blind)) if blind else coeffs.shape[1]
        full = torch.cat([coeffs, torch.zeros((LIMBS, width - coeffs.shape[1]), dtype=coeffs.dtype,
                                              device=coeffs.device)], 1)
        if blind:
            idx = list(range(len(blind))) + list(range(n, n + len(blind)))
            vals = [(-b) % R for b in blind] + [b % R for b in blind]
            full[:, idx] = F.add(full[:, idx], F.from_ints(vals))
        raw = F.mul(full, F.from_ints_raw(1))  # canonical limbs
        raw[self.scalar_bits // 16:] = 0
        return self.commit_value(F.to_mont(raw))

    def witness(self, seed: int) -> dict:
        if seed in self._wit:
            return self._wit[seed]
        F, n = self.F, self.n
        b_e = F.from_small(torch.from_numpy(witness_b(seed, n).astype(np.int64)))
        first = F.scale(b_e[:, :1], seed)
        c_e = F.cumprod(torch.cat([first, b_e[:, 1:]], 1))
        a_e = torch.cat([F.const(seed), c_e[:, :-1]], 1)
        wit = {"e": (a_e, b_e, c_e)}
        wit["coeffs"] = [F.intt(e, self.w) for e in wit["e"]]
        wit["at_s"] = [self.commit_value(c) for c in wit["coeffs"]]
        wit["coset"] = [self.coset_eval(c) for c in wit["coeffs"]]
        self._wit[seed] = wit
        return wit

    # -- the proof --

    def prove(self, witness_seed: int, blind_seed: int) -> dict:
        F, n, s = self.F, self.n, self.s
        wit = self.witness(witness_seed)
        a_e, b_e, c_e = wit["e"]
        rng = StdRng(blind_seed)
        bl = [fp_rand(rng) for _ in range(6)]
        b7, b8, b9 = (fp_rand(rng) for _ in range(3))
        zh_s = (pow(s, n, R) - 1) % R

        # round 1: wires p + (lo + hi X)(X^n - 1)
        blinds = [(bl[1], bl[0]), (bl[3], bl[2]), (bl[5], bl[4])]
        wire_s = [(v + (lo + hi * s) * zh_s) % R for v, (lo, hi) in zip(wit["at_s"], blinds)]
        out = {"commitments": {}}
        tr = Transcript()
        for name, v, cf, bld in zip(("a", "b", "c"), wire_s, wit["coeffs"], blinds):
            out["commitments"][name] = pt = curve.mul(self.committed(v, cf, *bld))
            tr.feed(pt)
        beta, gamma = tr.challenges(2)

        # round 2: the grand product z in evaluation form
        def lin(e, k):  # e + k + gamma
            return F.add_const(F.add(e, k), gamma)

        broots = F.scale(self.roots, beta)
        num = F.mul(F.mul(lin(a_e, broots), lin(b_e, F.scale(broots, K1))), lin(c_e, F.scale(broots, K2)))
        den = F.mul(F.mul(lin(a_e, F.scale(self.sig_e[0], beta)), lin(b_e, F.scale(self.sig_e[1], beta))),
                    lin(c_e, F.scale(self.sig_e[2], beta)))
        pre_num = torch.cat([F.const(1), F.cumprod(num)[:, :-1]], 1)
        suf_den = F.cumprod(den, reverse=True)
        acc = F.scale(F.mul(pre_num, suf_den), pow(F.to_int(suf_den[:, :1]), -1, R))
        z_c = F.intt(acc, self.w)
        z_s = (self.commit_value(z_c) + (b9 + b8 * s + b7 * s * s) * zh_s) % R
        out["commitments"]["z"] = pt = curve.mul(self.committed(z_s, z_c, b9, b8, b7))
        tr.feed(pt)
        (alpha,) = tr.challenges(1)

        # round 3: t on the 4n coset, interpolated
        x4, zh4, x4z = self.x4, self.zh4, self.x4z
        wires4 = [F.add(w, F.add(F.scale(zh4, lo), F.scale(x4z, hi))) for w, (lo, hi) in zip(wit["coset"], blinds)]
        a4, b4, c4 = wires4
        z4 = F.add(self.coset_eval(z_c),
                   F.add(F.add(F.scale(zh4, b9), F.scale(x4z, b8)), F.scale(self.x2z, b7)))
        z4w = torch.roll(z4, -4, dims=1)
        bx = F.scale(x4, beta)
        t2 = F.mul(F.mul(lin(a4, bx), lin(b4, F.scale(bx, K1))), F.mul(lin(c4, F.scale(bx, K2)), z4))
        t3 = F.mul(F.mul(lin(a4, F.scale(self.sig4[0], beta)), lin(b4, F.scale(self.sig4[1], beta))),
                   F.mul(lin(c4, F.scale(self.sig4[2], beta)), z4w))
        gate = F.sub(F.mul(a4, b4), c4)  # q_m = 1, q_o = -1, q_l = q_r = q_c = pi = 0
        l1 = F.scale(F.mul(F.add_const(z4, R - 1), self.l1_4), alpha * alpha % R)
        numer = F.add(F.add(gate, F.scale(F.sub(t2, t3), alpha)), l1)
        t_c = self.coset_interp(F.mul(numer, self.zh4_inv))
        nz = torch.nonzero((t_c != 0).any(0))
        length = int(nz[-1]) + 1 if nz.numel() else 0
        if length > 3 * n + 6:
            raise AssertionError("the quotient has a remainder")
        tmp = max(-(-length // 3), 1)
        slices = [t_c[:, i * tmp: min((i + 1) * tmp, length)] for i in range(3)]
        t_s = [self.commit_value(sl) if sl.shape[1] else 0 for sl in slices]
        for name, v, sl in zip(("t_lo", "t_mid", "t_hi"), t_s, slices):
            out["commitments"][name] = pt = curve.mul(self.committed(v, sl) if sl.shape[1] else 0)
            tr.feed(pt)
        (zeta,) = tr.challenges(1)

        # round 4: evaluations at zeta and zeta w
        zw = zeta * self.w % R
        zp, zwp = F.powers(zeta, n), F.powers(zw, n)
        zh_z = (pow(zeta, n, R) - 1) % R
        bar_a, bar_b, bar_c = ((F.dot(cf, zp) + (lo + hi * zeta) * zh_z) % R
                               for cf, (lo, hi) in zip(wit["coeffs"], blinds))
        bar_s1, bar_s2, bar_s3 = (F.dot(cf, zp) for cf in self.sig)
        z_zeta = (F.dot(z_c, zp) + (b9 + b8 * zeta + b7 * zeta * zeta) * zh_z) % R
        bar_z_w = (F.dot(z_c, zwp) + (b9 + b8 * zw + b7 * zw * zw) * zh_z) % R
        zeta_pows = F.powers(zeta, tmp)
        t_z = [F.dot(sl, zeta_pows[:, : sl.shape[1]]) if sl.shape[1] else 0 for sl in slices]

        # round 5: v, the linearisation r and the two opening witnesses
        for val in (bar_a, bar_b, bar_c, bar_s1, bar_s2, bar_z_w):
            tr.feed(curve.mul(val))
        (v,) = tr.challenges(1)
        l2s = alpha * (bar_a + beta * zeta + gamma) * (bar_b + beta * K1 * zeta + gamma) \
            * (bar_c + beta * K2 * zeta + gamma) % R
        l3s = (bar_a + beta * bar_s1 + gamma) * (bar_b + beta * bar_s2 + gamma) * bar_z_w * alpha % R
        l1_e = zh_z * pow(n * (zeta - 1), -1, R) % R
        l4s = l1_e * alpha * alpha % R
        const = (-(bar_c + gamma) * l3s - l4s) % R
        shift = pow(zeta, tmp, R)

        def r_at(z_val, s3_val, t_vals):
            t_compact = t_vals[0] + shift * t_vals[1] + shift * shift * t_vals[2]
            return (bar_a * bar_b - bar_c + z_val * (l2s + l4s) - s3_val * beta * l3s - t_compact * zh_z
                    + const) % R

        r_s = r_at(z_s, self.sig_s[2], t_s)
        r_z = r_at(z_zeta, bar_s3, t_z)
        p_s = [*wire_s, self.sig_s[0], self.sig_s[1]]
        p_z = [bar_a, bar_b, bar_c, bar_s1, bar_s2]
        f_s, f_z, vk = r_s, r_z, 1
        for ps, pz in zip(p_s, p_z):
            vk = vk * v % R
            f_s, f_z = f_s + vk * ps, f_z + vk * pz
        w_x = (f_s - f_z) * pow(s - zeta, -1, R) % R
        w_wx = (z_s - bar_z_w) * pow(s - zw, -1, R) % R
        for name, val in (("w_ev_x", w_x), ("w_ev_wx", w_wx)):
            out["commitments"][name] = pt = curve.mul(val)
            tr.feed(pt)
        (u,) = tr.challenges(1)
        out["evaluations"] = {"bar_a": bar_a, "bar_b": bar_b, "bar_c": bar_c, "bar_s_sigma_1": bar_s1,
                              "bar_s_sigma_2": bar_s2, "bar_z_w": bar_z_w}
        out["challenges"] = {"u": u, "degree": tmp - 1}
        return out
