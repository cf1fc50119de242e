"""The kernels' launch counters, read and set to 0 together.

Every kernel wrapper adds one to its counter where it launches its kernel
(per field where the wrapper serves several); a path's launches are the
counts read just after it, set to 0 just before it.
"""
from __future__ import annotations


def _wrappers():
    from zktpu_torch.curves.g1_kernel import fixed_base_mul, horner_combine, proj_add, proj_double, proj_madd
    from zktpu_torch.fields.lincomb_kernel import lincomb
    from zktpu_torch.fields.mont_kernel import mont_mul, mont_mul_chain
    from zktpu_torch.fri.fold_kernel import fold
    from zktpu_torch.hash.sha256_kernel import hash_field
    from zktpu_torch.nova.matvec_kernel import matvec
    from zktpu_torch.poly.ntt_kernel import ntt

    return (mont_mul, ntt, mont_mul_chain), (proj_add, proj_double, proj_madd, horner_combine, hash_field, fold,
                                             fixed_base_mul, matvec, lincomb)


def reset() -> None:
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


def read() -> dict:
    """Launches by kernel row name (mont_mul_fr, ntt_gl, field_scan_fq, ...)."""
    from zktpu_torch.fields import field_kernel
    from zktpu_torch.fields.host import FQ, FR, GOLDILOCKS

    (mont_mul, ntt, mont_mul_chain), (proj_add, proj_double, proj_madd, horner_combine, hash_field, fold,
                                      fixed_base_mul, matvec, lincomb) = _wrappers()
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
        "fri_fold": fold.launches,
        "fixed_base_mul": fixed_base_mul.launches,
        "matvec_fr": matvec.launches,
        "field_lincomb": lincomb.launches,
        **{f"{k}_{short}": field_kernel.launches[k][spec.name]
           for k in ("field_scan", "field_addsub") for short, spec in (("fr", FR), ("fq", FQ), ("gl", GOLDILOCKS))},
    }
