"""Write the goldens that the port's CPU tests compare against, from zktpu.

    JAX_PLATFORMS=cpu python tests/goldens/make_goldens.py [field_ops] [fri] [mont_mma]

- field_ops.npz: zktpu's DeviceField (cumprod and cumsum both ways, sum on
  axis 0 and 1, powers, batch_inv, add, sub, neg, double) on the inputs of
  tests/test_torch_field_ops.py, over Fr and Fq, repacked as the port's
  (..., L) int32 limbs;
- fri_2e13.json: zktpu's FRI proof of tests/test_torch_fri.py's golden
  coefficients (2^12 Goldilocks values from numpy's default_rng), blowup 2
  (a 2^13 domain: its first two layers take the vector hash), its
  GOLDEN_QUERIES queries, as plain ints;
- mont_mma.npz: for Fr and Fq, tests/test_torch_mont_mma.py's operands,
  zktpu's mont_mul_pallas (interpret mode: the matrix-unit path) chained
  CHAIN times, one product's m_cols and mp_cols (RowOps._const_mxu, on the
  steps of RowOps.mul), tools/prof_mulkernels.py's RowOpsF32 chained CHAIN
  times and one product's two f32 accumulators (the values its conv_full
  converts to int32), and mont_matmats; words as the port's (..., L) int32
  limbs, columns as (N, columns) int32 and the matrices as uint8.

Run once; the tests need neither JAX nor zktpu for these comparisons.  Not
collected by pytest.
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))


def field_ops() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_field_ops as t
    from zktpu.fields import host as zhost
    from zktpu.fields.fp import device_field
    from zktpu_torch.convert import digits_to_limbs
    from zktpu_torch.fields.host import FQ, FR

    out = {}
    for ours, theirs in ((FR, zhost.FR), (FQ, zhost.FQ)):
        df = device_field(theirs)
        p, rows = ours.modulus, t.ROWS

        def grid(pad, at_end):
            cols = []
            for n in t.SIZES:
                vals = np.array(t._inputs(ours, n)[0], dtype=object).reshape(n, 3)
                fill = np.full((rows - n, 3), pad, dtype=object)
                cols.append(np.concatenate([vals, fill] if at_end else [fill, vals]))
            g = np.concatenate(cols, axis=1)
            return df.encode_ints([int(v) for v in g.reshape(-1)]).reshape(rows, 3 * len(t.SIZES), -1)

        def put(key, arr):
            out[f"{ours.name}/{key}"] = digits_to_limbs(np.asarray(arr))

        res = {}
        fwd1, rev1, zeros = grid(1, True), grid(1, False), grid(0, True)
        res["cumprod", False], res["cumprod", True] = df.cumprod(fwd1), df.cumprod(rev1, reverse=True)
        res["cumsum", False], res["cumsum", True] = df.cumsum(zeros), df.cumsum(grid(0, False), reverse=True)
        sum0, sum1 = np.asarray(df.sum(zeros, axis=0)), np.asarray(df.sum(zeros.transpose(1, 0, 2), axis=1))
        count = rows * 3 * len(t.SIZES)
        inv_in = [v for n in t.SIZES for v in t._inputs(ours, n)[1]]
        inv_in += list(range(2, 2 + count - len(inv_in)))
        batch_inv = np.asarray(df.batch_inv(df.encode_ints(inv_in), host_inv=theirs.inv))
        start = 0
        for j, n in enumerate(t.SIZES):
            for op in ("cumprod", "cumsum"):
                for rev in (False, True):
                    rs = slice(rows - n, rows) if rev else slice(0, n)
                    put(f"{op}_{'rev' if rev else 'fwd'}_{n}", np.asarray(res[op, rev])[rs, 3 * j : 3 * j + 3])
            put(f"sum0_{n}", sum0[3 * j : 3 * j + 3])
            put(f"sum1_{n}", sum1[3 * j : 3 * j + 3])
            put(f"batch_inv_{n}", batch_inv[start : start + 3 * n].reshape(3, n, -1))
            start += 3 * n
        for z in t.POWER_BASES:
            put(f"powers_{z}", np.asarray(df.powers(z % p, rows))[:rows])
        va, vb = t._add_sub_values(ours)
        ad, bd = (df.encode_ints(v).reshape(3, 5, -1) for v in (va, vb))
        for k, (x, y) in enumerate(t._add_sub_operands(ad, bd)):
            put(f"add_{k}", df.add(x, y))
            put(f"sub_{k}", df.sub(x, y))
        put("neg", df.neg(ad))
        put("double", df.double(ad))
    np.savez_compressed(os.path.join(HERE, "field_ops.npz"), **out)


def fri() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_fri as t
    from zktpu.fields import host as zhost
    from zktpu.fri.prover import generate_proof
    from zktpu.poly.poly import Poly
    from zktpu_torch.convert import fri_proof_to_ints

    proof = generate_proof(Poly.from_ints(zhost.GOLDILOCKS, t.golden_coefficients()), 2, t.GOLDEN_QUERIES)
    with open(os.path.join(HERE, "fri_2e13.json"), "w") as f:
        json.dump(fri_proof_to_ints(proof), f, separators=(",", ":"))


def _f32_accumulators(conv_full, a, b):
    """accA and accB of RowOpsF32.conv_full(a, b): the two f32 values it
    converts to int32, read by evaluating its jaxpr one equation at a time."""
    import jax
    import jax.numpy as jnp
    from jax.extend.core import Literal

    closed = jax.make_jaxpr(conv_full)(a, b)
    env = dict(zip(closed.jaxpr.constvars, closed.consts))
    env.update(zip(closed.jaxpr.invars, (a, b)))
    seen = []
    for eqn in closed.jaxpr.eqns:
        ins = [v.val if isinstance(v, Literal) else env[v] for v in eqn.invars]
        if (eqn.primitive.name == "convert_element_type" and ins[0].dtype == jnp.float32
                and eqn.params["new_dtype"] == jnp.int32):
            seen.append(np.asarray(ins[0]))
        outs = eqn.primitive.bind(*ins, **eqn.params)
        for v, o in zip(eqn.outvars, outs if eqn.primitive.multiple_results else [outs]):
            env[v] = o
    assert len(seen) == 2, len(seen)
    return seen


def mont_mma() -> None:
    import importlib.util

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import test_torch_mont_mma as t
    from zktpu.fields import host as zhost
    from zktpu.fields.fp import device_field
    from zktpu.fields.pallas_mont import RowOps, _carry_rows, mont_matmats, mont_mul_pallas, row_consts
    from zktpu_torch.convert import digits_to_limbs

    # tools/prof_mulkernels.py reads N and its variants from sys.argv at import
    argv, sys.argv = sys.argv, [sys.argv[0], "256"]
    try:
        path = os.path.join(os.path.dirname(os.path.dirname(HERE)), "tools", "prof_mulkernels.py")
        spec_ = importlib.util.spec_from_file_location("prof_mulkernels", path)
        pmk = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(pmk)
    finally:
        sys.argv = argv

    out = {}
    for ours, theirs in ((t.FR, zhost.FR), (t.FQ, zhost.FQ)):
        df = device_field(theirs)
        D = theirs.num_digits
        va, vb = t.golden_inputs(ours)
        a, b = df.encode_ints(va), df.encode_ints(vb)  # (N, D) Montgomery digits
        x = a
        for _ in range(t.CHAIN):
            x = mont_mul_pallas(theirs, x, b, interpret=True)
        consts = row_consts(theirs).T
        ops = RowOps(theirs, consts, mont_matmats(theirs))
        aT, bT = jnp.asarray(a).T, jnp.asarray(b).T
        cols = ops.conv_full(aT, bT)
        t_lo, _ = _carry_rows(cols[:D], D)
        m_cols = ops._const_mxu(t_lo, ops.m_pinv_A, ops.m_pinv_B)
        m, _ = _carry_rows(m_cols, D)
        mp_cols = ops._const_mxu(m, ops.m_p_A, ops.m_p_B)
        f32 = pmk.RowOpsF32(theirs, consts, pmk.const_matmats(theirs))
        mul = jax.jit(f32.mul)
        y = aT
        for _ in range(t.CHAIN):
            y = mul(y, bT)
        acc_a, acc_b = _f32_accumulators(f32.conv_full, aT, bT)
        put = {
            "a": digits_to_limbs(np.asarray(a)), "b": digits_to_limbs(np.asarray(b)),
            "mxu_chain": digits_to_limbs(np.asarray(x)), "f32_chain": digits_to_limbs(np.asarray(y).T),
            "m_cols": np.asarray(m_cols).T.astype(np.int32), "mp_cols": np.asarray(mp_cols).T.astype(np.int32),
            "accA": acc_a.T.astype(np.int32), "accB": acc_b.T.astype(np.int32),
            "matmats": mont_matmats(theirs).astype(np.uint8),
        }
        assert all(np.array_equal(v, np.round(v)) for v in (acc_a, acc_b))
        assert all(np.asarray(v).max() < 2**31 for v in (m_cols, mp_cols)) and mont_matmats(theirs).max() < 256
        out.update({f"{ours.name}/{k}": v for k, v in put.items()})
    np.savez_compressed(os.path.join(HERE, "mont_mma.npz"), **out)


if __name__ == "__main__":
    which = sys.argv[1:] or ["field_ops", "fri", "mont_mma"]
    for name in which:
        {"field_ops": field_ops, "fri": fri, "mont_mma": mont_mma}[name]()
