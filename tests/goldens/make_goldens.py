"""Write the goldens that the port's CPU tests compare against, from zktpu.

    JAX_PLATFORMS=cpu python tests/goldens/make_goldens.py

- field_ops.npz: zktpu's DeviceField (cumprod and cumsum both ways, sum on
  axis 0 and 1, powers, batch_inv, add, sub, neg, double) on the inputs of
  tests/test_torch_field_ops.py, over Fr and Fq, repacked as the port's
  (..., L) int32 limbs;
- fri_2e13.json: zktpu's FRI proof of tests/test_torch_fri.py's golden
  coefficients (2^12 Goldilocks values from numpy's default_rng), blowup 2
  (a 2^13 domain: its first two layers take the vector hash), its
  GOLDEN_QUERIES queries, as plain ints.

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


if __name__ == "__main__":
    field_ops()
    fri()
