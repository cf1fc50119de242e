"""Write the goldens that the port's CPU tests compare against, from zktpu.

    JAX_PLATFORMS=cpu python tests/goldens/make_goldens.py [field_ops] [fri] [fri_cases] [mont_mma] [nova] [matvec]
        [kzg_vector] [parser] [mont_mul_words] [plonk] [compat] [dist] [g1] [lincomb]

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

- fri_cases.json: zktpu's FRI pieces that tests/test_torch_fri.py compares
  with: its proofs of CASES (with its NTT host tier raised to 2^8), a
  128-point coset evaluation, folds at 2, 5 and 64 coefficients, and Merkle
  trees (levels, root and every proof) over Goldilocks and one over Fr;
- nova.json and nova.npz: zktpu's 4-step IVC of tests/test_nova.py (inputs
  3, 4, 1, 2, SRS secret 424242), step by step as
  zktpu_torch.tools.prof_nova.run_ivc records it (the hash h_(i+1), com_T,
  r, the new and the folded instance, the NIFS openings), its states, an
  opening of an all-zero E, the x^3 + x + 5 R1CS, the first witness and
  instance and the first fold's pair (for the converters); and
  matrix_vector_product, compute_t and fold_witness on an 8-squaring chain
  with operands from numpy's default_rng;
- nova_matvec.npz: zktpu.nova.utils.matrix_vector_product of
  tests/test_torch_nova.py's matvec_operands (a (16, 67) matrix and z of
  random canonical entries), with its encoded inputs;
- kzg_vector.json: the cases of tests/test_g1_msm_kzg.py:104-125 (scalar
  homomorphism, aggregate, batch_verify with StdRng seed 99 accepting and,
  with one evaluation changed, rejecting, the empty commit), commit_vector
  and open_vector, and StdRng(99)'s first gen_u128 draws;
- parser.json: the PLONK proofs (as tests/test_torch_parser.py's
  proof_bytes, hex) of tests/test_parser.py's equations (SRS secret 31337,
  StdRng seeds 5, 6 and 9) and the CPI commitments of the first;
- mont_mul_words.npz: for Fr, Fq and Goldilocks, tests/test_torch_fields.py's
  operands as zktpu's encode_ints gives them and their _mont_mul_jnp
  product, as zktpu's (N, D) uint32 digits;
- plonk_pythagorean.json and .npz: tests/test_torch_plonk.py's reference,
  zktpu's proof of the Pythagorean circuit (SRS secret SECRET, StdRng seed
  SEED), the SRS's host points, G2 points and (X, Y, Z) digit planes, and
  the compiled circuit's polynomial and evaluation digits, size, k1, k2;
- compat_srs.npz, compat_plonk.json, compat_fri.json and compat_ivc.json:
  files written by zktpu.compat's save functions (tests/test_torch_compat.py's
  inputs): a 16-point SRS, the PLONK proof of tests/test_compat.py, a FRI
  proof of 1 + 2x + ... + 6x^5, and the augmented circuit after two steps of
  the 4-step IVC of tests/goldens/nova.json;
- dist.json and dist.npz: zktpu.dist on its 8-device CPU mesh at the sizes
  of tests/test_dist.py (tests/test_torch_dist.py's inputs): the four-step
  fft and ifft at 64, 256 and 4096 points, fixed_base_mul's points [k] G
  for k = 2 .. 129, the sharded MSM of 64 of them at c = 4, dist_fri_layer's
  evaluations, levels and root at a 2^12 Goldilocks domain, the three wire
  commitments at n = 2^7 (tests/test_dist.py: 2^8) and the blinded ones at
  n = 2^6;
- g1.npz: zktpu's G1 group law on tests/test_torch_g1.py's points PTS1 and
  PTS2: host_points_to_device of both, and _proj_add_jnp of the pair and
  _proj_double_jnp of PTS1 (the complete formulas' edge lanes: identity
  operands, P + P, P + (-P), identity + identity), as the port's (N, 12)
  int32 limbs;
- lincomb.npz: zktpu's own chains of products and adds/subs on the operands
  of tests/test_torch_lincomb.py's lincomb_operands(): NIFS.compute_t and
  NIFS.fold_witness on its dense (M, N) R1CS of random entries, and PLONK
  round 5's w_ev_x chain (_sub_para, scale, + on zktpu's Poly) over its six
  polynomials of unequal lengths, as the port's (n, 8) int32 limbs.

Run once; the tests need neither JAX nor zktpu for these comparisons.  Not
collected by pytest.
"""
import json
import os
import sys

import numpy as np

# zktpu.dist's mesh needs 8 CPU devices, set before JAX is imported (as tests/conftest.py does)
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()

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


def _dump(name: str, obj) -> None:
    with open(os.path.join(HERE, name), "w") as f:
        json.dump(obj, f, separators=(",", ":"))


def _point(p) -> list:
    return [int(p.x), int(p.y), bool(p.infinity)]


def fri_cases() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_fri as t
    from zktpu.fields import host as z_host
    from zktpu.fri import merkle as z_merkle
    from zktpu.fri import prover as z_prover
    from zktpu.poly import domain as z_domain
    from zktpu.poly.poly import Poly as ZPoly
    from zktpu_torch.convert import fri_proof_to_ints, goldilocks_digits_to_limbs

    GL = z_host.GOLDILOCKS
    out = {"proofs": {}, "folds": {}, "merkle": {}}
    saved = z_domain.HOST_NTT_MAX
    z_domain.HOST_NTT_MAX = 1 << 8
    try:
        for case in t.CASES:
            proof = z_prover.generate_proof(ZPoly.from_ints(GL, t._coeffs(case[0], case[0])), case[1], case[2])
            out["proofs"][t.case_id(case)] = fri_proof_to_ints(proof)
    finally:
        z_domain.HOST_NTT_MAX = saved
    coeffs = t._coeffs(64, 64)
    want = z_domain.get_domain(GL, 128).coset_fft(ZPoly.from_ints(GL, coeffs)._padded(128), GL.generator)
    out["coset_fft_128"] = goldilocks_digits_to_limbs(np.asarray(want)).tolist()
    for n in t.FOLD_SIZES:
        coeffs, r = t.fold_inputs(n)
        folded = z_prover.fold_polynomial(ZPoly.from_ints(GL, coeffs), r)
        out["folds"][str(n)] = {"limbs": goldilocks_digits_to_limbs(np.asarray(folded.coeffs)).tolist(),
                                "ints": folded.to_ints()}

    def tree(vals, spec):
        tr = z_merkle.MerkleTree(vals, spec)
        proofs = []
        for i in range(len(tr.leaves)):
            try:
                pr = tr.generate_proof(i)
            except IndexError:
                proofs.append(None)
                continue
            proofs.append([pr.index, pr.leaf_val, list(pr.hash_proof), pr.root])
        return {"internal_nodes": tr.internal_nodes, "root": tr.root(), "leaves": tr.leaves, "depth": tr.depth,
                "proofs": proofs}

    for n in t.MERKLE_SIZES:
        out["merkle"][str(n)] = tree(t._coeffs(n, 100 + n), GL)
    out["merkle_fr"] = tree(t.FR_TREE_VALUES, z_host.FR)
    _dump("fri_cases.json", out)


def _zk_ivc_records(scheme, r1cs, f_circuit, witnesses, xs, steps: int) -> tuple[list, list, object]:
    """zktpu's IVC loop (examples/nova_example.py) with the records of
    zktpu_torch.tools.prof_nova.run_ivc, and the augmented circuit at its end."""
    from zktpu.nova.circuit import AugmentedCircuit, State, base_to_scalar, hash_io
    from zktpu.nova.ivc import IVC, IVCProof, ZkIVCProof
    from zktpu.nova.r1cs import FInstance, FWitness, create_trivial_pair
    from zktpu.transcript.transcripts import NovaTranscript
    from zktpu_torch.convert import finstance_to_ints

    m = r1cs.matrix_a.shape[0]
    w = [FWitness.new(wi, m) for wi in witnesses]
    u = [wi.commit(scheme, xi) for wi, xi in zip(w, xs)]
    trivial_witness, trivial_instance = create_trivial_pair(len(xs[0]), len(witnesses[0]), scheme)
    z = [State(0)]
    for index in range(1, steps + 1):
        z.append(f_circuit.run(z[index - 1], w[index - 1]))
    verifier_transcript = NovaTranscript()
    augmented = AugmentedCircuit(f_circuit, trivial_instance, z[0])
    ivc = IVC(scheme, augmented)
    ivc_proof = IVCProof.trivial_ivc_proof(trivial_instance, trivial_witness)
    zk = ZkIVCProof.trivial_zk_ivc_proof(trivial_instance)
    folded_witness, folded_instance = trivial_witness, trivial_instance
    records = [{"u0": finstance_to_ints(u[0]), "trivial": finstance_to_ints(trivial_instance)}]
    for step in range(steps):
        if step == 0:
            h = augmented.run(u[step], None, w[step], None)
        else:
            h = augmented.run(ivc_proof.u_i, ivc_proof.big_u_i, ivc_proof.w_i, zk.com_t)
        ivc.verify(zk, verifier_transcript)
        rec = {"step": step, "h": int(h)}
        if step != steps - 1:
            augmented.next_step()
            assert augmented.z_i.state == z[step + 1].state
            prover_transcript = NovaTranscript()
            verifier_transcript = NovaTranscript()
            hash_x = hash_io(step + 1, z[0], z[step + 1], folded_instance)
            u[step + 1] = FInstance(com_e=u[step + 1].com_e, u=u[step + 1].u, com_w=u[step + 1].com_w,
                                    x=[base_to_scalar(hash_x)])
            ivc_proof = IVCProof(u[step + 1], w[step + 1], folded_instance, folded_witness)
            folded_witness, folded_instance, zk = ivc.prove(r1cs, ivc_proof, prover_transcript)
            nifs = zk.folded_u_proof
            rec.update({
                "u_i": finstance_to_ints(u[step + 1]), "com_t": _point(zk.com_t.point), "r": int(nifs.r),
                "folded": finstance_to_ints(folded_instance), "opening_point": int(nifs.opening_point),
                "opening_e": _point(nifs.opening_e.point) + [int(nifs.opening_e.evaluation)],
                "opening_w": _point(nifs.opening_w.point) + [int(nifs.opening_w.evaluation)],
            })
        records.append(rec)
    return records, [int(s.state) for s in z], augmented


def _zk_cubic_circuit():
    """The FCircuit of examples/nova_example.py (x^3 + x + 5), in zktpu."""
    from zktpu.fields import host as zhost
    from zktpu.fields.fp import device_field
    from zktpu.nova.circuit import FCircuit, State

    frd = device_field(zhost.FR)

    class TestCircuitF(FCircuit):
        def run(self, z_i, w_i):
            x = frd.decode_int(w_i.w[0])
            res = (x**3 + x + 5) % zhost.FR.modulus
            base_res = zhost.FQ.from_le_bytes_mod_order(res.to_bytes(32, "little"))
            return State(state=(z_i.state + base_res) % zhost.FQ.modulus)

    return TestCircuitF()


def nova() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_nova as t
    from zktpu.kzg import KzgScheme, Srs
    from zktpu.nova import utils as zu
    from zktpu.nova.nifs import NIFS, gen_test_values
    from zktpu.nova.r1cs import FWitness, R1CS
    from zktpu.transcript.transcripts import NovaTranscript
    from zktpu_torch.convert import digits_to_limbs, finstance_to_ints

    r1cs, witnesses, xs = gen_test_values(t.INPUTS)
    scheme = KzgScheme(Srs.new_from_secret(t.SRS_SECRET, len(witnesses[0]) + len(xs[0]) + 1))
    records, states, _ = _zk_ivc_records(scheme, r1cs, _zk_cubic_circuit(), witnesses, xs, len(t.INPUTS))
    m = r1cs.matrix_a.shape[0]
    w0 = FWitness.new(witnesses[0], m)
    u0 = w0.commit(scheme, xs[0])
    w1 = FWitness.new(witnesses[1], m)
    u1 = w1.commit(scheme, xs[1])
    fw, fu, _, _ = NIFS.prover(r1cs, w0, w1, u0, u1, scheme, NovaTranscript())
    zero_e = NIFS.prove(t.ZERO_E_R, w0, u0, scheme, NovaTranscript())
    arrays = {"a": r1cs.matrix_a, "b": r1cs.matrix_b, "c": r1cs.matrix_c, "w0_e": w0.e, "w0_w": w0.w,
              "fold_e": fw.e, "fold_w": fw.w}
    out = {
        "records": records, "states": states, "u0": finstance_to_ints(u0), "fold": finstance_to_ints(fu),
        "zero_e": {"opening_point": int(zero_e.opening_point),
                   "opening_e": _point(zero_e.opening_e.point) + [int(zero_e.opening_e.evaluation)],
                   "opening_w": _point(zero_e.opening_w.point) + [int(zero_e.opening_w.evaluation)]},
    }
    # matrix_vector_product, compute_t and fold_witness on the 8-squaring chain
    a_rows, b_rows, c_rows = t.chain_rows(t.CHAIN_LOG_M)
    chain = R1CS(zu.to_f_matrix(a_rows), zu.to_f_matrix(b_rows), zu.to_f_matrix(c_rows), num_io=1,
                 num_vars=(1 << t.CHAIN_LOG_M) + 1)
    ops = t.chain_operands()
    z1, z2 = zu.to_f_vec(ops["z1"]), zu.to_f_vec(ops["z2"])
    tt = NIFS.compute_t(chain, ops["u1"], ops["u2"], z1, z2)
    f1 = FWitness(e=zu.to_f_vec(ops["e1"]), w=zu.to_f_vec(ops["w1"]))
    f2 = FWitness(e=zu.to_f_vec(ops["e2"]), w=zu.to_f_vec(ops["w2"]))
    folded = NIFS.fold_witness(ops["r"], f1, f2, tt)
    arrays.update({"chain_a": chain.matrix_a, "chain_az1": zu.matrix_vector_product(chain.matrix_a, z1),
                   "chain_cz2": zu.matrix_vector_product(chain.matrix_c, z2), "chain_t": tt,
                   "chain_fold_e": folded.e, "chain_fold_w": folded.w})
    _dump("nova.json", out)
    np.savez_compressed(os.path.join(HERE, "nova.npz"), **{k: digits_to_limbs(np.asarray(v)) for k, v in arrays.items()})


def matvec() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_nova as t
    from zktpu.nova import utils as zu
    from zktpu_torch.convert import digits_to_limbs

    rows, zs = t.matvec_operands()
    a, z = zu.to_f_matrix(rows), zu.to_f_vec(zs)
    arrays = {"a": a, "z": z, "az": zu.matrix_vector_product(a, z)}
    np.savez_compressed(os.path.join(HERE, "nova_matvec.npz"),
                        **{k: digits_to_limbs(np.asarray(v)) for k, v in arrays.items()})


def kzg_vector() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_kzg_vector as t
    from zktpu.fields import host as zhost
    from zktpu.kzg import KzgScheme, Srs
    from zktpu.poly.poly import Poly
    from zktpu.transcript.chacha import StdRng

    scheme = KzgScheme(Srs.new_from_secret(t.SECRET, t.SRS_SIZE))
    FR = zhost.FR
    poly = Poly.from_ints(FR, t.HOMOMORPHISM)
    f1, f2 = Poly.from_ints(FR, t.AGGREGATE[0]), Poly.from_ints(FR, t.AGGREGATE[1])
    c1, c2 = scheme.commit(f1), scheme.commit(f2)
    polys = [Poly.from_ints(FR, c) for c in t.BATCH_POLYS]
    openings = [scheme.open(f, z) for f, z in zip(polys, t.BATCH_POINTS)]
    commits = [scheme.commit(f) for f in polys]
    accept = scheme.batch_verify(commits, t.BATCH_POINTS, openings, StdRng.from_seed_u64(t.RNG_SEED))
    bad = list(openings)
    bad[2] = type(bad[2])(bad[2].point, bad[2].evaluation + 1)
    reject = scheme.batch_verify(commits, t.BATCH_POINTS, bad, StdRng.from_seed_u64(t.RNG_SEED))
    rng = StdRng.from_seed_u64(t.RNG_SEED)
    vec_open = scheme.open_vector(t.HOMOMORPHISM, t.VECTOR_POINT)
    out = {
        "homomorphism": {"c1": _point(scheme.commit(poly).point),
                         "c2": _point(scheme.commit(poly.scale(t.FACTOR)).point),
                         "c1_mul": _point(scheme.commit(poly).mul(t.FACTOR).point)},
        "aggregate": {"c1": _point(c1.point), "c2": _point(c2.point),
                      "batch": _point(KzgScheme.aggregate_commitments([c1, c2], t.CHALLENGE).point)},
        "batch": {"commits": [_point(c.point) for c in commits],
                  "openings": [_point(o.point) + [int(o.evaluation)] for o in openings],
                  "accept": bool(accept), "reject_changed_evaluation": bool(reject)},
        "empty": _point(scheme.commit(Poly.zero(FR)).point),
        "vector": {"commit": _point(scheme.commit_vector(t.HOMOMORPHISM).point),
                   "open": _point(vec_open.point) + [int(vec_open.evaluation)]},
        "gen_u128": [int(rng.gen_u128()) for _ in range(len(t.BATCH_POINTS))],
    }
    assert accept and not reject
    _dump("kzg_vector.json", out)


def parser() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_parser as t
    from zktpu.kzg import KzgScheme, Srs
    from zktpu.plonk.cpi import CPIGenerator
    from zktpu.plonk.parser import Parser
    from zktpu.plonk.prover import generate_proof
    from zktpu.transcript.chacha import StdRng

    srs = Srs.new_from_secret(t.SRS_SECRET, t.SRS_SIZE)
    proofs = {}
    for name, (eq, wit, seed) in t.PROOFS.items():
        p = Parser()
        for k, v in wit.items():
            p.add_witness(k, v)
        proofs[name] = t.proof_bytes(generate_proof(p.parse(eq).compile(), srs, rng=StdRng.from_seed_u64(seed))).hex()
    cpi = CPIGenerator().compute_common_preprocessed_input(t.PROOFS["e2e"][0], KzgScheme(srs))
    out = {"proofs": proofs, "cpi": {"n": cpi.n, "k1": cpi.k1, "k2": cpi.k2,
                                     **{k: _point(getattr(cpi, k).point) for k in t.CPI_COMMITS},
                                     "pi_x": [int(v) for v in cpi.pi_x.to_ints()]}}
    _dump("parser.json", out)


def mont_mul_words() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_fields as t
    from zktpu.fields.fp import device_field

    out = {}
    for spec in t.SPECS:
        df = device_field(spec)
        ad, bd = (df.encode_ints(v) for v in t._operands(spec))
        out.update({f"{spec.name}/a": np.asarray(ad), f"{spec.name}/b": np.asarray(bd),
                    f"{spec.name}/want": np.asarray(df._mont_mul_jnp(ad, bd))})
    np.savez_compressed(os.path.join(HERE, "mont_mul_words.npz"), **out)


def plonk() -> None:
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_plonk as t
    from zktpu.plonk.circuit import Circuit as ZCircuit
    from zktpu.plonk.prover import generate_proof
    from zktpu.transcript.chacha import StdRng

    zc = t.pythagorean(ZCircuit).compile()
    zsrs = t.zktpu_srs(t.SECRET, zc.size)
    proof = generate_proof(zc, zsrs, StdRng.from_seed_u64(t.SEED))
    gc, cc = zc.gate_constraints, zc.copy_constraints
    arrays = {f"coeffs/{n}": np.asarray(getattr(gc, n).coeffs) for n in t.GATE_POLYS}
    arrays.update({f"coeffs/{n}": np.asarray(getattr(cc, n).coeffs) for n in t.COPY_POLYS})
    arrays.update({f"evals/{k}": np.asarray(v) for k, v in {**gc.evals, **cc.evals}.items()})
    arrays.update({f"g1_proj/{i}": np.asarray(a) for i, a in enumerate(zsrs.g1_proj)})
    np.savez_compressed(os.path.join(HERE, "plonk_pythagorean.npz"), **arrays)

    def g2(p):
        return [int(p.x.c0), int(p.x.c1), int(p.y.c0), int(p.y.c1)]

    _dump("plonk_pythagorean.json", {
        "size": zc.size, "k1": cc.k1, "k2": cc.k2, "srs_size": zsrs.size,
        "g2": g2(zsrs.g2()), "g2s": g2(zsrs.g2s()), "srs_points": [_point(p) for p in zsrs.g1_points_host()],
        "proof": {f.name: _point(getattr(proof, f.name).point) if hasattr(getattr(proof, f.name), "point")
                  else int(getattr(proof, f.name)) for f in dataclasses.fields(proof)},
    })


def compat() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_compat as t
    from zktpu import compat as zc
    from zktpu.fields import host as zhost
    from zktpu.fri.prover import generate_proof as fri_prove
    from zktpu.kzg import KzgScheme, Srs
    from zktpu.nova.nifs import gen_test_values
    from zktpu.plonk.parser import Parser
    from zktpu.plonk.prover import generate_proof
    from zktpu.poly.poly import Poly
    from zktpu.transcript.chacha import StdRng

    zc.save_srs(os.path.join(HERE, "compat_srs.npz"), Srs.new_from_secret(t.SRS_SECRET, t.SRS_CIRCUIT_SIZE))
    p = Parser()
    for k, v in t.PLONK_WITNESSES.items():
        p.add_witness(k, v)
    compiled = p.parse(t.PLONK_EQ).compile()
    proof = generate_proof(compiled, Srs.new_from_secret(t.PLONK_SECRET, compiled.size),
                           rng=StdRng.from_seed_u64(t.PLONK_SEED))
    zc.save_plonk_proof(os.path.join(HERE, "compat_plonk.json"), proof)
    fri = fri_prove(Poly.from_ints(zhost.GOLDILOCKS, t.FRI_COEFFS), blowup_factor=t.FRI_BLOWUP,
                    number_of_queries=t.FRI_QUERIES)
    zc.save_fri_proof(os.path.join(HERE, "compat_fri.json"), fri)
    r1cs, witnesses, xs = gen_test_values(t.IVC_INPUTS)
    scheme = KzgScheme(Srs.new_from_secret(t.IVC_SECRET, len(witnesses[0]) + len(xs[0]) + 1))
    _, _, augmented = _zk_ivc_records(scheme, r1cs, _zk_cubic_circuit(), witnesses, xs, t.IVC_STEPS)
    zc.save_ivc_state(os.path.join(HERE, "compat_ivc.json"), augmented)


def dist() -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import test_torch_dist as t
    from zktpu.curves import g1
    from zktpu.curves.host_curve import G1Affine
    from zktpu.dist import ShardedWireCommitter, get_four_step, make_mesh, msm_jacobian_sharded
    from zktpu.dist.fri import dist_fri_layer
    from zktpu.fields import host as zhost
    from zktpu.fields.fp import device_field
    from zktpu.kzg.srs import Srs
    from zktpu.poly.poly import Poly
    from zktpu_torch.convert import digits_to_limbs

    mesh = make_mesh(t.GOLDEN_DEVICES)
    frd = device_field(zhost.FR)
    arrays, out = {}, {"devices": t.GOLDEN_DEVICES}
    for n in t.NTT_SIZES:
        fs = get_four_step(zhost.FR, n, mesh)
        x = frd.encode_ints(t.fr_values(n))
        arrays[f"ntt/{n}/fft"] = digits_to_limbs(np.asarray(fs.fft(x)))
        arrays[f"ntt/{n}/ifft"] = digits_to_limbs(np.asarray(fs.ifft(x)))
        print(f"dist: four-step {n}", flush=True)
    X, Y, Z = g1.fixed_base_mul(G1Affine.generator(), t.point_scalars(t.WIRE_N))
    arrays.update({f"points/{k}": digits_to_limbs(np.asarray(a)) for k, a in zip("XYZ", (X, Y, Z))})

    def affine(triples):
        return [_point(p) for p in g1.proj_to_affine_host(tuple(jnp.stack([q[i] for q in triples]) for i in range(3)))]

    m = t.MSM_N
    out["msm"] = affine([msm_jacobian_sharded(g1.scalars_to_u32(t.msm_scalars()), X[:m], Y[:m], Z[:m], mesh=mesh,
                                              c=t.MSM_C)])[0]
    print("dist: msm", flush=True)
    GL = zhost.GOLDILOCKS
    layer = dist_fri_layer(Poly.from_ints(GL, t.fri_coeffs()), GL.generator, 1 << t.FRI_LOG_DOMAIN, mesh)
    out["fri"] = {"evaluations": [int(v) for v in layer.evaluations], "levels": layer.merkle_tree.internal_nodes,
                  "root": int(layer.merkle_tree.root())}
    print("dist: fri", flush=True)
    evals3 = jnp.stack([frd.encode_ints(v) for v in t.wire_evals()])
    out["wires"] = affine(ShardedWireCommitter(zhost.FR, t.WIRE_N, mesh, c=t.WIRE_C)(evals3, X, Y, Z))
    print("dist: wires", flush=True)
    evals, blinds = t.blinded_inputs()
    committer = ShardedWireCommitter(zhost.FR, t.BLIND_N, mesh, c=t.WIRE_C)
    got = committer.commit_blinded(jnp.stack([frd.encode_ints(v) for v in evals]),
                                   Srs.new_from_secret(t.BLIND_SECRET, t.BLIND_N), blinds)
    out["blinded"] = [_point(p) for p in got]
    _dump("dist.json", out)
    np.savez_compressed(os.path.join(HERE, "dist.npz"), **arrays)


def g1() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_g1 as t
    from zktpu.curves import g1 as zg1
    from zktpu.curves.host_curve import G1Affine
    from zktpu_torch.convert import digits_to_limbs

    def ours(pts):  # the test's points are the port's host points: zktpu's, by coordinates
        return [G1Affine.identity() if p.infinity else G1Affine(p.x, p.y) for p in pts]

    P, Q = zg1.host_points_to_device(ours(t.PTS1)), zg1.host_points_to_device(ours(t.PTS2))
    arrays = {}
    for name, triple in (("P", P), ("Q", Q), ("add", zg1._proj_add_jnp(zg1.FQD, P, Q)),
                         ("double", zg1._proj_double_jnp(zg1.FQD, P))):
        arrays.update({f"{name}/{k}": digits_to_limbs(np.asarray(a)) for k, a in zip("XYZ", triple)})
    np.savez_compressed(os.path.join(HERE, "g1.npz"), **arrays)


def lincomb() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_lincomb as t
    from zktpu.fields.host import FR
    from zktpu.nova import utils as zu
    from zktpu.nova.nifs import NIFS
    from zktpu.nova.r1cs import FWitness, R1CS
    from zktpu.plonk.prover import _sub_para
    from zktpu.poly.poly import Poly
    from zktpu_torch.convert import digits_to_limbs

    ops = t.lincomb_operands()
    r1cs = R1CS(zu.to_f_matrix(ops["a"]), zu.to_f_matrix(ops["b"]), zu.to_f_matrix(ops["c"]), num_io=1,
                num_vars=t.N - 3)
    tt = NIFS.compute_t(r1cs, ops["u1"], ops["u2"], zu.to_f_vec(ops["z1"]), zu.to_f_vec(ops["z2"]))
    f1 = FWitness(e=zu.to_f_vec(ops["e1"]), w=zu.to_f_vec(ops["w1"]))
    f2 = FWitness(e=zu.to_f_vec(ops["e2"]), w=zu.to_f_vec(ops["w2"]))
    folded = NIFS.fold_witness(ops["r"], f1, f2, tt)
    polys = [Poly.from_ints(FR, c) for c in ops["polys"]]
    bars, v = ops["bars"], ops["v"]
    w_ev_x = _sub_para(polys[0], bars[0])
    for k in range(1, 6):
        w_ev_x = w_ev_x + _sub_para(polys[k], bars[k]).scale(FR.pow(v, k))
    arrays = {"t": tt, "fold_e": folded.e, "fold_w": folded.w, "w_ev_x": w_ev_x.coeffs}
    np.savez_compressed(os.path.join(HERE, "lincomb.npz"),
                        **{k: digits_to_limbs(np.asarray(a)) for k, a in arrays.items()})


TARGETS = {"field_ops": field_ops, "fri": fri, "fri_cases": fri_cases, "mont_mma": mont_mma, "nova": nova,
           "matvec": matvec, "kzg_vector": kzg_vector, "parser": parser, "mont_mul_words": mont_mul_words,
           "plonk": plonk, "compat": compat, "dist": dist, "g1": g1, "lincomb": lincomb}

if __name__ == "__main__":
    for name in sys.argv[1:] or list(TARGETS):
        TARGETS[name]()
