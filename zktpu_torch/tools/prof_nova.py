"""Run, time and trace Nova IVC on the card over a chain of squarings.

    python -m zktpu_torch.tools.prof_nova [--log-m 14] [--steps 64] [--seed S] [--repeat 1] [--trace]

The step circuit is z_(k+1) = z_k * z_k for k < m = 2^log_m (the step of
microsoft/Nova's benches/recursive-snark.rs, NonTrivialCircuit): an R1CS of
m constraints over Z = [z_0 ... z_m || x || u] (n = m + 3 columns, one public
input), A[k, k] = B[k, k] = C[k, k + 1] = 1, stored dense on the card as
zktpu stores it (three (m, n, 8) Montgomery tensors, built there: zeros and
the Montgomery one at 3m entries).  Each step's witness is made on the host:
2^log_m modular squarings of an input drawn from numpy's default_rng(seed);
its public input is z_m.  The IVC runs the loop of examples/nova_example.py
with an FCircuit whose state adds each step's z_m, mapped to the base field,
as the example's adds x^3 + x + 5.  Prints JSON lines, each with the card's
name and power limit:

- "setup": seconds to build the R1CS and the SRS (m + 6 points);
- "steps": per-step prove seconds (witness made and committed, hash, fold,
  openings) and verify seconds (the augmented circuit's run and
  IVC.verify), their medians, the final state against its host
  recomputation, launches by kernel over the whole run, and
  torch.cuda.max_memory_allocated;
- "split" (--repeat times): one fold step, the prove of step 0 and the
  verify of step 1 of a two-step run, in seconds by span, a span entered
  inside another counted in the outer one, with the card synchronised at
  its edges: compute_t (the six matrix-vector products), the commit of T,
  the witness commit (its MSM), the two opens (division and MSM),
  fold_witness, the host G1 and G2 scalar multiplications, the pairings,
  hash_io, and the rest;
- with --trace, "trace": a two-step run (one fold) under torch.profiler:
  launch calls, device kernels, wall and device seconds, idle share (the
  table by device time goes to stderr).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import numpy as np
import torch

SEED = 20261017
SRS_SECRET = 0x5EED5EED


def chain_r1cs(log_m: int, device=None):
    """The squaring chain's R1CS, dense on `device`."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FR
    from zktpu_torch.nova.r1cs import R1CS

    f = field(FR, device)
    m = 1 << log_m
    n = m + 3
    k = torch.arange(m, device=f.device)
    mats = []
    for col in (k, k, k + 1):
        mat = torch.zeros((m, n, f.num_limbs), dtype=torch.int32, device=f.device)
        mat[k, col] = f.one
        mats.append(mat)
    return R1CS(*mats, num_io=1, num_vars=m + 1)


def chain_inputs(steps: int, seed: int = SEED) -> list[int]:
    """One input z_0 < r a step, from numpy's default_rng(seed)."""
    from zktpu_torch.fields.host import FR

    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(steps, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR.modulus for row in words]


def chain_witness(z0: int, m: int) -> list[int]:
    """[z_0, ..., z_m] with z_(k+1) = z_k^2 mod r."""
    from zktpu_torch.fields.host import FR

    w = [z0]
    for _ in range(m):
        w.append(w[-1] * w[-1] % FR.modulus)
    return w


def last_to_base(value: int) -> int:
    """A scalar field element mapped to the base field by its 32 little-endian bytes (as the example's FCircuit)."""
    from zktpu_torch.fields.host import FQ

    return FQ.from_le_bytes_mod_order(value.to_bytes(32, "little"))


def chain_circuit():
    """The FCircuit that adds the step witness's last element, mapped to the base field."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FQ, FR
    from zktpu_torch.nova.circuit import FCircuit, State

    class ChainCircuit(FCircuit):
        def run(self, z_i: State, w_i) -> State:
            last = field(FR, w_i.w.device).decode_int(w_i.w[-1])
            return State(state=(z_i.state + last_to_base(last)) % FQ.modulus)

    return ChainCircuit()


def cubic_circuit():
    """The FCircuit of examples/nova_example.py: x^3 + x + 5 of the step
    witness's first entry, mapped to the base field and added to the state."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FQ, FR
    from zktpu_torch.nova.circuit import FCircuit, State

    class CubicCircuit(FCircuit):
        def run(self, z_i: State, w_i) -> State:
            x = field(FR, w_i.w.device).decode_int(w_i.w[0])
            return State(state=(z_i.state + last_to_base((x**3 + x + 5) % FR.modulus)) % FQ.modulus)

    return CubicCircuit()


def chain_step_witness(log_m: int, inputs: list[int]):
    """witness(step) -> (W, x) of the squaring chain for run_ivc."""
    m = 1 << log_m

    def witness(step):
        w = chain_witness(inputs[step], m)
        return w, [w[-1]]

    return witness


def _point(p) -> list:
    return [p.x, p.y, p.infinity]


def run_ivc(scheme, r1cs, f_circuit, witness, steps: int, device=None, check_verify=None, after_fold=None,
            step_times=None, before_prove=None, checkpoint=None) -> dict:
    """The IVC loop of examples/nova_example.py over `steps` steps.

    witness(step) -> (W as ints, x as ints): the step's witness and public
    input, committed when the step needs it.  check_verify(step, ivc,
    zk_proof) runs before each step's IVC.verify from step 1; before_prove(step)
    before each step's prove; after_fold(step, folded_witness,
    folded_instance) after each fold; checkpoint(step, augmented) after
    each step but the last returns the augmented circuit the loop goes on
    with (a resumed one: compat.load_ivc_state), under a new IVC.  Returns the step
    records (the augmented circuit's hash h_(i+1), and for each fold com_T,
    r, the folded instance and the NIFS openings, as plain ints), the
    states z_0 ... z_steps (the last from the last step's run), the final
    augmented circuit and the folded pair;
    step_times (a dict) gets per-step "prove_s" and "verify_s"."""
    from zktpu_torch.convert import finstance_to_ints
    from zktpu_torch.nova.circuit import AugmentedCircuit, State, base_to_scalar, hash_io
    from zktpu_torch.nova.ivc import IVC, IVCProof, ZkIVCProof
    from zktpu_torch.nova.r1cs import FInstance, FWitness
    from zktpu_torch.transcript.transcripts import NovaTranscript

    m = r1cs.matrix_a.shape[0]
    dev = r1cs.matrix_a.device if device is None else device

    def instance(step):
        w, x = witness(step)
        fw = FWitness.new(w, m, dev)
        return fw, fw.commit(scheme, x)

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    w_cur, u_cur = instance(0)
    # the all-zero pair of create_trivial_pair, with E of a row per constraint and W of one per
    # variable (zktpu's example has as many of each; the chain has one more variable)
    trivial_witness = FWitness(e=FWitness.new_trivial_witness(m, dev).e,
                               w=FWitness.new_trivial_witness(r1cs.num_vars, dev).w)
    trivial_instance = trivial_witness.commit(scheme, [0] * len(u_cur.x))
    z = [State(0)]
    verifier_transcript = NovaTranscript()
    augmented = AugmentedCircuit(f_circuit, trivial_instance, z[0])
    ivc = IVC(scheme, augmented)
    ivc_proof = IVCProof.trivial_ivc_proof(trivial_instance, trivial_witness)
    zk_proof = ZkIVCProof.trivial_zk_ivc_proof(trivial_instance)
    folded_witness, folded_instance = trivial_witness, trivial_instance
    records = [{"u0": finstance_to_ints(u_cur), "trivial": finstance_to_ints(trivial_instance)}]
    times = step_times if step_times is not None else {}
    times.setdefault("prove_s", [])
    times.setdefault("verify_s", [])
    for step in range(steps):
        t0 = time.perf_counter()
        if step == 0:
            h = augmented.run(u_cur, None, w_cur, None)
        else:
            h = augmented.run(ivc_proof.u_i, ivc_proof.big_u_i, ivc_proof.w_i, zk_proof.com_t)
            if check_verify is not None:
                check_verify(step, ivc, zk_proof)
        ivc.verify(zk_proof, verifier_transcript)
        times["verify_s"].append(time.perf_counter() - t0)
        rec = {"step": step, "h": h}
        if step != steps - 1:
            if before_prove is not None:
                before_prove(step)
            t0 = time.perf_counter()
            z.append(f_circuit.run(z[-1], w_cur))
            augmented.next_step()
            assert augmented.z_i.state == z[step + 1].state
            w_next, u_next = instance(step + 1)
            prover_transcript = NovaTranscript()
            verifier_transcript = NovaTranscript()
            hash_x = hash_io(step + 1, z[0], z[step + 1], folded_instance)
            u_next = FInstance(com_e=u_next.com_e, u=u_next.u, com_w=u_next.com_w, x=[base_to_scalar(hash_x)])
            ivc_proof = IVCProof(u_next, w_next, folded_instance, folded_witness)
            folded_witness, folded_instance, zk_proof = ivc.prove(r1cs, ivc_proof, prover_transcript)
            sync()
            times["prove_s"].append(time.perf_counter() - t0)
            if after_fold is not None:
                after_fold(step, folded_witness, folded_instance)
            nifs = zk_proof.folded_u_proof
            rec.update({
                "u_i": finstance_to_ints(u_next), "com_t": _point(zk_proof.com_t.point), "r": nifs.r,
                "folded": finstance_to_ints(folded_instance), "opening_point": nifs.opening_point,
                "opening_e": _point(nifs.opening_e.point) + [nifs.opening_e.evaluation],
                "opening_w": _point(nifs.opening_w.point) + [nifs.opening_w.evaluation],
            })
            w_cur = w_next
            if checkpoint is not None:
                augmented = checkpoint(step, augmented)
                ivc = IVC(scheme, augmented)
        records.append(rec)
    return {"records": records, "states": [s.state for s in z] + [augmented.z_i1.state], "augmented": augmented,
            "folded": (folded_witness, folded_instance), "times": times}


# -- the split of one step --

class _Spans:
    """Seconds by span.  A span is timed with what it calls, and a span
    entered inside another counts toward the outer one; the card is
    synchronised at each span's edges so that its work lands in the span
    that launched it."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.seconds: dict[str, float] = {}
        self._active = False

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            if self._active:
                return fn(*args, **kwargs)
            self._active = True
            if self.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if self.cuda:
                    torch.cuda.synchronize()
            finally:
                self._active = False
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            return out

        return timed


@contextlib.contextmanager
def spans(cuda: bool):
    """Patch the step's functions with span timers for the duration."""
    from zktpu_torch.curves.host_curve import G1Affine, G2Affine
    from zktpu_torch.kzg import scheme as kzg_scheme
    from zktpu_torch.nova import circuit, ivc, nifs, r1cs

    s = _Spans(cuda)
    targets = [
        (nifs.NIFS, "compute_t", "compute_t", True),
        (nifs.NIFS, "fold_witness", "fold_witness", True),
        (r1cs.FWitness, "commit", "commit_witness", False),
        (kzg_scheme.KzgScheme, "commit_coeffs", "commit_t", False),
        (kzg_scheme.KzgScheme, "open", "open", False),
        (G1Affine, "mul", "host_g1_mul", False),
        (G2Affine, "mul", "host_g2_mul", False),
        (kzg_scheme, "pairing_product", "pairing", False),
        (circuit, "hash_io", "hash_io", False),
        (ivc, "hash_io", "hash_io", False),
    ]
    saved = []
    for owner, attr, name, static in targets:
        orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        fn = orig.__func__ if static else orig
        timed = s.wrap(name, fn)
        setattr(owner, attr, staticmethod(timed) if static else timed)
        saved.append((owner, attr, orig))
    try:
        yield s.seconds
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def host_final_state(log_m: int, inputs: list[int]) -> int:
    """The FCircuit's final state recomputed on the host: the sum of each step's z_m in the base field."""
    from zktpu_torch.fields.host import FQ

    m = 1 << log_m
    return sum(last_to_base(chain_witness(z0, m)[-1]) for z0 in inputs) % FQ.modulus


def split_step(scheme, r1cs, inputs, log_m: int, device) -> dict:
    """Seconds by span of one fold step (the prove of step 0 and the verify
    of step 1 of a two-step run), and its wall time."""
    times: dict = {}
    marks = {}

    def before_prove(step, secs):
        secs.clear()
        torch.cuda.synchronize()
        marks["t0"] = time.perf_counter()

    with spans(cuda=True) as secs:
        run_ivc(scheme, r1cs, chain_circuit(), chain_step_witness(log_m, inputs), 2, device, step_times=times,
                before_prove=lambda step: before_prove(step, secs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - marks["t0"]
    split = dict(secs)
    return {"wall_s": wall, "prove_s": times["prove_s"][0], "verify_s": times["verify_s"][1], **split,
            "rest": wall - sum(split.values())}


def trace_step(scheme, r1cs, inputs, log_m: int, device, rows: int = 15) -> tuple[dict, str]:
    """A two-step run (one fold) under torch.profiler: (summary, table by device time)."""
    from zktpu_torch.tools.trace import trace_summary

    return trace_summary(lambda: run_ivc(scheme, r1cs, chain_circuit(), chain_step_witness(log_m, inputs), 2, device),
                         rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-m", type=int, default=14, help="log2 of the chain's constraints")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--repeat", type=int, default=1, help="fold steps to split into spans after the run")
    ap.add_argument("--trace", action="store_true", help="trace a two-step run with torch.profiler")
    ap.add_argument("--rows", type=int, default=15)
    args = ap.parse_args(argv)
    from zktpu_torch.fields.fp import norm_device
    from zktpu_torch.kzg import KzgScheme, Srs
    from zktpu_torch.tools import launches
    from zktpu_torch.tools.trace import smi

    device = norm_device(None)  # the current CUDA device; raises without one
    head = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi(), "log_m": args.log_m}
    inputs = chain_inputs(args.steps, args.seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r1cs = chain_r1cs(args.log_m, device)
    scheme = KzgScheme(Srs.new_from_secret(SRS_SECRET, (1 << args.log_m) + 3, device=device))
    torch.cuda.synchronize()
    print(json.dumps({**head, "setup": {"seconds": time.perf_counter() - t0, "srs_points": scheme.srs.size}}),
          flush=True)

    launches.reset()
    run = run_ivc(scheme, r1cs, chain_circuit(), chain_step_witness(args.log_m, inputs), args.steps, device)
    counts = launches.read()
    t = run["times"]
    print(json.dumps({**head, "steps": {
        "steps": args.steps, "prove_s": t["prove_s"], "verify_s": t["verify_s"],
        "prove_median_s": statistics.median(t["prove_s"]) if t["prove_s"] else None,
        "verify_median_s": statistics.median(t["verify_s"][1:]) if args.steps > 1 else None,
        "final_state_equals_host": run["states"][-1] == host_final_state(args.log_m, inputs),
        "launches": {k: v for k, v in counts.items() if v},
        "max_memory_allocated": torch.cuda.max_memory_allocated()}}), flush=True)
    del run
    for _ in range(args.repeat):
        print(json.dumps({**head, "split": split_step(scheme, r1cs, inputs, args.log_m, device)}), flush=True)
    if args.trace:
        summary, table = trace_step(scheme, r1cs, inputs, args.log_m, device, args.rows)
        print(json.dumps({**head, "trace": summary}), flush=True)
        print(table, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
