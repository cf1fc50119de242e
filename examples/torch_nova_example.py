"""Nova IVC example on zktpu_torch (the counterpart of nova_example.py,
which mirrors nova/examples/examples.rs:24-151).

4-step IVC accumulating x^3 + x + 5 over inputs (3, 4, 1, 2); per step the
augmented circuit F' folds the running instance via NIFS and the verifier
checks hash chaining, folding and the KZG openings.  The witnesses and the
commitments live on the current CUDA device (or the CPU with --device cpu).

    python examples/torch_nova_example.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zktpu_torch.fields import host  # noqa: E402
from zktpu_torch.fields.fp import field  # noqa: E402
from zktpu_torch.kzg import KzgScheme, Srs  # noqa: E402
from zktpu_torch.nova.circuit import AugmentedCircuit, FCircuit, State, base_to_scalar, hash_io  # noqa: E402
from zktpu_torch.nova.ivc import IVC, IVCProof, ZkIVCProof  # noqa: E402
from zktpu_torch.nova.nifs import gen_test_values  # noqa: E402
from zktpu_torch.nova.r1cs import FInstance, FWitness, create_trivial_pair  # noqa: E402
from zktpu_torch.transcript.transcripts import NovaTranscript  # noqa: E402

FR = host.FR


class TestCircuit(FCircuit):
    def run(self, z_i: State, w_i: FWitness) -> State:
        x = field(FR, w_i.w.device).decode_int(w_i.w[0])
        res = (x**3 + x + 5) % FR.modulus
        base_res = host.FQ.from_le_bytes_mod_order(res.to_bytes(32, "little"))
        return State(state=(z_i.state + base_res) % host.FQ.modulus)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    device = args.device

    # (3^3+3+5) + (4^3+4+5) + (1^3+1+5) + (2^3+2+5) = 130
    r1cs, witnesses, x = gen_test_values([3, 4, 1, 2], device=device)
    domain_size = len(witnesses[0]) + len(x[0]) + 1
    srs = Srs.new(domain_size, device=device)
    scheme = KzgScheme(srs)
    x_len = len(x[0])

    m = r1cs.matrix_a.shape[0]
    w = [FWitness.new(wi, m, device) for wi in witnesses]
    u = [wi.commit(scheme, xi) for wi, xi in zip(w, x)]

    trivial_witness, trivial_instance = create_trivial_pair(x_len, len(witnesses[0]), scheme, device)
    f_circuit = TestCircuit()

    z = [State(0)]
    for index in range(1, 5):
        z.append(f_circuit.run(z[index - 1], w[index - 1]))

    verifier_transcript = NovaTranscript()
    augmented_circuit = AugmentedCircuit(f_circuit, trivial_instance, z[0])
    ivc = IVC(scheme, augmented_circuit)

    ivc_proof = IVCProof.trivial_ivc_proof(trivial_instance, trivial_witness)
    zk_ivc_proof = ZkIVCProof.trivial_zk_ivc_proof(trivial_instance)
    folded_witness, folded_instance = trivial_witness, trivial_instance

    for step in range(4):
        print(f"Step: {step}")
        if step == 0:
            ivc.augmented_circuit.run(u[step], None, w[step], None)
        else:
            ivc.augmented_circuit.run(
                ivc_proof.u_i, ivc_proof.big_u_i, ivc_proof.w_i, zk_ivc_proof.com_t
            )
        ivc.verify(zk_ivc_proof, verifier_transcript)  # raises on rejection

        if step != 3:
            ivc.augmented_circuit.next_step()
            i = step + 1
            assert ivc.augmented_circuit.z_i.state == z[step + 1].state
            prover_transcript = NovaTranscript()
            verifier_transcript = NovaTranscript()

            hash_x = hash_io(i, z[0], z[step + 1], folded_instance)
            u[step + 1] = FInstance(
                com_e=u[step + 1].com_e,
                u=u[step + 1].u,
                com_w=u[step + 1].com_w,
                x=[base_to_scalar(hash_x)],
            )
            ivc_proof = IVCProof(u[step + 1], w[step + 1], folded_instance, folded_witness)
            folded_witness, folded_instance, zk_ivc_proof = ivc.prove(
                r1cs, ivc_proof, prover_transcript
            )
    print("Nova 4-step IVC: accepted")


if __name__ == "__main__":
    main()
