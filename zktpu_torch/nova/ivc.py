"""The IVC prover and verifier (counterpart of zktpu/nova/ivc.py)."""
from __future__ import annotations

from dataclasses import dataclass

from ..kzg.scheme import KzgCommitment, KzgScheme
from ..transcript.transcripts import NovaTranscript
from .circuit import AugmentedCircuit, base_to_scalar, hash_io
from .nifs import NIFS, NIFSProof
from .r1cs import R1CS, FInstance, FWitness, NovaError


@dataclass
class ZkIVCProof:
    u_i: FInstance
    big_u_i: FInstance
    com_t: KzgCommitment | None
    folded_u_proof: NIFSProof | None

    @classmethod
    def trivial_zk_ivc_proof(cls, trivial_instance: FInstance) -> "ZkIVCProof":
        return cls(trivial_instance, trivial_instance, None, None)


@dataclass
class IVCProof:
    u_i: FInstance
    w_i: FWitness
    big_u_i: FInstance
    big_w_i: FWitness

    @classmethod
    def trivial_ivc_proof(cls, trivial_instance: FInstance, trivial_witness: FWitness) -> "IVCProof":
        return cls(trivial_instance, trivial_witness, trivial_instance, trivial_witness)


class IVC:
    def __init__(self, scheme: KzgScheme, augmented_circuit: AugmentedCircuit):
        self.scheme = scheme
        self.augmented_circuit = augmented_circuit

    def prove(self, r1cs: R1CS, ivc_proof: IVCProof, prover_transcript: NovaTranscript):
        """Fold (u_i, w_i) into the running pair and open the result; at
        step 0 the running pair passes through."""
        if self.augmented_circuit.i != 0:
            big_w_out, big_u_out, com_t, r = NIFS.prover(
                r1cs, ivc_proof.w_i, ivc_proof.big_w_i, ivc_proof.u_i, ivc_proof.big_u_i, self.scheme,
                prover_transcript,
            )
            nifs_proof = NIFS.prove(r, big_w_out, big_u_out, self.scheme, prover_transcript)
            return big_w_out, big_u_out, ZkIVCProof(ivc_proof.u_i, ivc_proof.big_u_i, com_t, nifs_proof)
        return ivc_proof.big_w_i, ivc_proof.big_u_i, ZkIVCProof(ivc_proof.u_i, ivc_proof.big_u_i, None, None)

    def verify(self, zk_ivc_proof: ZkIVCProof, verifier_transcript: NovaTranscript) -> None:
        """Raises NovaError unless the step's hash, u_i and folding proof hold."""
        i = self.augmented_circuit.i
        z_0 = self.augmented_circuit.z_0
        z_i = self.augmented_circuit.z_i
        if i == 0:
            if z_0.state != z_i.state:
                raise NovaError("Verify failed: wrong state")
            return

        u_i = zk_ivc_proof.u_i
        big_u_i = zk_ivc_proof.big_u_i
        if zk_ivc_proof.com_t is None:
            raise NovaError("Verify failed: commitment of cross term T must exist")
        if zk_ivc_proof.folded_u_proof is None:
            raise NovaError("Verify failed: folding proof must exist")
        com_t = zk_ivc_proof.com_t
        folded_u_proof = zk_ivc_proof.folded_u_proof

        h = hash_io(i, z_0, z_i, big_u_i)
        if u_i.x[0] != base_to_scalar(h):
            raise NovaError("Verify failed: Public IO is wrong")
        if u_i.com_e != self.augmented_circuit.trivial_instance.com_e:
            raise NovaError("Verify failed: Commitment of E is wrong")
        if u_i.u != 1:
            raise NovaError("Verify failed: Scalar u is wrong")

        big_u_out = NIFS.verifier(folded_u_proof.r, u_i, big_u_i, com_t)
        NIFS.verify(folded_u_proof, u_i, big_u_i, big_u_out, com_t, self.scheme, verifier_transcript)
