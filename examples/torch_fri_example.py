"""FRI end-to-end example on zktpu_torch (the counterpart of fri_example.py,
which mirrors fri/examples/example.rs:9-29).

Degree-5 Goldilocks polynomial, blowup 2, 2 queries: the coset-NTT layer
evaluations and SHA-256 Merkle commitments on the current CUDA device (or
the CPU with --device cpu), the transcript-replayed verify on the host.

    python examples/torch_fri_example.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zktpu_torch.fields.host import GOLDILOCKS  # noqa: E402
from zktpu_torch.fri.prover import generate_proof  # noqa: E402
from zktpu_torch.fri.verifier import verify  # noqa: E402
from zktpu_torch.poly.poly import Poly  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    poly = Poly.from_ints(GOLDILOCKS, [1, 2, 3, 4, 5, 6], device=args.device)
    print("Generate proof...")
    proof = generate_proof(poly, blowup_factor=2, number_of_queries=2)
    print("Verify....")
    verify(proof)  # raises on rejection
    print("Accepted!")


if __name__ == "__main__":
    main()
