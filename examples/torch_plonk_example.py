"""PLONK end-to-end example on zktpu_torch (the counterpart of
plonk_example.py, which mirrors plonk/examples/example.rs:9-65).

Hand-built 7-gate circuit for xy + 3x^2 + xyz = 11 with witness
(x, y, z) = (1, 2, 3); proves and verifies on the current CUDA device (or
the CPU with --device cpu).

    python examples/torch_plonk_example.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zktpu_torch.kzg import Srs  # noqa: E402
from zktpu_torch.plonk.circuit import Circuit  # noqa: E402
from zktpu_torch.plonk.prover import generate_proof  # noqa: E402
from zktpu_torch.plonk.verifier import verify  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    circuit = Circuit()
    circuit.add_multiplication_gate((0, 1, 1), (1, 0, 2), (0, 3, 2), 0)
    circuit.add_multiplication_gate((1, 1, 1), (0, 0, 1), (0, 2, 1), 0)
    circuit.add_multiplication_gate((2, 1, 1), (2, 6, 3), (1, 3, 3), 0)
    circuit.add_addition_gate((0, 4, 2), (2, 2, 3), (0, 5, 5), 0)
    circuit.add_multiplication_gate((2, 0, 2), (1, 4, 3), (1, 5, 6), 0)
    circuit.add_addition_gate((2, 3, 5), (2, 4, 6), (2, 5, 11), 0)
    circuit.add_constant_gate((0, 6, 3), (1, 6, 0), (1, 2, 3), 0)

    compiled = circuit.compile(device=args.device)
    srs = Srs.new(compiled.size, device=args.device)
    proof = generate_proof(compiled, srs)
    verify(compiled, srs, proof)  # raises on rejection
    print("PLONK prove/verify: accepted")


if __name__ == "__main__":
    main()
