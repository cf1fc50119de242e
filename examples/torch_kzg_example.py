"""KZG end-to-end example on zktpu_torch (the counterpart of kzg_example.py,
which mirrors kzg/examples/example.rs:7-26).

Commit to x^3 + 3x + 5, open at z = 4, verify: the commitments by the port's
MSM on the current CUDA device (or the CPU with --device cpu), the pairing
check on the host.

    python examples/torch_kzg_example.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zktpu_torch.fields.host import FR  # noqa: E402
from zktpu_torch.kzg import KzgScheme, Srs  # noqa: E402
from zktpu_torch.poly.poly import Poly  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    srs = Srs.new(10, device=args.device)
    scheme = KzgScheme(srs)

    poly = Poly.from_ints(FR, [5, 3, 0, 1], device=args.device)  # 5 + 3x + x^3
    assert poly.evaluate(1) == 9

    commitment = scheme.commit(poly)
    opening = scheme.open(poly, 4)
    assert scheme.verify(commitment, opening, 4)
    print("KZG commit/open/verify: accepted")


if __name__ == "__main__":
    main()
