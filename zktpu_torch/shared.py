"""The host layer that zktpu_torch shares with zktpu, and the port's only
import of zktpu.

These zktpu modules are pure Python (the pairing also has a native C++
library) and import no JAX: the field constants (fields/host.py), host curve
arithmetic (curves/host_curve.py), the pairing (curves/pairing.py,
curves/native_pairing.py), the Fiat-Shamir transcript and blinding sampler
(transcript/chacha.py, ark_rand.py, transcripts.py) and the PLONK gate
(plonk/gate.py).  zktpu/__init__.py guards its own ``import jax``, so they
load on a machine without JAX.  Every other zktpu module imports JAX and is
off limits to the port.
"""
from zktpu.curves import native_pairing
from zktpu.curves.host_curve import G1Affine, G2Affine
from zktpu.curves.pairing import Fq12, pairing_product
from zktpu.fields.host import FQ, FR, GOLDILOCKS, FieldSpec
from zktpu.plonk.gate import Gate
from zktpu.transcript.ark_rand import fp_rand
from zktpu.transcript.chacha import StdRng
from zktpu.transcript.transcripts import PlonkChallengeGenerator

__all__ = [
    "FQ", "FR", "GOLDILOCKS", "FieldSpec", "Fq12", "G1Affine", "G2Affine", "Gate",
    "PlonkChallengeGenerator", "StdRng", "fp_rand", "pairing_backend", "pairing_product",
]


def pairing_backend() -> str:
    """'native' when the C++ pairing library loads, else 'python' (the
    pairing's own silent fallback, kept from zktpu)."""
    return "native" if native_pairing._load() is not None else "python"
