"""zktpu_torch — the zktpu proof stack on PyTorch and hand-written CUDA kernels.

A port of the KZG -> PLONK prove -> PLONK verify path of :mod:`zktpu` (the
JAX/Pallas reference package beside it) to PyTorch on an NVIDIA Hopper GPU,
with the affine-point MSM, a chained-multiply microbench, and the FRI prover
and verifier over Goldilocks.  Bulk field and curve arithmetic runs on
tensors; the hot kernels (the batched and the chained Montgomery product,
the complete projective G1 add and double, the mixed add, the NTT over Fr
and Goldilocks, the Horner combine, the field scans and add/sub, and the
Merkle trees' field hash) are CUDA C++ in ``zktpu_torch/csrc/``, built on
first use.
Every kernel has a plain PyTorch twin in the same module, which runs for
tensors on the CPU.  Entry points run on the current CUDA device unless the
caller passes ``device="cpu"``.

The pure-Python host layer (field constants, host curve arithmetic, pairing
and its C++ library, transcripts, gates, the field hash) is the port's own
copy of ``zktpu``'s (``fields/host.py``, ``curves/host_curve.py``,
``curves/pairing.py``, ``curves/native_pairing.py``, ``transcript/``,
``plonk/gate.py``, ``hash/host_hash.py``).  This package
imports neither JAX nor ``zktpu``.

Representation: a field element is ``(..., L)`` little-endian 32-bit limbs in
a ``torch.int32`` tensor (u32 bit patterns), Montgomery form with the same
radix R as ``zktpu`` (R = 2^(32 L); L = 12 for Fq, 8 for Fr, 2 for
Goldilocks), always canonical (< p).
"""

__version__ = "0.1.0"
