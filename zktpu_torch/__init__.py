"""zktpu_torch — the zktpu proof stack on PyTorch and hand-written CUDA kernels.

A port of the KZG -> PLONK prove -> PLONK verify path of :mod:`zktpu` (the
JAX/Pallas reference package beside it) to PyTorch on an NVIDIA Hopper GPU.
Bulk field and curve arithmetic runs on tensors; the three hot kernels (the
batched Montgomery product and the complete projective G1 add and double) are
CUDA C++ in ``zktpu_torch/csrc/``, built on first use.  Every kernel has a
plain PyTorch twin in the same module, which runs for tensors on the CPU.

The pure-Python host layer (field constants, host curve arithmetic, pairing,
transcripts, gates) is shared with ``zktpu`` rather than copied: those modules
import no JAX.  This package itself never imports JAX.

Representation: a field element is ``(..., L)`` little-endian 32-bit limbs in
a ``torch.int32`` tensor (u32 bit patterns), Montgomery form with the same
radix R as ``zktpu`` (R = 2^(32 L); L = 12 for Fq, 8 for Fr, 2 for
Goldilocks), always canonical (< p).
"""

__version__ = "0.1.0"
