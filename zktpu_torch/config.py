"""Size tiers: host scalar path below a threshold, tensor path above it.

Same thresholds and the same environment overrides as zktpu/config.py
(ZKTPU_HOST_MSM_MAX, ZKTPU_HOST_MSM_SRS_MAX, ZKTPU_HOST_NTT_MAX,
ZKTPU_HOST_POLY_MAX, ZKTPU_QUOTIENT_8N_MAX_N), read once at import, so that
both packages pick the same tier for a given environment.  Small objects (a
16-point commit, a 64-point NTT) cost more in dispatch than in arithmetic,
so they run on host Python ints with identical results.  Modules read these
constants at call time, so tests may set them (0 forces the tensor paths
everywhere).
"""
from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


# KZG commit: host double-and-add at or below, tensor Pippenger above.
HOST_MSM_MAX = _env_int("ZKTPU_HOST_MSM_MAX", 64)
# SRS sizes small enough to decode to host affine points for the host MSM.
HOST_MSM_SRS_MAX = _env_int("ZKTPU_HOST_MSM_SRS_MAX", 4096)
# NTT/iNTT: host radix-2 at or below, tensor butterflies above.
HOST_NTT_MAX = _env_int("ZKTPU_HOST_NTT_MAX", 128)
# Dense poly ops (mul / linear and vanishing division): host at or below.
HOST_POLY_MAX = _env_int("ZKTPU_HOST_POLY_MAX", 128)

# PLONK quotient: circuits up to this size divide the permutation part on the
# exact 8n coset; above it, the evaluation-form 4n path (same proof for an
# honest witness; see plonk/prover.py::_quotient_coset).
QUOTIENT_8N_MAX_N = _env_int("ZKTPU_QUOTIENT_8N_MAX_N", 1 << 19)
