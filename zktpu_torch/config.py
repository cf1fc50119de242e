"""Size tiers: host scalar path below a threshold, tensor path above it.

Same thresholds as zktpu/config.py.  Small objects (a 16-point commit, a
64-point NTT) cost more in dispatch than in arithmetic, so they run on host
Python ints with identical results.  Modules read these constants at call
time, so tests may set them (0 forces the tensor paths everywhere).
"""

# KZG commit: host double-and-add at or below, tensor Pippenger above.
HOST_MSM_MAX = 64
# SRS sizes small enough to decode to host affine points for the host MSM.
HOST_MSM_SRS_MAX = 4096
# NTT/iNTT: host radix-2 at or below, tensor butterflies above.
HOST_NTT_MAX = 128
# Dense poly ops (mul / linear and vanishing division): host at or below.
HOST_POLY_MAX = 128

# PLONK quotient: circuits up to this size divide the permutation part on the
# exact 8n coset; above it, the evaluation-form 4n path (same proof for an
# honest witness; see plonk/prover.py::_quotient_coset).
QUOTIENT_8N_MAX_N = 1 << 19
