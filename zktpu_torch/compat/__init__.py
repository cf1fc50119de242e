"""Checkpoints of the SRS, the PLONK and FRI proofs and the Nova IVC state
(counterpart of zktpu/compat/): the same files as zktpu's, so that either
package loads what the other wrote."""
from .checkpoint import (
    load_fri_proof,
    load_ivc_state,
    load_plonk_proof,
    load_srs,
    save_fri_proof,
    save_ivc_state,
    save_plonk_proof,
    save_srs,
)
