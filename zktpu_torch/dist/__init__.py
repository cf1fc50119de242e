"""Distributed execution over torch.distributed (counterpart of zktpu/dist/):
a 1-D mesh of ranks, the sharded MSM, the four-step NTT, the sharded FRI
layer and Merkle tree, and the sharded round-1 wire commitments.

Each rank is one process with one device; every function takes and returns
this rank's shard, as the local functions of zktpu's shard_map do, and the
cross-rank traffic is all_gather and all_to_all_single.  The local work runs
the tensor paths (the kernels on a card) at any size, never the host tiers.
zktpu's axis_name arguments are gone (the mesh has one axis), and so is its
RNS coordinate backend (fq=), which the port does not have.
"""
from .mesh import Mesh, init, local_mesh, make_mesh, replicated, shard_leading, spawn
from .msm import msm_jacobian_sharded, msm_sharded_many
from .ntt import FourStepNTT, get_four_step
from .fri import dist_coset_evals, dist_fri_layer, dist_merkle_tree
from .plonk import ShardedWireCommitter, get_wire_committer
