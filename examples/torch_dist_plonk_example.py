"""Distributed PLONK round 1 on zktpu_torch: sharded wire commitments over a
world of ranks (the counterpart of dist_plonk_example.py).

Starts --world ranks, one process each (default: one per CUDA device, over
NCCL; --backend gloo lets several ranks share a card; --device cpu runs
gloo ranks on the CPU), runs ShardedWireCommitter at n = 2^8 (the
four-step inverse NTT, three all_to_alls, then each rank's Pippenger MSM
and an all_gather of the partials) and checks the three wire commitments of
every rank against interpolating and committing each wire on one device.

    python examples/torch_dist_plonk_example.py [--world P] [--backend nccl|gloo] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from zktpu_torch.curves import g1  # noqa: E402
from zktpu_torch.curves.host_curve import G1Affine  # noqa: E402
from zktpu_torch.curves.msm import msm_proj_many  # noqa: E402
from zktpu_torch.dist import ShardedWireCommitter, shard_leading, spawn  # noqa: E402
from zktpu_torch.fields.fp import field, norm_device  # noqa: E402
from zktpu_torch.fields.host import FR  # noqa: E402
from zktpu_torch.poly.domain import get_domain  # noqa: E402

N, C, SEED = 1 << 8, 4, 42


def _wires() -> list[list[int]]:
    rng = np.random.default_rng(SEED)
    return [[int(v) for v in rng.integers(0, 1 << 62, size=N)] for _ in range(3)]


def _points(device):
    return g1.fixed_base_mul(G1Affine.generator(), list(range(2, N + 2)), device=device)


def _rank(mesh):
    """One rank: its rows of the wires and of the points, the three commitments (host points)."""
    frd = field(FR, mesh.device)
    evals3 = torch.stack([shard_leading(mesh, frd.encode_ints(v)) for v in _wires()])
    rows = N // mesh.size
    X, Y, Z = (a[mesh.rank * rows:(mesh.rank + 1) * rows] for a in _points(mesh.device))
    got = ShardedWireCommitter(FR, N, mesh, c=C)(evals3, X, Y, Z)
    return g1.proj_to_affine_host(tuple(torch.stack([p[k] for p in got]) for k in range(3)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: torch.cuda.device_count(), or 4 with --device cpu)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cards, gloo on the CPU")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    device = norm_device(args.device)
    world = args.world or (4 if device.type == "cpu" else torch.cuda.device_count())
    rank_device = "cpu" if device.type == "cpu" else None
    results = spawn(_rank, world, backend=args.backend, device=rank_device)
    backend = args.backend or ("gloo" if device.type == "cpu" else "nccl")

    frd = field(FR, device)
    dom = get_domain(FR, N, device)
    X, Y, Z = _points(device)
    sc = torch.stack([frd.to_u32_limbs(dom.ifft(frd.encode_ints(v), force_device=True)) for v in _wires()])
    want = g1.proj_to_affine_host(msm_proj_many(sc, X, Y, Z, c=C))
    for rank, got in enumerate(results):
        for i in range(3):
            assert got[i] == want[i], f"rank {rank}: wire {i} commitment mismatch"
    print(f"sharded wire commitments on a {world}-rank mesh ({backend}): all 3 match single-device, on every rank")


if __name__ == "__main__":
    main()
