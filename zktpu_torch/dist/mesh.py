"""A 1-D device mesh over torch.distributed (counterpart of zktpu/dist/mesh.py).

zktpu's mesh is a jax.sharding.Mesh over the chips of one program.  Here a
rank is a process with one device, and a mesh is a process group with this
rank's device: ``shard_leading`` cuts a whole tensor to this rank's rows,
``replicated`` keeps all of it.  ``init`` joins a world of ranks and
``spawn`` starts one; NCCL is the backend on cards (a card per rank), gloo on
the CPU.  Gloo with CUDA tensors (several ranks sharing one card, to check
the collectives without more cards) runs only where asked for, and there
each collective's buffers go through host memory, since gloo's all_gather
and all_to_all take CPU tensors only.
"""
from __future__ import annotations

import pickle
import socket
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..fields.fp import norm_device


# A rank's result waits at most this long in spawn.
SPAWN_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class Mesh:
    """The ranks of `group` (None: the whole world), its size, this rank in
    it and this rank's device.  Size and rank are fields, read when the mesh
    is made, so that a mesh of one world never equals one of another world
    this process joins later: plans cached on a mesh depend on both."""

    group: object
    size: int
    rank: int
    device: torch.device

    @classmethod
    def of(cls, group, device: torch.device) -> "Mesh":
        return cls(group, dist.get_world_size(group), dist.get_rank(group), device)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend == "gloo"

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t (one shape on all) concatenated along dim 0, in rank order."""
        staged = self._staged(t)
        src = t.contiguous().cpu() if staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts)
        return out.to(t.device) if staged else out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t: (P, ...), chunk q for rank q -> (P, ...) whose chunk s came from rank s."""
        assert t.shape[0] == self.size, (tuple(t.shape), self.size)
        staged = self._staged(t)
        src = t.contiguous().cpu() if staged else t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(t.device) if staged else out


def _rank_device(rank: int, device) -> torch.device:
    """This rank's device: `device`, or CUDA device rank mod the cards (the default, raising without one)."""
    if device is None:
        norm_device(None)  # raises without a CUDA device
        return torch.device("cuda", rank % torch.cuda.device_count())
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", rank % torch.cuda.device_count())
    return d


def init(rank: int, world_size: int, port: int, backend: str | None = None, device=None) -> Mesh:
    """Join the world of `world_size` ranks at tcp://localhost:`port` as
    `rank`; returns its mesh.  device: this rank's device (default: CUDA
    device rank mod the cards); backend: "nccl" for a CUDA device and "gloo"
    for the CPU by default."""
    dev = _rank_device(rank, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"NCCL needs a card per rank: a world of {world_size} on {torch.cuda.device_count()} "
                         f"card(s); pass backend='gloo' to share them")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world_size, rank=rank)
    return Mesh.of(None, dev)


def free_port() -> int:
    """A free TCP port on localhost for a world's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of the whole world this process joined (``init`` or
    init_process_group); device: this rank's (default: the current CUDA device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; join a world with zktpu_torch.dist.init first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, have {world} (a mesh spans the whole world)")
    return Mesh.of(None, norm_device(device))


def local_mesh(device=None) -> Mesh:
    """A mesh of this process alone: a world of one if none was joined,
    otherwise this rank's own group (every rank must call it then, as
    torch.distributed makes groups collectively)."""
    if not dist.is_initialized():
        return init(0, 1, free_port(), device=norm_device(device))
    if dist.get_world_size() == 1:
        return make_mesh(device=device)
    group, _ = dist.new_subgroups(group_size=1)
    return Mesh.of(group, norm_device(device))


def shard_leading(mesh: Mesh, arr: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole tensor whose leading axis the mesh divides, on its device."""
    n = arr.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_leading: {n} rows over {mesh.size} ranks")
    rows = n // mesh.size
    return arr[mesh.rank * rows:(mesh.rank + 1) * rows].to(mesh.device)


def replicated(mesh: Mesh, arr: torch.Tensor) -> torch.Tensor:
    """The whole tensor on this rank's device."""
    return arr.to(mesh.device)


def _rank_main(fn, rank, world, port, backend, device, args, results) -> None:
    try:
        mesh = init(rank, world, port, backend, device)
        # pickled here, by value: a tensor put on the queue as it is would be
        # shared through a file descriptor of this process, which ends first
        results.put((rank, True, pickle.dumps(fn(mesh, *args))))
    except Exception:  # the rank's boundary: report the traceback to spawn
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str | None = None, device=None) -> list:
    """Run fn(mesh, *args) on a new world of `world` ranks, one process each,
    and return their results in rank order.  fn is a module-level function
    (it is pickled by name) whose result is picklable: return CPU tensors,
    ints or lists.  device and backend as in ``init`` (device "cuda" with
    backend "gloo": every rank on the card it maps to).  Raises with the
    first failing rank's traceback."""
    import multiprocessing as mp

    _rank_device(0, device)  # the default device raises here, without a card, before any rank starts
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, backend, device, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(world):  # drain before joining
            rank, ok, value = results.get(timeout=SPAWN_TIMEOUT_S)
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = pickle.loads(value)  # written by _rank_main above
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world else 1)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(world)]
