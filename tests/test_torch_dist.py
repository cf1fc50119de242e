"""The port's dist layer (zktpu_torch/dist/) on 4 gloo ranks of the CPU
against zktpu.dist on its 8-device CPU mesh, through committed goldens
(tests/goldens/dist.json and dist.npz, written by
tests/goldens/make_goldens.py dist) at the sizes of tests/test_dist.py: the
four-step fft and ifft, the sharded MSM, the sharded FRI layer and the wire
commitments, each on every rank; on a world of 2, the blinded wire
commitments, zktpu's divisibility error and a cached plan that follows
the world its rank joins; fixed_base_mul over ints.  The two worlds are
spawned once for the module, at the same time (each rank's plain MSMs take
seconds on the CPU), and the tests read their results.
"""
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs one process per core: intra-op threads would oversubscribe it

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")

GOLDEN_DEVICES = 8  # zktpu's CPU mesh (tests/conftest.py)
WORLD = 4
NTT_SIZES = (64, 256, 4096)
MSM_N, MSM_C = 64, 4
FRI_LOG_DOMAIN = 12
# tests/test_dist.py commits the wires at n = 2^8; here 2^7, since on the
# CPU each rank's plain MSM of 3 x 64 points alone takes about 20 s
WIRE_N, WIRE_C = 1 << 7, 4
BLIND_N, BLIND_SECRET = 1 << 6, 123456789


def fr_values(n: int) -> list[int]:
    """n Fr elements from default_rng(100 + n)."""
    from zktpu_torch.fields.host import FR

    words = np.random.default_rng(100 + n).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR.modulus for row in words]


def point_scalars(n: int) -> list[int]:
    """The points of tests/test_dist.py: [k] G for k = 2 .. n + 1."""
    return list(range(2, n + 2))


def msm_scalars() -> list[int]:
    """tests/test_dist.py's MSM scalars."""
    rng = np.random.default_rng(7)
    return [int(rng.integers(0, 1 << 62)) * 3 + i for i in range(MSM_N)]


def fri_coeffs() -> list[int]:
    """tests/test_dist.py's FRI polynomial: 2^11 Goldilocks coefficients."""
    from zktpu_torch.fields.host import GOLDILOCKS

    rng = np.random.default_rng(11)
    deg = 1 << (FRI_LOG_DOMAIN - 1)
    return [int(v) for v in rng.integers(0, GOLDILOCKS.modulus, size=deg, dtype=np.uint64)]


def wire_evals() -> list[list[int]]:
    """tests/test_dist.py's three wire evaluation columns at n = WIRE_N."""
    rng = np.random.default_rng(23)
    return [[int(v) for v in rng.integers(0, 1 << 62, size=WIRE_N)] for _ in range(3)]


def blinded_inputs() -> tuple[list[list[int]], list[tuple[int, int]]]:
    """tests/test_dist.py's blinded case at n = BLIND_N: the wire columns and (b_hi, b_lo) pairs."""
    rng = np.random.default_rng(31)
    evals = [[int(v) for v in rng.integers(0, 1 << 62, size=BLIND_N)] for _ in range(3)]
    blinds = [(int(rng.integers(1, 1 << 61)), int(rng.integers(1, 1 << 61))) for _ in range(3)]
    return evals, blinds


# -- the ranks' work (module-level: spawn pickles it by name) --


def _affine(points) -> list:
    from zktpu_torch.curves import g1

    planes = tuple(torch.stack([p[k] for p in points]) for k in range(3))
    return [[p.x, p.y, p.infinity] for p in g1.proj_to_affine_host(planes)]


def _rank_job(mesh, points) -> dict:
    """Every function of zktpu_torch.dist at the golden sizes, on this rank.
    points: zktpu's [k] G planes (the fixed-base multiply is tested in the
    parent process)."""
    torch.set_num_threads(1)
    from zktpu_torch.curves import g1
    from zktpu_torch.dist import (ShardedWireCommitter, dist_fri_layer, get_four_step, msm_jacobian_sharded,
                                  shard_leading)
    from zktpu_torch.fields.fp import field, limbs_to_ints
    from zktpu_torch.fields.host import FR, GOLDILOCKS
    from zktpu_torch.kzg import Srs
    from zktpu_torch.poly.poly import Poly

    frt = field(FR, mesh.device)
    out = {"ntt": {}}
    for n in NTT_SIZES:
        fs = get_four_step(FR, n, mesh)
        x = shard_leading(mesh, frt.encode_ints(fr_values(n)))
        out["ntt"][n] = (fs.fft(x), fs.ifft(x))

    def rows(n):  # this rank's rows of [k] G, k = 2 .. n + 1
        return tuple(shard_leading(mesh, torch.from_numpy(a[:n])) for a in points)

    sc = shard_leading(mesh, g1.scalars_to_u32(msm_scalars(), device=mesh.device))
    out["msm"] = _affine([msm_jacobian_sharded(sc, *rows(MSM_N), mesh=mesh, c=MSM_C)])[0]

    layer = dist_fri_layer(Poly.from_ints(GOLDILOCKS, fri_coeffs(), device=mesh.device), GOLDILOCKS.generator,
                           1 << FRI_LOG_DOMAIN, mesh)
    proofs = layer.merkle_tree.generate_proofs([0, 5, (1 << FRI_LOG_DOMAIN) - 1])
    out["fri"] = {"evaluations": limbs_to_ints(layer.evaluations.numpy()), "levels": layer.merkle_tree.internal_nodes,
                  "root": layer.merkle_tree.root(),
                  "proofs": [(p.index, p.leaf_val, p.hash_proof, p.root) for p in proofs]}

    evals3 = torch.stack([shard_leading(mesh, frt.encode_ints(v)) for v in wire_evals()])
    out["wires"] = _affine(ShardedWireCommitter(FR, WIRE_N, mesh, c=WIRE_C)(evals3, *rows(WIRE_N)))

    return out


def _world2_job(mesh, port) -> dict:
    """On a world of 2: zktpu's divisibility error at n = 2 (R = 1), the
    blinded wire commitments, and a local_mesh (this rank alone) running
    the four-step NTT of the whole input; then the worlds this rank joins
    in turn (_switch_worlds)."""
    torch.set_num_threads(1)
    from zktpu_torch.dist import FourStepNTT, ShardedWireCommitter, local_mesh, shard_leading
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FR
    from zktpu_torch.kzg import Srs

    with pytest.raises(ValueError) as e:
        FourStepNTT(FR, 2, mesh)
    frt = field(FR, mesh.device)
    alone = local_mesh(mesh.device)
    assert (alone.size, alone.rank) == (1, 0)
    fft64 = FourStepNTT(FR, NTT_SIZES[0], alone).fft(frt.encode_ints(fr_values(NTT_SIZES[0])))
    evals, blinds = blinded_inputs()
    committer = ShardedWireCommitter(FR, BLIND_N, mesh, c=MSM_C)
    srs = Srs.new_from_secret(BLIND_SECRET, BLIND_N, device=mesh.device)
    got = committer.commit_blinded(torch.stack([shard_leading(mesh, frt.encode_ints(v)) for v in evals]), srs, blinds)
    return {"error": str(e.value), "blinded": [[p.x, p.y, p.infinity] for p in got], "fft64": fft64,
            "switched": _switch_worlds(mesh, port)}


def _switch_worlds(mesh, port) -> list:
    """The whole four-step fft at n = 64 through get_four_step's cached plan
    on this world of 2, then on a world of this rank alone, then on a new
    world of 2 at `port`: each world's mesh must key its own plan."""
    import torch.distributed as dist

    from zktpu_torch.dist import get_four_step, init, shard_leading
    from zktpu_torch.dist.mesh import free_port
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import FR

    n, rank = NTT_SIZES[0], mesh.rank
    x = field(FR, mesh.device).encode_ints(fr_values(n))
    out = []
    for world in (2, 1, 2):
        if world != mesh.size or out:
            dist.destroy_process_group()
            mesh = init(rank, 2, port, device="cpu") if world == 2 else init(0, 1, free_port(), device="cpu")
        out.append(mesh.all_gather(get_four_step(FR, n, mesh).fft(shard_leading(mesh, x))))
    return out


# -- the tests --


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(HERE, "dist.json")) as f:
        js = json.load(f)
    with np.load(os.path.join(HERE, "dist.npz")) as z:
        return js, {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def worlds(golden):
    """The results of the world of 4 and of the world of 2, run at once."""
    from zktpu_torch.dist import spawn
    from zktpu_torch.dist.mesh import free_port

    points = tuple(golden[1][f"points/{k}"] for k in "XYZ")
    with ThreadPoolExecutor(1) as pool:
        two = pool.submit(spawn, _world2_job, 2, free_port(), device="cpu")
        four = spawn(_rank_job, WORLD, points, device="cpu")
        return four, two.result()


@pytest.fixture(scope="module")
def ranks(worlds):
    return worlds[0]


def test_four_step_ntt_matches_zktpu(ranks, golden):
    """Each rank's n/4 rows of the fft and ifft, in rank order, are zktpu's
    four-step transforms word for word (which equal its single-chip ones)."""
    arrays = golden[1]
    for n in NTT_SIZES:
        for k, name in enumerate(("fft", "ifft")):
            got = torch.cat([r["ntt"][n][k] for r in ranks]).numpy()
            np.testing.assert_array_equal(got, arrays[f"ntt/{n}/{name}"])


def test_sharded_msm_matches_zktpu(ranks, golden):
    assert all(r["msm"] == golden[0]["msm"] for r in ranks)


def test_dist_fri_layer_matches_zktpu(ranks, golden):
    want = golden[0]["fri"]
    for r in ranks:
        got = r["fri"]
        assert got["evaluations"] == want["evaluations"]
        assert got["levels"] == want["levels"] and got["root"] == want["root"]
    n = 1 << FRI_LOG_DOMAIN
    paths = [(i, want["evaluations"][i]) for i in (0, 5, n - 1)]
    assert [(p[0], p[1]) for p in ranks[0]["fri"]["proofs"]] == paths
    assert all(p[3] == want["root"] for p in ranks[0]["fri"]["proofs"])


def test_sharded_wire_commits_match_zktpu(ranks, golden):
    assert all(r["wires"] == golden[0]["wires"] for r in ranks)


def test_blinded_wire_commits_and_divisibility_error_match_zktpu(worlds, golden):
    """On the world of 2: commit_blinded gives zktpu's blinded commitments,
    n = 2 (R = 1) zktpu's error word for word (zktpu's own FourStepNTT on a
    mesh of 2 of its CPU devices), and local_mesh's four-step fft zktpu's."""
    from zktpu.dist import FourStepNTT as ZFourStep, make_mesh as z_make_mesh
    from zktpu.fields import host as zhost

    with pytest.raises(ValueError) as e:
        ZFourStep(zhost.FR, 2, z_make_mesh(2))
    assert [r["error"] for r in worlds[1]] == [str(e.value)] * 2
    assert all(r["blinded"] == golden[0]["blinded"] for r in worlds[1])
    for r in worlds[1]:  # local_mesh: each rank's own world of one
        np.testing.assert_array_equal(r["fft64"].numpy(), golden[1][f"ntt/{NTT_SIZES[0]}/fft"])


def test_four_step_plan_follows_the_world(worlds, golden):
    """A rank that leaves a world of 2 for a world of its own and then joins
    a new world of 2 gets, through get_four_step's cache, each world's plan:
    the fft is zktpu's in all three."""
    want = golden[1][f"ntt/{NTT_SIZES[0]}/fft"]
    for r in worlds[1]:
        assert len(r["switched"]) == 3
        for got in r["switched"]:
            np.testing.assert_array_equal(got.numpy(), want)


def test_fixed_base_mul_matches_zktpu_and_host(golden):
    """fixed_base_mul over ints (the plain loop on the CPU): zktpu's words for
    [k] G, k = 2 .. 65, and host scalar multiplication."""
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.host_curve import G1Affine

    G = G1Affine.generator()
    ks = point_scalars(MSM_N)
    got = g1.fixed_base_mul(G, ks, device="cpu")
    for k, plane in zip("XYZ", got):
        np.testing.assert_array_equal(plane.numpy(), golden[1][f"points/{k}"][:MSM_N])
    assert g1.proj_to_affine_host(tuple(a[:4] for a in got)) == [G.mul(k) for k in ks[:4]]
