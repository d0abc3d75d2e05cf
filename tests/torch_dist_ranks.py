"""What each rank runs for ``tests/test_torch_dist.py`` and
``tests/test_torch_gpu_dist.py`` (started by
``gpann_tpu_torch.dist.launch.run_ranks``). It imports no JAX: the ranks are
processes of their own, and the tests hold their results against the JAX
package in the parent process."""

import numpy as np
import torch
import torch.distributed as dist

from gpann_tpu_torch.dist import (DistributedIVF, DistributedServingEngine,
                                  shard_mesh, sharded_lloyd_round)

RULES = ("min_dist", "pyramid", "spann", "frequency")


def probes(m: int, s: int, p: int) -> np.ndarray:
    """Every query probes shards 0 .. p-1 of s."""
    return np.tile(np.arange(s, dtype=np.int32), (m, 1))[:, :p]


def scenarios(inp: dict) -> dict:
    """The scenarios of ``tests/test_dist.py`` and
    ``tests/test_multiprocess.py``, one after another in this rank, on the
    CPU; returns this rank's (whole) results."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh1, mesh2 = shard_mesh(dp=1), shard_mesh(dp=2)
    pts, q, clusters = inp["pts"], inp["q"], inp["clusters"]
    cpu = dict(device="cpu")
    out = {"mesh1": mesh1.shape, "mesh2": mesh2.shape}
    out["dp1"] = DistributedIVF(pts, clusters, mesh=mesh1, **cpu
                                ).search_probed(q, probes(len(q), 8, 3), 10)
    ivf2 = DistributedIVF(pts, clusters, mesh=mesh2, **cpu)
    out["dp2"] = ivf2.search_probed(q, probes(len(q), 8, 8), 10)
    out["full"] = DistributedIVF(pts, clusters, **cpu).search_probed(
        q, probes(len(q), 8, 8), 10)
    out["five"] = DistributedIVF(pts, inp["clusters5"], mesh=mesh1, **cpu
                                 ).search_probed(q, probes(len(q), 5, 5), 10)
    out["uneven"] = ivf2.search_probed(q[:13], probes(13, 8, 8), 10)

    dse = DistributedServingEngine(pts, clusters, inp["rp"], inp["rl"],
                                   mesh=mesh2, **cpu)
    for rule in RULES:
        out[f"serve_{rule}"] = dse.serve(q, k=10, nprobes=3, voting_t=8,
                                         rule=rule, microbatch=16)
    out["mb_pad"] = dse.serve(q[:50], k=10, nprobes=8, voting_t=8,
                              microbatch=16)

    step = sharded_lloyd_round(mesh2, k=8, **cpu)
    rows = np.array_split(np.arange(len(pts)), world)[rank]
    out["lloyd"] = [tuple(t.numpy() for t in step(pts[rows], inp["cents"]))
                    for _ in range(2)]

    # MIPS (1 - q.x): probed search, fused serve, a Lloyd round
    out["mips_ivf"] = DistributedIVF(pts, clusters, mesh=mesh2, metric="mips",
                                     **cpu).search_probed(
        q, probes(len(q), 8, 3), 10)
    out["mips_serve"] = DistributedServingEngine(
        pts, clusters, inp["rp"], inp["rl"], mesh=mesh2, metric="mips", **cpu
    ).serve(q, k=10, nprobes=3, voting_t=8, microbatch=16)
    step = sharded_lloyd_round(mesh2, k=8, metric="mips", **cpu)
    out["mips_lloyd"] = [tuple(t.numpy() for t in step(pts[rows], inp["cents"]))
                         for _ in range(2)]

    mp = inp["mp"]
    out["mp_ivf"] = DistributedIVF(mp["pts"], mp["clusters"], mesh=mesh1, **cpu
                                   ).search_probed(mp["q"], probes(32, 8, 3), 10)
    out["mp_serve"] = DistributedServingEngine(
        mp["pts"], mp["clusters"], mp["rp"], mp["rl"], mesh=mesh1, **cpu
    ).serve(mp["q"], 10, nprobes=3, voting_t=20, microbatch=16)

    st = inp["state"]
    from_state = DistributedServingEngine.from_state(st["arrays"],
                                                     st["config"], mesh2, **cpu)
    out["state_ivf"] = from_state.search_probed(q, probes(len(q), 8, 3), 10)
    out["state_serve"] = from_state.serve(q, k=10, nprobes=3, voting_t=8,
                                          microbatch=16)

    try:
        DistributedIVF(pts, clusters, mesh=mesh1, backend="nccl", **cpu)
    except ValueError as e:
        out["nccl_on_cpu"] = str(e)

    ragged = DistributedIVF(pts, inp["ragged"], mesh=mesh1, **cpu)
    out["ragged"] = ragged.search_probed(q, probes(len(q), 8, 8), 10)
    out["ragged_capacity"] = ragged.capacity
    return out


def on_card(inp: dict) -> dict:
    """``tests/test_torch_gpu_dist.py``'s run: the ranks share one card and
    exchange over gloo (host copies of the merged lists). Without a process
    group it is the one-rank layout in the calling process."""
    mesh = shard_mesh(dp=1)
    dev = torch.device("cuda", mesh.rank % torch.cuda.device_count())
    pts, q, clusters = inp["pts"], inp["q"], inp["clusters"]
    out = {"ivf": DistributedIVF(pts, clusters, mesh=mesh, device=dev
                                 ).search_probed(q, probes(len(q), 8, 8), 10)}
    for impl in ("exact", "binned"):
        dse = DistributedServingEngine(pts, clusters, inp["rp"], inp["rl"],
                                       mesh=mesh, voting_impl=impl, device=dev)
        out[impl] = dse.serve(q, k=10, nprobes=3, voting_t=8, microbatch=16)
    step = sharded_lloyd_round(mesh, k=8, device=dev)
    rows = np.array_split(np.arange(len(pts)), mesh.world)[mesh.rank]
    out["lloyd"] = [tuple(t.cpu().numpy()
                          for t in step(pts[rows], inp["cents"]))
                    for _ in range(2)]
    return out


def fail_on_rank(bad: int) -> int:
    """Raise on rank ``bad``; the others wait in a collective."""
    if dist.get_rank() == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def sleep(seconds: float) -> None:
    import time

    time.sleep(seconds)
