"""Entry points of the port: one probed scan on one device, and a multi-rank
dry run (counterpart of the root ``__graft_entry__.py``).

- :func:`entry` returns ``(fn, example_args)``: ``fn`` is the probed dense
  IVF scan (:func:`~gpann_tpu_torch.search.ivf._scan_probed_dense`, k 10,
  L2), the args tensors on ``device`` for a tiny problem.
- :func:`dryrun_multichip` starts n local ranks and runs in each one step of
  the distributed query path (shard-parallel scan + top-k merge over the
  shard ranks, the batch split over dp), one routed serve and one sharded
  Lloyd round, on the same tiny problem.

Run ``python -m gpann_tpu_torch.entry`` to do both on the GPU (two ranks
sharing it over gloo); the tests call them with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _tiny_problem(seed=555, n=2048, d=32, nq=64, num_shards=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_shards, d)).astype(np.float32) * 3
    lbl = rng.integers(0, num_shards, size=n)
    pts = (centers[lbl] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, num_shards, size=nq)]
         + 0.3 * rng.standard_normal((nq, d))).astype(np.float32)
    return pts, q


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA GPU is available; pass "
                           "device='cpu' to run on the CPU")
    return device


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(*example_args)`` is one probed scan of 64
    queries over 8 shards of 2048 x 32 points (capacity 512, each query
    probing shards 0-2), returning device tensors (dists [64, 10], ids
    [64, 10])."""
    from gpann_tpu_torch.core.partition import pad_clusters, partition_to_clusters
    from gpann_tpu_torch.gp.partitioning import random_partition
    from gpann_tpu_torch.search.ivf import _scan_probed_dense

    device = _device(device)
    pts, q = _tiny_problem()
    # a random balanced partition: entry() exercises the scan, not the
    # partition's quality
    clusters = partition_to_clusters(random_partition(len(pts), 8), 8)
    padded, sizes = pad_clusters(clusters, pad_to=512)
    blocks = np.zeros((8, 512, pts.shape[1]), np.float32)
    for b, members in enumerate(clusters):
        blocks[b, : len(members)] = pts[members]
    probes = np.tile(np.arange(8, dtype=np.int32), (len(q), 1))[:, :3]

    def fn(queries, probes, blocks, sizes, ids):
        return _scan_probed_dense(queries, probes, blocks, sizes, ids, 10, "l2")

    example_args = tuple(torch.from_numpy(a).to(device)
                         for a in (q, probes, blocks, sizes, padded))
    return fn, example_args


def _dryrun_rank(device_type: str, backend: str) -> dict:
    """One rank of :func:`dryrun_multichip` (in a process of its own)."""
    import torch.distributed as dist

    from gpann_tpu_torch.cluster.kmeans import random_sample
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.dist import (DistributedIVF, DistributedServingEngine,
                                      shard_mesh, sharded_lloyd_round)
    from gpann_tpu_torch.gp.partitioning import random_partition

    world, rank = dist.get_world_size(), dist.get_rank()
    device = (torch.device("cuda", rank % torch.cuda.device_count())
              if device_type == "cuda" else torch.device("cpu"))
    dp = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = shard_mesh(dp=dp)
    pts, q = _tiny_problem()
    assign = random_partition(len(pts), 8)
    clusters = partition_to_clusters(assign, 8)

    # the distributed query step: shard-parallel scan + top-k merge
    divf = DistributedIVF(pts, clusters, mesh=mesh, device=device,
                          backend=backend)
    probes = np.tile(np.arange(8, dtype=np.int32), (len(q), 1))[:, :3]
    d, i = divf.search_probed(q, probes, 10)
    assert d.shape == (len(q), 10) and (i >= 0).all()

    # routed serving: each rank routes its dp slice, microbatch by microbatch
    rng = np.random.default_rng(5)
    rsub = np.sort(rng.choice(len(pts), 256, replace=False))
    dse = DistributedServingEngine(pts, clusters, pts[rsub], assign[rsub],
                                   mesh=mesh, device=device, backend=backend)
    fd, fi = dse.serve(q, 10, nprobes=3, voting_t=20, microbatch=32)
    assert fd.shape == (len(q), 10) and (fi >= 0).all()
    assert np.isfinite(fd).all()

    # the sharded index-build step: one Lloyd round, partials in rank order
    step = sharded_lloyd_round(mesh, k=8, device=device, backend=backend)
    per = -(-len(pts) // world)
    new_c, a = step(pts[rank * per : (rank + 1) * per],
                    random_sample(pts, 8, seed=5))
    assert tuple(new_c.shape) == (8, pts.shape[1]) and len(a) == len(pts)
    return {"mesh": mesh.shape, "device": str(device), "queries": len(fd),
            "dists": d, "ids": i, "serve_ids": fi,
            "centroids": new_c.cpu().numpy(), "assignment": a.cpu().numpy()}


def dryrun_multichip(n: int, device="cuda", backend: Optional[str] = None,
                     timeout: float = 120.0) -> list:
    """Run one distributed query step, one routed serve and one sharded
    Lloyd round in ``n`` local ranks; returns each rank's results.

    On ``device="cuda"`` rank r runs on ``cuda:{r % device_count}`` and the
    ranks exchange over gloo (``backend=None``): the cards may be shared.
    ``backend="nccl"`` needs a card for each rank. A failed rank or a run
    past ``timeout`` seconds raises."""
    from gpann_tpu_torch.dist.launch import run_ranks
    # the ranks import the function by module path, which is not __main__
    # under ``python -m gpann_tpu_torch.entry``
    from gpann_tpu_torch.entry import _dryrun_rank as rank_fn

    device = _device(device)
    backend = backend or "gloo"
    out = run_ranks(rank_fn, n, (device.type, backend), timeout=timeout,
                    backend=backend)
    mesh = out[0]["mesh"]
    print(f"dryrun_multichip OK on {n} ranks, {device.type} "
          f"(mesh dp={mesh['dp']} x shard={mesh['shard']}; fused serve: "
          f"{out[0]['queries']} queries x k=10, nprobes=3)", flush=True)
    return out


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() run OK:", [tuple(o.shape) for o in out], flush=True)
    dryrun_multichip(2)
