"""DistributedBench CLI of the PyTorch port — a measured multi-rank query
benchmark (counterpart of ``gpann_tpu/cli/distributed_bench.py``; reference
``distributed_bench.cpp`` + ``src/distributed_query_benchmark.h``).

Shards live across the ranks (``gpann_tpu_torch.dist``), every rank routes
its own queries, candidate lists merge over collectives, and the QPS is
measured. Without ``--distributed`` it is the one-rank layout in this
process. With it, each process joins the group its launcher describes
(``env://``), e.g. ``python -m torch.distributed.run --nproc-per-node 2 -m
gpann_tpu_torch.cli.distributed_bench ... --distributed``; rank r computes
on ``cuda:{LOCAL_RANK % device_count}``.

Usage:
    python -m gpann_tpu_torch.cli.distributed_bench \
        <points.fbin> <queries.fbin> <k> <clusters_file> <nprobes> \
        [metric] [--distributed] [--device DEVICE] [--backend gloo|nccl]

``--device`` (default ``cuda``; ``cpu`` when asked for): without a GPU,
``cuda`` raises. ``--backend`` (default ``gloo``) is the process group's:
gloo exchanges through host copies, so ranks may share a card; nccl needs a
card for each rank. Rank 0 prints the layout, the build time, the warm
serve's first id, the fused QPS (and a rank's share) and the unfused QPS
(host-routed probes, then the collective search); times are medians of
synchronised calls.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from gpann_tpu_torch.cli import pop_device, resolve_device
from gpann_tpu_torch.core.metis_io import read_clusters
from gpann_tpu_torch.core.pointset import read_points
from gpann_tpu_torch.core.timer import time_fn


def _pop_value(argv: list, flag: str, default: str) -> str:
    if flag in argv:
        i = argv.index(flag)
        if i + 1 == len(argv):
            raise SystemExit(f"{flag} needs a value")
        value = argv[i + 1]
        del argv[i : i + 2]
        return value
    return default


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = pop_device(argv)
    backend = _pop_value(argv, "--backend", "gloo")
    distributed = "--distributed" in argv
    if distributed:
        argv.remove("--distributed")
    if len(argv) < 5:
        print(__doc__)
        return 2
    device = resolve_device(device)
    if distributed:
        dist.init_process_group(backend, init_method="env://")
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            device = torch.device("cuda", local % torch.cuda.device_count())
    try:
        return _run(argv, device, backend if distributed else None)
    finally:
        if distributed:
            dist.destroy_process_group()


def _run(argv: list, device: torch.device, backend) -> int:
    from gpann_tpu_torch.dist import (DistributedIVF, DistributedServingEngine,
                                      shard_mesh)
    from gpann_tpu_torch.route.flat import centroid_router

    point_file, query_file, k_str, part_file, nprobes_str = argv[:5]
    metric = argv[5] if len(argv) > 5 else "l2"
    k, nprobes = int(k_str), int(nprobes_str)
    points = read_points(point_file)
    queries = read_points(query_file)
    clusters = read_clusters(part_file)

    ndev = dist.get_world_size() if dist.is_initialized() else 1
    dp = 2 if ndev % 2 == 0 and ndev >= 4 else 1
    mesh = shard_mesh(dp=dp)
    say = print if mesh.rank == 0 else (lambda *a, **kw: None)
    say(f"{ndev} ranks ({device.type}); {len(clusters)} shards; mesh "
        f"{mesh.shape}", flush=True)

    t0 = time.time()
    router = centroid_router(points, clusters, metric=metric, device=device)
    engine = DistributedServingEngine(
        points, clusters, router.points.cpu().numpy(), router.labels_np,
        mesh=mesh, metric=metric, device=device, backend=backend)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    say(f"index built in {time.time() - t0:.1f}s", flush=True)

    m = len(queries)
    microbatch = max(1, min(128, m // max(dp, 1)))
    d, i = engine.serve(queries, k, nprobes, microbatch=microbatch)
    say(f"fused serve warm: top1 id of q0 = {i[0, 0]}", flush=True)

    # fused path: routing on every rank, the batch padded to dp*microbatch
    quantum = dp * microbatch
    mq = -(-m // quantum) * quantum
    qp = np.zeros((mq, queries.shape[1]), np.float32)
    qp[:m] = queries
    q_dev = torch.from_numpy(qp).to(device)
    lat, _ = time_fn(lambda: engine.serve_device(q_dev, k, nprobes,
                                                 microbatch=microbatch),
                     reps=10, device=device)
    qps = mq / lat
    say(f"fused nprobes={nprobes}: {mq} queries in {lat * 1e3:.1f} ms -> "
        f"{qps:.0f} QPS ({qps / ndev:.0f} QPS/rank)", flush=True)

    # unfused reference point: host-computed probes + collective search
    index = DistributedIVF(points, clusters, mesh=mesh, metric=metric,
                           device=device, backend=backend)
    probes = router.query(queries, rule="min_dist")[:, :nprobes]
    lat, _ = time_fn(index.search_probed, queries, probes, k, reps=5,
                     device=device)
    say(f"unfused nprobes={nprobes}: {m} queries in {lat * 1e3:.1f} ms -> "
        f"{m / lat:.0f} QPS", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
