"""Small-scale end-to-end queries CLI of the PyTorch port (counterpart of
``gpann_tpu/cli/small_scale_queries.py``; reference
``small_scale_queries.cpp``, C19).

Load points/queries, compute-or-load+verify ground truth, train a
k-means-tree router and a flat (HNSW-role) router over its extracted points,
build the in-shard IVF index, and emit a recall/latency CSV over routers x
search paths x nprobes.

CSV schema parity (``small_scale_queries.cpp:142``):
``partitioning,routing,shard query,probes,latency,routing latency,query latency,recall``
(latencies in seconds per query batch member, i.e. amortized per query).

Usage:
    python -m gpann_tpu_torch.cli.small_scale_queries \
        <points.fbin> <queries.fbin> <ground_truth.bin> <num_neighbors> \
        <partition_file> <out.csv> [partition_method] [metric] \
        [--device DEVICE]

If ``partition_file`` does not exist, the unpartitioned brute-force baseline
is run instead (reference ``small_scale_queries.cpp:56-91``). ``--device``
(default ``cuda``, which raises without a GPU; ``cpu`` when asked for) is
where ground truth, routers and searches compute; ground truth that is not
cached goes through kernel B2 on a CUDA device. The seconds of each stage
are printed at the end.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from gpann_tpu_torch.cli import pop_device, resolve_device
from gpann_tpu_torch.core import (
    read_clusters,
    read_ground_truth,
    read_points,
    write_ground_truth,
)
from gpann_tpu_torch.core.profiling import StageTimer
from gpann_tpu_torch.core.timer import time_fn
from gpann_tpu_torch.eval import (
    compute_ground_truth,
    kth_neighbor_distance,
    recall_from_ids,
    verify_ground_truth,
)
from gpann_tpu_torch.route import FlatRouter, KMeansTreeRouter, KMeansTreeRouterOptions
from gpann_tpu_torch.search.ivf import IVFIndex


def load_or_compute_gt(gt_path, points, queries, k, metric, *, device):
    """Reference pattern: compute once then cache; always verify
    (run_query_attribution.cpp:46-57)."""
    if gt_path and os.path.exists(gt_path):
        ids, dists = read_ground_truth(gt_path)
    else:
        ids, dists = compute_ground_truth(points, queries, max(k, 10),
                                          metric=metric, device=device)
        if gt_path:
            write_ground_truth(gt_path, ids.astype(np.uint32), dists)
    ids, dists = verify_ground_truth(points, queries, ids, dists, metric=metric)
    return ids, dists


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = pop_device(argv)
    if len(argv) < 6:
        print(__doc__)
        return 2
    device = resolve_device(device)
    point_file, query_file, gt_file, k_str, part_file, out_csv = argv[:6]
    num_neighbors = int(k_str)
    metric = argv[7] if len(argv) > 7 else "l2"
    part_method = argv[6] if len(argv) > 6 else "KMeans"

    timer = StageTimer()
    with timer.stage("read"):
        points = read_points(point_file)
        queries = read_points(query_file)
    print(f"loaded base {points.shape}, queries {queries.shape}", flush=True)

    with timer.stage("ground truth"):
        gt_ids, gt_dists = load_or_compute_gt(gt_file, points, queries,
                                              num_neighbors, metric,
                                              device=device)
    kth = kth_neighbor_distance(gt_dists, num_neighbors)

    rows = ["partitioning,routing,shard query,probes,latency,routing latency,query latency,recall"]

    if not os.path.exists(part_file):
        # unpartitioned brute-force baseline (small_scale_queries.cpp:56-91)
        from gpann_tpu_torch.core.distances import to_device, topk_neighbors

        with timer.stage("brute force"):
            qt, pt = to_device(queries, device), to_device(points, device)
            lat, (d, i) = time_fn(
                lambda: topk_neighbors(qt, pt, num_neighbors, metric=metric),
                device=device,
            )
        rec = recall_from_ids(points, queries, i, kth, num_neighbors,
                              metric=metric)
        per_q = lat / len(queries)
        rows.append(f"none,none,BruteForce,1,{per_q},0.0,{per_q},{rec}")
    else:
        with timer.stage("read"):
            clusters = read_clusters(part_file)
        num_shards = len(clusters)
        print(f"{num_shards} shards, sizes {[len(c) for c in clusters]}", flush=True)
        with timer.stage("indexes"):
            ivf = IVFIndex(points, clusters, metric=metric, device=device)
            # second in-shard technology (reference IVF-HNSW at fixed
            # ef=120, small_scale_queries.cpp:132-134): budgeted two-level
            # scan whose in-shard work is capped at sub_nprobe sub-clusters —
            # sub-linear in shard size where BruteForce is linear
            from gpann_tpu_torch.search.two_level import TwoLevelIVF

            two_level = TwoLevelIVF(points, clusters, metric=metric,
                                    device=device)
        TWO_LEVEL_SUB_NPROBE = 4

        # routers (small_scale_queries.cpp:96-129: KMTR budget 50k /
        # 32 centroids, then flat router over extracted points)
        with timer.stage("routers"):
            opts = KMeansTreeRouterOptions(num_centroids=32, budget=50_000)
            kmtr = KMeansTreeRouter(metric=metric, device=device).train(
                points, clusters, opts)
            rp, labels = kmtr.extract_points()
            flat = FlatRouter(rp, labels, num_shards=num_shards,
                              metric=metric, device=device)

        routers = {
            # reference routes with a 5000-distance-comp tree walk
            # (small_scale_queries.cpp:117): capped subtree descent
            "KMeansTree": lambda q: kmtr.query_budgeted(q,
                                                        search_budget=5_000),
            "Flat": lambda q: flat.query(q, num_voting_neighbors=60, rule="min_dist"),
        }
        with timer.stage("sweep"):
            for rname, route in routers.items():
                rlat, probe_order = time_fn(route, queries, reps=3, device=device)
                probe_order = np.asarray(probe_order)
                rlat_per_q = rlat / len(queries)
                # shard-query types mirror the reference's BruteForce (linear
                # exact scan) vs HNSW (budgeted, sub-linear) contrast
                # (small_scale_queries.cpp:146-189)
                for engine in ("BruteForce", "TwoLevel"):
                    for nprobes in range(1, num_shards + 1):
                        probes = probe_order[:, :nprobes]
                        if engine == "BruteForce":
                            qlat, (dd, ii) = time_fn(
                                ivf.search_probed_grouped, queries, probes,
                                num_neighbors, reps=3, device=device,
                            )
                        else:
                            qlat, (dd, ii) = time_fn(
                                two_level.search, queries, probes, num_neighbors,
                                TWO_LEVEL_SUB_NPROBE, reps=3, device=device,
                            )
                        rec = recall_from_ids(
                            points, queries, ii, kth, num_neighbors, metric=metric
                        )
                        qlat_per_q = qlat / len(queries)
                        rows.append(
                            f"{part_method},{rname},{engine},{nprobes},"
                            f"{rlat_per_q + qlat_per_q},{rlat_per_q},{qlat_per_q},{rec}"
                        )
                        print(rows[-1], flush=True)

    with open(out_csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"wrote {out_csv} ({len(rows)-1} rows)")
    print(timer.report(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
