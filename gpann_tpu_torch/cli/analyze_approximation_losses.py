"""AnalyzeApproximationLosses CLI: isolate routing-approximation losses
(counterpart of ``gpann_tpu/cli/analyze_approximation_losses.py``).

Reference parity: ``analyze_approximation_losses.cpp``: compare the
recall-vs-probes curves of (a) brute-force routing over the full dataset,
(b) k-means-tree-router sample routing, (c) uniform-sample routing, and
(d) single-centroid-per-shard routing (``:42-142``). (The reference's early
``return 0`` at ``:192`` leaves only the single-center branch live; we emit
all four.) CSV schema: ``partitioning,num probes,recall,type``.

Usage:
    python -m gpann_tpu_torch.cli.analyze_approximation_losses \
        <points.fbin> <queries.fbin> <gt.bin> <k> <clusters_file> \
        <part_method> <out.csv> [--device cuda]
"""

from __future__ import annotations

import sys

import numpy as np

from gpann_tpu_torch.cli import pop_device, resolve_device
from gpann_tpu_torch.cli.oracle_recall import recall_for_increasing_probes
from gpann_tpu_torch.cli.small_scale_queries import load_or_compute_gt
from gpann_tpu_torch.core import read_clusters, read_points
from gpann_tpu_torch.core.partition import (
    clusters_to_cover_csr, clusters_to_partition)
from gpann_tpu_torch.route import (
    FlatRouter,
    KMeansTreeRouter,
    KMeansTreeRouterOptions,
    centroid_router,
)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device_name = pop_device(argv)
    if len(argv) < 7:
        print(__doc__)
        return 2
    device = resolve_device(device_name)
    point_file, query_file, gt_file, k_str, part_file, part_method, out_csv = argv[:7]
    k = int(k_str)

    points = read_points(point_file)
    queries = read_points(query_file)
    gt_ids, _ = load_or_compute_gt(gt_file, points, queries, k, "l2",
                                   device=device)
    clusters = read_clusters(part_file)
    num_shards = len(clusters)
    n = len(points)
    cover = clusters_to_cover_csr(clusters, n)
    partition = clusters_to_partition(clusters, n=n)

    variants = {}
    # (a) brute-force routing: min distance to ANY point of the shard
    full_router = FlatRouter(points, partition, num_shards=num_shards,
                             device=device)
    variants["brute-force-routing"] = full_router.query(
        queries, num_voting_neighbors=min(1000, n), rule="min_dist"
    )
    # (b) KMTR-sample routing
    opts = KMeansTreeRouterOptions(budget=min(50_000, n))
    kmtr = KMeansTreeRouter(device=device).train(points, clusters, opts)
    variants["kmeans-tree-sample"] = kmtr.query(queries)
    # (c) uniform sample routing
    rng = np.random.default_rng(555)
    sample = rng.choice(n, size=min(50_000, n), replace=False)
    sample_router = FlatRouter(points[sample], partition[sample],
                               num_shards=num_shards, device=device)
    variants["uniform-sample"] = sample_router.query(
        queries, num_voting_neighbors=100, rule="min_dist"
    )
    # (d) single center per shard
    variants["single-center"] = centroid_router(
        points, clusters, device=device
    ).query(queries, rule="min_dist")

    rows = ["partitioning,num probes,recall,type"]
    for name, probes in variants.items():
        curve = recall_for_increasing_probes(
            list(np.asarray(probes)), cover, gt_ids, k, num_shards
        )
        for j, rec in enumerate(curve):
            rows.append(f"{part_method},{j},{rec},{name}")
        print(f"{name}: first-shard recall {curve[0]:.4f}", flush=True)
    with open(out_csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
