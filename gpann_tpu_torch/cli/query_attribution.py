"""QueryAttribution CLI of the PyTorch port — the main benchmark driver
(counterpart of ``gpann_tpu/cli/query_attribution.py``; reference
``run_query_attribution.cpp``, C18).

Read points/queries, compute-or-load+verify ground truth, read clusters,
run the routing-config sweep, serialize ``*.routes``, run the in-shard
search sweep, serialize ``*.searches``, combine into the QPS/recall CSV and
Pareto-filter.

Usage:
    python -m gpann_tpu_torch.cli.query_attribution \
        <points.fbin> <queries.fbin> <ground_truth.bin> <k> \
        <clusters_file> <num_shards> <out_prefix> [part_method] [metric] \
        [budgets] [--device DEVICE]

``budgets``: comma-separated router size budgets; default = the reference's
{20k..10M} grid (routes.cpp:130) clipped to the dataset size, so the CSV
contains the full recall-vs-index-size tradeoff curve. ``--device``
(default ``cuda``, which raises without a GPU; ``cpu`` when asked for) is
where ground truth, routers and in-shard searches compute. The seconds of
each stage are printed at the end.
"""

from __future__ import annotations

import os
import sys

from gpann_tpu_torch.cli import pop_device, resolve_device
from gpann_tpu_torch.cli.small_scale_queries import load_or_compute_gt
from gpann_tpu_torch.core import read_clusters, read_points
from gpann_tpu_torch.core.profiling import StageTimer
from gpann_tpu_torch.eval import kth_neighbor_distance
from gpann_tpu_torch.eval.combination import (
    CSV_HEADER,
    combine_routes_and_searches,
    pareto_filter,
    serialize_routes,
    serialize_searches,
)
from gpann_tpu_torch.route.flat import FlatRouter
from gpann_tpu_torch.route.sweep import default_budgets, iterate_routing_configs
from gpann_tpu_torch.search.shard_sweep import run_in_shard_searches


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = pop_device(argv)
    if len(argv) < 7:
        print(__doc__)
        return 2
    device = resolve_device(device)
    point_file, query_file, gt_file = argv[:3]
    k = int(argv[3])
    part_file = argv[4]
    requested_shards = int(argv[5])
    out_prefix = argv[6]
    part_method = argv[7] if len(argv) > 7 else "GP"
    metric = argv[8] if len(argv) > 8 else "l2"
    budgets_arg = argv[9] if len(argv) > 9 else None

    timer = StageTimer()
    with timer.stage("read"):
        points = read_points(point_file)
        queries = read_points(query_file)
    print(f"loaded base {points.shape} queries {queries.shape}", flush=True)

    with timer.stage("ground truth"):
        gt_ids, gt_dists = load_or_compute_gt(gt_file, points, queries, k,
                                              metric, device=device)
    kth = kth_neighbor_distance(gt_dists, k)

    with timer.stage("read"):
        clusters = read_clusters(part_file)
    num_shards = len(clusters)
    min_cluster_size = min(len(c) for c in clusters)

    # budget grid sweep — the recall-vs-index-size tradeoff curve
    # (routes.cpp:130: {20k..10M}; the blueprint budget n/requested_shards of
    # run_query_attribution.cpp:68-69 is superseded by the grid there too)
    if budgets_arg:
        budgets = [int(b) for b in budgets_arg.split(",")]
    else:
        budgets = default_budgets(points.shape[0])
    print(f"router budget grid: {budgets}", flush=True)

    # Pyramid/OurPyramid saved routing indices next to the partition file
    # (run_query_attribution.cpp:70-79 derives the paths from the partition
    # file name when the method matches; routes.cpp:287-311 sweeps them)
    def _side_index(suffix):
        p = part_file + suffix + ".npz"
        if os.path.exists(p):
            print(f"loading side routing index {p}", flush=True)
            return FlatRouter.load(p, device=device)
        return None

    pyramid_index = (_side_index(".pyramid_routing_index")
                     if part_method == "Pyramid" else None)
    our_pyramid_index = (_side_index(".our_pyramid_routing_index")
                         if part_method == "OurPyramid" else None)

    with timer.stage("routing sweep"):
        routes = iterate_routing_configs(
            points, queries, clusters, budgets=budgets, metric=metric,
            pyramid_index=pyramid_index, our_pyramid_index=our_pyramid_index,
            device=device,
        )
        serialize_routes(routes, out_prefix + ".routes")
    print(f"{len(routes)} routing configs -> {out_prefix}.routes", flush=True)

    with timer.stage("in-shard sweep"):
        searches = run_in_shard_searches(
            points, queries, clusters, kth, k, metric=metric, device=device
        )
        serialize_searches(searches, out_prefix + ".searches")
    print(f"{len(searches)} search configs -> {out_prefix}.searches", flush=True)

    with timer.stage("combine"):
        rows = combine_routes_and_searches(
            routes, searches, len(queries), num_shards, requested_shards, k,
            partition_method=part_method, min_cluster_size=min_cluster_size,
        )
        with open(out_prefix + ".csv", "w") as f:
            f.write(CSV_HEADER + "\n")
            f.write("\n".join(rows) + "\n")
        front = pareto_filter(rows)
        with open(out_prefix + ".pareto", "w") as f:
            f.write(CSV_HEADER + "\n")
            f.write("\n".join(front) + "\n")
    print(f"wrote {len(rows)} rows, {len(front)} pareto rows")
    print(timer.report(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
