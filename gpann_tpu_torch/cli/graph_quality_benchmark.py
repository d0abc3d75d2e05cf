"""GraphQualityBench CLI: parameter study of the kNN-graph construction
(counterpart of ``gpann_tpu/cli/graph_quality_benchmark.py``).

Reference parity: ``graph_quality_benchmark.cpp``: grid over its
parameters (repetitions x fanout x cluster size, ``:13-38``) x degree values,
measuring (a) graph recall vs the exact kNN graph (``:53-66``) and (b)
downstream first-shard oracle recall after partitioning the approximate
graph (``:68-79,125-150``).

Usage:
    python -m gpann_tpu_torch.cli.graph_quality_benchmark \
        <points.fbin> <queries.fbin> <k> <num_clusters> <out.csv> [size]
        [--device cuda]

The grid constants below are module attributes, so a short run sets them
before calling :func:`main`.
"""

from __future__ import annotations

import sys

from gpann_tpu_torch.cli import pop_device, resolve_device
from gpann_tpu_torch.core import read_points
from gpann_tpu_torch.eval import compute_ground_truth, oracle_recall
from gpann_tpu_torch.gp.partitioning import partition_dense_graph
from gpann_tpu_torch.graph import (
    ApproximateKNNGraphBuilder, build_exact_knn_graph, graph_recall)

# the reference's full 125-config grid (graph_quality_benchmark.cpp:17-35)
REPS_GRID = (2, 3, 5, 8, 10)
FANOUT_GRID = (2, 3, 5, 8, 10)
CLUSTER_SIZE_GRID = (500, 1000, 2000, 5000, 10000)
DEGREES = (10,)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device_name = pop_device(argv)
    if len(argv) < 5:
        print(__doc__)
        return 2
    device = resolve_device(device_name)
    point_file, query_file, k_str, kc_str, out_csv = argv[:5]
    size = int(argv[5]) if len(argv) > 5 else None
    k = int(k_str)
    num_clusters = int(kc_str)

    points = read_points(point_file, size=size)
    queries = read_points(query_file)
    gt_ids, _ = compute_ground_truth(points, queries, k, device=device)

    exact = {
        deg: build_exact_knn_graph(points, deg, device=device)
        for deg in DEGREES
    }
    # resumable: completed (reps, fanout, mcs, degree) rows in an existing
    # out_csv are kept and skipped, so the 125-config grid survives
    # interruption (the reference reruns from scratch)
    header = ("reps,fanout,max_cluster_size,degree,graph_recall,"
              "first_shard_oracle_recall")
    rows = [header]
    done = set()
    try:
        with open(out_csv) as f:
            for line in f.read().splitlines()[1:]:
                parts = line.split(",")
                if len(parts) == 6:
                    done.add(tuple(int(x) for x in parts[:4]))
                    rows.append(line)
    except FileNotFoundError:
        pass
    if done:
        print(f"# resuming: {len(done)} configs already done", flush=True)
    for reps in REPS_GRID:
        for fanout in FANOUT_GRID:
            for mcs in CLUSTER_SIZE_GRID:
                if all((reps, fanout, mcs, deg) in done for deg in DEGREES):
                    continue
                builder = ApproximateKNNGraphBuilder(device=device)
                builder.REPETITIONS = reps
                builder.FANOUT = fanout
                builder.MAX_CLUSTER_SIZE = mcs
                for deg in DEGREES:
                    if (reps, fanout, mcs, deg) in done:
                        continue
                    approx = builder.build(points, deg)
                    sample = slice(0, min(2000, len(points)))
                    grecall = graph_recall(approx[sample], exact[deg][sample])
                    part = partition_dense_graph(approx, num_clusters, 0.05,
                                                 device=device)
                    first = oracle_recall(gt_ids, partition=part)[0]
                    rows.append(
                        f"{reps},{fanout},{mcs},{deg},{grecall:.4f},{first:.4f}"
                    )
                    print(rows[-1], flush=True)
                    with open(out_csv, "w") as f:  # checkpoint after each
                        f.write("\n".join(rows) + "\n")
    with open(out_csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
