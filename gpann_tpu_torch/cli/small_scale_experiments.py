"""Small-scale experiment driver of the PyTorch port (counterpart of
``gpann_tpu/cli/small_scale_experiments.py``).

Reference parity: ``small-scale-experiments.py`` (C24): SIFT/GloVe-class
datasets, k=16 shards, 'strong' builder preset, partition sweep + the
SmallScaleQueries pipeline per method, through the port's ``cli.partition``
and ``cli.small_scale_queries``, with the JAX driver's file names.

Usage:
    python -m gpann_tpu_torch.cli.small_scale_experiments <data_path> \
        <out_path> [--datasets sift:l2,glove:mips] \
        [--methods GP,RKM,BalancedKMeans] [--shards 16] [--size N] \
        [--device DEVICE]

``--device`` (default ``cuda``, which raises without a GPU; ``cpu`` when
asked for) is passed to both inner CLIs.
"""

from __future__ import annotations

import argparse
import os

DEFAULT_METHODS = ["GP", "RKM", "BalancedKMeans"]  # small-scale-experiments.py:11-16
NUM_NEIGHBORS = 10
SHARDS = 16  # small-scale-experiments.py:18


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_path")
    p.add_argument("out_path")
    p.add_argument("--datasets", default="sift:l2,glove:mips")
    p.add_argument("--methods", default=",".join(DEFAULT_METHODS))
    p.add_argument("--shards", type=int, default=SHARDS)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.makedirs(args.out_path, exist_ok=True)
    dev = ["--device", args.device]

    from gpann_tpu_torch.cli import partition as partition_cli
    from gpann_tpu_torch.cli import small_scale_queries as ssq_cli

    for spec in args.datasets.split(","):
        dataset, metric = spec.split(":") if ":" in spec else (spec, "l2")
        base = os.path.join(args.data_path, dataset + ".fbin")
        queries = os.path.join(args.data_path, dataset + "_query.fbin")
        gt = os.path.join(args.out_path, f"{dataset}.gt")
        for method in args.methods.split(","):
            part_prefix = os.path.join(args.out_path, f"{dataset}.partition")
            part_file = f"{part_prefix}.k={args.shards}.{method}"
            if not os.path.exists(part_file):
                argv2 = [base, part_prefix, str(args.shards), method, "0.0",
                         metric]
                if args.size:
                    argv2.append(str(args.size))
                rc = partition_cli.main(argv2 + dev)
                if rc:
                    return rc
            out_csv = os.path.join(
                args.out_path, f"{dataset}.k={args.shards}.{method}.small.csv"
            )
            rc = ssq_cli.main([
                base, queries, gt, str(NUM_NEIGHBORS), part_file, out_csv,
                method, metric,
            ] + dev)
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
