"""Experiment sweep driver of the PyTorch port (counterpart of
``gpann_tpu/cli/experiments.py``).

Reference parity: ``experiments.py`` (C24): dataset registry (big-ann 1B
datasets with metric + file-ending maps, ``experiments.py:6-28``),
partition + query-attribution sweeps with the reference's filename
conventions (``experiments.py:57-98``), through the port's ``cli.partition``
and ``cli.query_attribution``. The registry and every file name are the JAX
driver's.

Usage:
    python -m gpann_tpu_torch.cli.experiments <data_path> <out_path> \
        [--datasets deep,...] [--methods GP,BalancedKMeans] [--shards 40] \
        [--size N] [--overlap X] [--device DEVICE]

``--device`` (default ``cuda``, which raises without a GPU; ``cpu`` when
asked for) is passed to both inner CLIs.
"""

from __future__ import annotations

import argparse
import os

# dataset registry — parity with experiments.py:6-28
METRICS = {
    "spacev": "l2",
    "sift1B": "l2",
    "turing": "l2",
    "deep": "l2",
    "text-to-image": "mips",
}
FILE_ENDING = {
    "spacev": ".i8bin",
    "sift1B": ".u8bin",
    "turing": ".fbin",
    "deep": ".fbin",
    "text-to-image": ".fbin",
}
QUERY_FILES = {
    "spacev": "spacev_query.i8bin",
    "sift1B": "sift1B_query.u8bin",
    "turing": "turing_query.fbin",
    "deep": "deep_query.fbin",
    "text-to-image": "text-to-image_query.fbin",
}
DEFAULT_METHODS = ["GP", "BalancedKMeans"]  # experiments.py:29-41
NUM_NEIGHBORS = 10  # experiments.py:48
OVERLAPPING = {"OGP", "OGPS", "OBKM", "OKM", "ORKM"}


def partition_file_name(out_path, dataset, k, method, overlap=0.0):
    """Filename convention parity (partition.cpp:46-61)."""
    name = f"{dataset}.partition.k={k}.{method}"
    if method in OVERLAPPING and overlap:
        name += f".o={overlap}"
    return os.path.join(out_path, name)


def run(dataset, method, num_shards, data_path, out_path, size=None,
        overlap=0.0, device="cuda"):
    from gpann_tpu_torch.cli import partition as partition_cli
    from gpann_tpu_torch.cli import query_attribution as qa_cli

    metric = METRICS[dataset]
    base = os.path.join(data_path, dataset + "_base1B" + FILE_ENDING[dataset])
    queries = os.path.join(data_path, QUERY_FILES[dataset])
    gt = os.path.join(out_path, f"{dataset}.gt.k={NUM_NEIGHBORS}")
    part_prefix = os.path.join(out_path, f"{dataset}.partition")
    part_file = partition_file_name(out_path, dataset, num_shards, method, overlap)

    if not os.path.exists(part_file):
        argv = [base, part_prefix, str(num_shards), method,
                str(overlap), metric]
        if size:
            argv.append(str(size))
        rc = partition_cli.main(argv + ["--device", device])
        if rc:
            return rc
    out_prefix = os.path.join(
        out_path, f"{dataset}.k={num_shards}.{method}"
    )
    return qa_cli.main([
        base, queries, gt, str(NUM_NEIGHBORS), part_file, str(num_shards),
        out_prefix, method, metric, "--device", device,
    ])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_path")
    p.add_argument("out_path")
    p.add_argument("--datasets", default="deep")
    p.add_argument("--methods", default=",".join(DEFAULT_METHODS))
    p.add_argument("--shards", default="40")
    p.add_argument("--overlap", type=float, default=0.0)
    p.add_argument("--size", type=int, default=None,
                   help="prefix size (points_io.cpp:25-27 parity)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.makedirs(args.out_path, exist_ok=True)
    for dataset in args.datasets.split(","):
        for method in args.methods.split(","):
            for shards in map(int, args.shards.split(",")):
                print(f"=== {dataset} {method} s={shards} ===", flush=True)
                rc = run(dataset, method, shards, args.data_path,
                         args.out_path, size=args.size, overlap=args.overlap,
                         device=args.device)
                if rc:
                    return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
