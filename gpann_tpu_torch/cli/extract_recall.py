"""Post-hoc recall analysis CLI (counterpart of
``gpann_tpu/cli/extract_recall.py``).

Reference parity: ``extract_recall.py``: for every (dataset, method,
shards[, overlap]) combination, run OracleRecall on the saved ``*.routes``
artifacts and/or AnalyzeApproximationLosses — re-analysis from stage
checkpoints, filename conventions matching ``extract_recall.py:36-79``.
``--mode oracle`` runs on the host; ``--mode losses`` computes on
``--device``.

Usage:
    python -m gpann_tpu_torch.cli.extract_recall <data_path> <out_path> \
        [--datasets deep:l2,...] [--methods GP,...] [--shards 40] \
        [--mode oracle|losses] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

OVERLAPPING = {"OGP", "OGPS", "OBKM", "OKM", "ORKM"}
NUM_NEIGHBORS = 10


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_path")
    p.add_argument("out_path")
    p.add_argument("--datasets", default="deep:l2")
    p.add_argument("--methods", default="GP,KMeans,BalancedKMeans,Pyramid")
    p.add_argument("--shards", default="40")
    p.add_argument("--overlap", type=float, default=0.2)
    p.add_argument("--mode", choices=["oracle", "losses"], default="losses")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from gpann_tpu_torch.cli import analyze_approximation_losses as losses_cli
    from gpann_tpu_torch.cli import oracle_recall as oracle_cli

    for spec in args.datasets.split(","):
        dataset, metric = spec.split(":") if ":" in spec else (spec, "l2")
        pfx = os.path.join(args.data_path, dataset)
        for method in args.methods.split(","):
            sfx = f".o={args.overlap}" if method in OVERLAPPING else ""
            for shards in map(int, args.shards.split(",")):
                part = f"{pfx}.partition.k={shards}.{method}{sfx}"
                if args.mode == "oracle":
                    rc = oracle_cli.main([
                        f"{pfx}_ground-truth.bin",
                        os.path.join(args.out_path,
                                     f"{dataset}.k={shards}.{method}{sfx}.routes"),
                        str(NUM_NEIGHBORS), part, method,
                        os.path.join(args.out_path,
                                     f"{dataset}.{method}.k={shards}{sfx}.oracle_recall"),
                    ])
                else:
                    rc = losses_cli.main([
                        f"{pfx}_base1B.fbin", f"{pfx}_query.fbin",
                        f"{pfx}_ground-truth.bin", str(NUM_NEIGHBORS), part,
                        method,
                        os.path.join(
                            args.out_path,
                            f"{dataset}.{method}.k={shards}.single-center-routes.csv",
                        ),
                        "--device", args.device,
                    ])
                if rc:
                    return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
