"""Partition CLI of the PyTorch port (counterpart of
``gpann_tpu/cli/partition.py``; reference ``partition.cpp``).

Usage:
    python -m gpann_tpu_torch.cli.partition \
        <points.fbin> <output_prefix> <num_clusters> <method> \
        [overlap] [metric] [size] [default|strong] [--device DEVICE]

``--device`` (default ``cuda``) is where the partitioner computes: ``cuda``,
``cuda:N`` or ``cpu``. Without a GPU, ``cuda`` raises; pass ``--device cpu``
to run on the CPU.

Methods: GP, Pyramid, OurPyramid, KMeans, BalancedKMeans, FlatKMeans, RKM,
Random. The overlapping methods (OGP, OGPS, OKM, OBKM, ORKM) are not in the
port yet and fail.

``strong`` selects the reference's strong graph-builder preset (FANOUT=5,
REPETITIONS=5). Balance epsilon is fixed at 0.05 (``partition.cpp:88``). The
output cluster file is named ``<out>.k=<k>.<method>[.o=<overlap>]``
(``partition.cpp:46-61``), as the JAX CLI names it.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gpann_tpu_torch.core.metis_io import write_clusters
from gpann_tpu_torch.core.pointset import read_points

EPS = 0.05  # partition.cpp:88


def _pop_device(argv: list) -> str:
    """Remove ``--device X`` / ``--device=X`` from ``argv``; return X."""
    for i, arg in enumerate(argv):
        if arg == "--device":
            if i + 1 == len(argv):
                raise SystemExit("--device needs a value")
            device = argv[i + 1]
            del argv[i : i + 2]
            return device
        if arg.startswith("--device="):
            del argv[i]
            return arg.split("=", 1)[1]
    return "cuda"


def resolve_device(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA device without a GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA GPU is available; pass "
                           "--device cpu to partition on the CPU")
    return device


def run_method(points, k, method, eps=EPS, overlap=0.0, metric="l2", seed=555,
               strong=False, routing_index_path=None, *, device):
    """Dispatch a partitioning method; returns Clusters."""
    from gpann_tpu_torch.gp import api as gp_api

    return gp_api.partition(points, k, method, eps=eps, overlap=overlap,
                            metric=metric, seed=seed, strong=strong,
                            routing_index_path=routing_index_path,
                            device=device)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _pop_device(argv)
    if len(argv) < 4:
        print(__doc__)
        return 2
    device = resolve_device(device)
    point_file, out_prefix, k_str, method = argv[:4]
    k = int(k_str)
    overlap = (float(argv[4]) if len(argv) > 4
               else (0.2 if method.startswith("O") else 0.0))
    metric = argv[5] if len(argv) > 5 else "l2"
    size = int(argv[6]) if len(argv) > 6 else None
    strong = len(argv) > 7 and argv[7] == "strong"

    points = read_points(point_file, size=size)
    print(f"loaded {points.shape}; partitioning with {method} k={k} on "
          f"{device}" + (" (strong)" if strong else ""), flush=True)
    suffix = f".k={k}.{method}"
    if method.startswith("O"):  # overlapping methods record the overlap
        suffix += f".o={overlap}"
    out = out_prefix + suffix
    # Pyramid/OurPyramid save their coarse routing index next to the
    # partition (partition.cpp:94,110)
    ri_path = None
    if method == "Pyramid":
        ri_path = out + ".pyramid_routing_index"
    elif method == "OurPyramid":
        ri_path = out + ".our_pyramid_routing_index"
    clusters = run_method(points, k, method, overlap=overlap, metric=metric,
                          strong=strong, routing_index_path=ri_path,
                          device=device)
    write_clusters(out, clusters)
    sizes = [len(c) for c in clusters]
    print(f"wrote {out}; sizes min={min(sizes)} max={max(sizes)} "
          f"limit={(1+EPS)*np.ceil(sum(sizes)/k):.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
