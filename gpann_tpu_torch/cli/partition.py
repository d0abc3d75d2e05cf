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
Random, and the overlapping OGP, OGPS, OKM, OBKM, ORKM (overlap default 0.2).

``strong`` selects the reference's strong graph-builder preset (FANOUT=5,
REPETITIONS=5). Balance epsilon is fixed at 0.05 (``partition.cpp:88``). The
output cluster file is named ``<out>.k=<k>.<method>[.o=<overlap>]``
(``partition.cpp:46-61``), as the JAX CLI names it.
"""

from __future__ import annotations

import sys

import numpy as np

from gpann_tpu_torch.cli import pop_device, resolve_device
from gpann_tpu_torch.core.metis_io import write_clusters
from gpann_tpu_torch.core.pointset import read_points

EPS = 0.05  # partition.cpp:88


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
    device = pop_device(argv)
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
