"""Method-name dispatch for all partitioning algorithms (counterpart of
``gpann_tpu/gp/api.py``; vocabulary of ``partition.cpp:64-137``).

GP, Pyramid, OurPyramid, KMeans, BalancedKMeans, FlatKMeans, RKM, Random
plus overlapping: OGP, OGPS, OKM, OBKM, ORKM. ``GP`` with overlap != 0
aliases to OGP (``partition.cpp:84-86``).
"""

from __future__ import annotations

import numpy as np

from gpann_tpu_torch.core.distances import Metric
from gpann_tpu_torch.core.partition import Clusters, partition_to_clusters
from gpann_tpu_torch.gp import overlap as ov
from gpann_tpu_torch.gp import partitioning as pt

METHODS = (
    "GP", "Pyramid", "OurPyramid", "KMeans", "BalancedKMeans", "FlatKMeans",
    "RKM", "Random", "OGP", "OGPS", "OKM", "OBKM", "ORKM",
)


def partition(
    points,
    k: int,
    method: str,
    eps: float = 0.05,
    overlap: float = 0.0,
    metric: Metric = "l2",
    seed: int = 555,
    strong: bool = False,
    routing_index_path: str = None,
    *,
    device,
) -> Clusters:
    """Run a partitioning method by name on ``device``; returns Clusters.

    ``routing_index_path``: where Pyramid/OurPyramid save their coarse
    routing index (``partition.cpp:94,110``)."""
    n = points.shape[0]
    if method == "GP" and overlap != 0.0:
        method = "OGP"  # partition.cpp:84-86
    if method == "Random":
        return partition_to_clusters(pt.random_partition(n, k, seed), k)
    if method == "GP":
        return partition_to_clusters(
            pt.graph_partitioning(points, k, eps, strong, metric, seed,
                                  device=device), k)
    if method == "Pyramid":
        return partition_to_clusters(
            pt.pyramid_partitioning(points, k, eps, metric, seed,
                                    routing_index_path=routing_index_path,
                                    device=device), k)
    if method == "OurPyramid":
        return partition_to_clusters(
            pt.our_pyramid_partitioning(points, k, eps, metric=metric,
                                        seed=seed,
                                        routing_index_path=routing_index_path,
                                        device=device), k)
    if method == "KMeans":
        return partition_to_clusters(
            pt.kmeans_partitioning(points, k, eps, metric, seed, device=device))
    if method == "BalancedKMeans":
        return partition_to_clusters(
            pt.balanced_kmeans_partitioning(points, k, eps, metric, seed,
                                            device=device), k)
    if method == "FlatKMeans":
        return partition_to_clusters(
            pt.flat_kmeans_partitioning(points, k, metric, seed, device=device))
    if method == "RKM":
        max_size = int((1.0 + eps) * n / k)
        return partition_to_clusters(
            pt.rebalancing_kmeans_partitioning(points, max_size, k, metric,
                                               seed, device=device))
    if method == "OGP":
        return ov.overlapping_graph_partitioning(
            points, k, eps, overlap, strong, metric, seed, device=device)
    if method == "OGPS":
        # GP into adjusted cluster count, then centroid overlap
        # (partition.cpp:113-120)
        max_size = int((1.0 + eps) * n / k)
        k_adj = int(np.ceil((n + overlap * n) / max_size))
        base = pt.graph_partitioning(points, k_adj, eps, False, metric, seed,
                                     device=device)
        return ov.overlapping_kmeans_partitioning_spann(
            points, base, k, eps, overlap, metric, seed, device=device)
    if method == "OKM":
        base = pt.kmeans_partitioning(points, k, eps, metric, seed,
                                      device=device)
        return ov.overlapping_kmeans_partitioning_spann(
            points, base, k, eps, overlap, metric, seed, device=device)
    if method == "OBKM":
        k_adj = int(np.ceil(k * (1.0 + overlap)))  # partition.cpp:129-135
        base = pt.balanced_kmeans_partitioning(points, k_adj, eps, metric,
                                               seed, device=device)
        return ov.overlapping_kmeans_partitioning_spann(
            points, base, k, eps, overlap, metric, seed, device=device)
    if method == "ORKM":
        max_size = int((1.0 + eps) * n / k)
        k_adj = int(np.ceil(k * (1.0 + overlap)))  # partition.cpp:104-108
        base = pt.rebalancing_kmeans_partitioning(points, max_size, k_adj,
                                                  metric, seed, device=device)
        return ov.overlapping_kmeans_partitioning_spann(
            points, base, k, eps, overlap, metric, seed, device=device)
    raise ValueError(f"unsupported partitioning method {method!r}; "
                     f"supported: {METHODS}")
