"""Flat (non-overlapping) partitioning methods (counterpart of
``gpann_tpu/gp/partitioning.py``; reference ``src/partitioning.cpp``).

- :func:`graph_partitioning` (GP): approximate kNN graph -> symmetrize ->
  balanced multilevel partition (``partitioning.cpp:251-264``).
- :func:`recursive_kmeans_partitioning` / :func:`kmeans_partitioning` —
  k-means with recursive re-splitting of overloaded clusters
  (``partitioning.cpp:12-88,143-146``).
- :func:`rebalancing_kmeans_partitioning` (RKM) — k-means + greedy point
  re-migration (``partitioning.cpp:90-141``).
- :func:`balanced_kmeans_partitioning` (BalancedKMeans,
  ``partition.cpp:13-21``) and :func:`flat_kmeans_partitioning` (FlatKMeans,
  plain Lloyd, ``partition.cpp:23-26``).
- :func:`pyramid_partitioning` — subsample -> aggregates -> kNN graph ->
  partition -> capacity-constrained nearest-aggregate assignment with retry
  rounds (``partitioning.cpp:266-356``).
- :func:`hierarchical_kmeans` + :func:`our_pyramid_partitioning` — recursive
  coarsening to <=64 centroids a level, weighted kNN-graph partition of the
  leaf centroids, projection to the full set (``partitioning.cpp:360-552``).
- :func:`random_partition` — seeded shuffle baseline (``partition.cpp:64-79``).

Every method takes numpy points and computes on the ``device`` it is given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpann_tpu_torch.cluster.kmeans import (
    balanced_kmeans,
    kmeans,
    random_sample,
    rebalance_greedy,
)
from gpann_tpu_torch.core.distances import Metric, to_device, topk_neighbors
from gpann_tpu_torch.core.partition import Partition, remap_partition_ids
from gpann_tpu_torch.gp.lp import partition_graph
from gpann_tpu_torch.graph.knn import (
    ApproximateKNNGraphBuilder,
    build_exact_knn_graph,
    symmetrize_to_csr,
)


def random_partition(n: int, k: int, seed: int = 555) -> Partition:
    """Seeded shuffled striping (partition.cpp:64-79)."""
    part = np.repeat(np.arange(k, dtype=np.int32), -(-n // k))[:n]
    np.random.default_rng(seed).shuffle(part)
    return part


def flat_kmeans_partitioning(points: np.ndarray, k: int, metric: Metric = "l2",
                             seed: int = 555, *, device) -> Partition:
    """Plain Lloyd assignment, no balance guarantee (partition.cpp:23-26)."""
    _, assign = kmeans(points, k=k, metric=metric, seed=seed, device=device)
    return remap_partition_ids(assign)


def balanced_kmeans_partitioning(points: np.ndarray, k: int, eps: float = 0.05,
                                 metric: Metric = "l2", seed: int = 555, *,
                                 device) -> Partition:
    """Balanced k-means (partition.cpp:13-21)."""
    _, assign = balanced_kmeans(points, k=k, eps=eps, metric=metric, seed=seed,
                                device=device)
    return assign


def recursive_kmeans_partitioning(
    points: np.ndarray,
    max_cluster_size: int,
    num_clusters: Optional[int] = None,
    metric: Metric = "l2",
    seed: int = 555,
    depth: int = 0,
    *,
    device,
) -> Partition:
    """K-means, recursively re-splitting overloaded clusters with fresh part
    ids (partitioning.cpp:12-88)."""
    n = points.shape[0]
    if num_clusters is None:
        num_clusters = int(np.ceil(n / max_cluster_size))
    if num_clusters <= 0 or n == 0:
        return np.zeros(n, np.int32)
    _, part = kmeans(points, k=num_clusters, metric=metric, seed=seed,
                     device=device)
    part = remap_partition_ids(part)
    num_clusters = int(part.max()) + 1
    sizes = np.bincount(part, minlength=num_clusters)
    next_id = num_clusters
    for c in np.nonzero(sizes > max_cluster_size)[0]:
        members = np.nonzero(part == c)[0]
        sub = recursive_kmeans_partitioning(
            points[members], max_cluster_size, None, metric, seed, depth + 1,
            device=device)
        # sub-part 0 keeps id c; others get fresh ids (partitioning.cpp:60-85)
        part[members] = np.where(sub == 0, c, sub - 1 + next_id)
        next_id += int(sub.max())
    return remap_partition_ids(part)


def rebalancing_kmeans_partitioning(
    points: np.ndarray,
    max_cluster_size: int,
    num_clusters: Optional[int] = None,
    metric: Metric = "l2",
    seed: int = 555,
    *,
    device,
) -> Partition:
    """K-means + greedy re-migration of overflow points to the nearest
    non-full centroid (partitioning.cpp:90-141)."""
    n = points.shape[0]
    if num_clusters is None:
        num_clusters = int(np.ceil(n / max_cluster_size))
    if num_clusters <= 0 or n == 0:
        return np.zeros(n, np.int32)
    cents, part = kmeans(points, k=num_clusters, metric=metric, seed=seed,
                         device=device)
    return rebalance_greedy(points, cents, part, max_cluster_size, metric,
                            device=device)


def kmeans_partitioning(points: np.ndarray, k: int, eps: float = 0.05,
                        metric: Metric = "l2", seed: int = 555, *,
                        device) -> Partition:
    """KMeans method of partition.cpp: recursive splitting under the balance
    cap (partitioning.cpp:143-146)."""
    max_cluster_size = int(points.shape[0] * (1.0 + eps) / k)
    return recursive_kmeans_partitioning(
        points, max_cluster_size, num_clusters=k, metric=metric, seed=seed,
        device=device)


def partition_dense_graph(graph: np.ndarray, num_clusters: int, eps: float,
                          node_weights: Optional[np.ndarray] = None,
                          seed: int = 555, *, device) -> Partition:
    """Symmetrize a dense [n, deg] kNN graph and partition it — the role of
    PartitionAdjListGraph (partitioning.cpp:246-249)."""
    indptr, indices, ew = symmetrize_to_csr(graph)
    return partition_graph(indptr, indices, ew, num_clusters, eps=eps,
                           node_weights=node_weights, seed=seed, device=device)


def graph_partitioning(
    points: np.ndarray,
    num_clusters: int,
    eps: float = 0.05,
    strong: bool = False,
    metric: Metric = "l2",
    seed: int = 555,
    degree: int = 10,
    graph_output_path: Optional[str] = None,
    *,
    device,
) -> Partition:
    """GP: approximate kNN graph -> balanced graph partition
    (partitioning.cpp:251-264). ``graph_output_path`` dumps the kNN graph in
    Metis format first (partitioning.cpp:258-261)."""
    builder = ApproximateKNNGraphBuilder(metric=metric, seed=seed,
                                         strong=strong, device=device)
    graph = builder.build(points, degree)
    if graph_output_path:
        from gpann_tpu_torch.core.metis_io import (
            adjacency_from_csr,
            write_metis_graph,
        )

        indptr, indices, _ = symmetrize_to_csr(graph)
        write_metis_graph(graph_output_path, adjacency_from_csr(indptr, indices))
    return partition_dense_graph(graph, num_clusters, eps, seed=seed,
                                 device=device)


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------


def _capacity_assign(points: np.ndarray, aggregate_points: np.ndarray,
                     aggregate_partition: np.ndarray, num_clusters: int,
                     max_in_cluster: int, metric: Metric, *,
                     device) -> Partition:
    """Assign each point to the partition of its nearest aggregate, under a
    per-part capacity; unadmitted points retry against aggregates of
    non-full parts (partitioning.cpp:305-356). Admission is by distance
    priority (deterministic; the reference admits in racy parallel order)."""
    n = points.shape[0]
    part = np.full(n, -1, dtype=np.int32)
    room = np.full(num_clusters, max_in_cluster, dtype=np.int64)
    unassigned = np.arange(n)
    alive = np.ones(len(aggregate_points), dtype=bool)
    aggs = to_device(aggregate_points, device)
    while len(unassigned):
        live_idx = np.nonzero(alive)[0]
        if len(live_idx) == 0:
            # no aggregates left: dump into parts with room
            w = 0
            for p in np.argsort(-room):
                take = min(int(room[p]), len(unassigned) - w)
                part[unassigned[w : w + take]] = p
                w += take
                if w == len(unassigned):
                    break
            break
        d, idx = topk_neighbors(
            to_device(points[unassigned], device),
            aggs[torch.as_tensor(live_idx).to(device)], 1, metric=metric)
        d = d[:, 0].cpu().numpy()
        target = aggregate_partition[live_idx[idx[:, 0].cpu().numpy()]]
        # admit by distance priority within each part's remaining room
        order = np.argsort(d, kind="stable")
        t_ord = target[order]
        final = order[np.argsort(t_ord, kind="stable")]
        t_fin = target[final]
        within = np.arange(len(final)) - np.searchsorted(t_fin, t_fin)
        admit = within < room[t_fin]
        part[unassigned[final[admit]]] = t_fin[admit]
        np.add.at(room, t_fin[admit], -1)
        unassigned = unassigned[final[~admit]]
        alive &= room[aggregate_partition] > 0
    return part


def _aggregate_graph(points: np.ndarray, degree: int, metric: Metric,
                     seed: int, device) -> np.ndarray:
    """kNN graph of a representative set: approximate above 5000 points,
    exact below (as the JAX package's Pyramid and OurPyramid build it)."""
    if len(points) > 5000:
        return ApproximateKNNGraphBuilder(metric=metric, seed=seed,
                                          device=device).build(points, degree)
    return build_exact_knn_graph(points, min(degree, len(points) - 1),
                                 metric=metric, device=device)


def pyramid_partitioning(
    points: np.ndarray,
    num_clusters: int,
    eps: float = 0.05,
    metric: Metric = "l2",
    seed: int = 555,
    num_subsample: int = 10_000_000,
    num_aggregate: int = 10_000,
    routing_index_path: Optional[str] = None,
    *,
    device,
) -> Partition:
    """Pyramid (partitioning.cpp:266-356): subsample -> k-means aggregates ->
    kNN graph over aggregates -> partition -> capacity-bounded assignment.
    ``routing_index_path`` saves the aggregates as a
    :class:`~gpann_tpu_torch.route.flat.FlatRouter`."""
    n = points.shape[0]
    sub = random_sample(points, min(num_subsample, n), seed)
    aggregates = random_sample(sub, min(num_aggregate, len(sub)), seed)
    aggregates, _ = kmeans(sub, centroids=aggregates, metric=metric,
                           device=device)
    agg_graph = _aggregate_graph(aggregates, 10, metric, seed, device)
    agg_part = partition_dense_graph(agg_graph, num_clusters, eps, seed=seed,
                                     device=device)
    if routing_index_path:
        from gpann_tpu_torch.route.flat import FlatRouter

        FlatRouter(aggregates, agg_part, num_shards=num_clusters, metric=metric,
                   device=device).save(routing_index_path)
    max_in_cluster = int(n * (1.0 + eps) / num_clusters)
    return _capacity_assign(points, aggregates, agg_part, num_clusters,
                            max_in_cluster, metric, device=device)


# ---------------------------------------------------------------------------
# OurPyramid (hierarchical k-means coarsening)
# ---------------------------------------------------------------------------

MAX_LEVEL_CENTROIDS = 64  # partitioning.cpp:366


def hierarchical_kmeans(points: np.ndarray, coarsening_ratio: float,
                        metric: Metric = "l2", seed: int = 555, *,
                        device) -> Tuple[Partition, np.ndarray]:
    """Recursive k-means coarsening (partitioning.cpp:436-507). Returns
    (assignment of each point to a leaf cell, leaf centroids [cells, d])."""
    n = points.shape[0]
    num_level = max(int(n * coarsening_ratio), 1)
    finished = num_level <= MAX_LEVEL_CENTROIDS
    num_level = min(num_level, MAX_LEVEL_CENTROIDS)
    cents, part = kmeans(points, k=num_level, metric=metric, seed=seed,
                         device=device)
    part = remap_partition_ids(part)
    live = np.unique(part)
    cents = cents[live] if len(live) < len(cents) else cents
    if finished or len(cents) == 1:
        return part, cents
    out_cents = []
    offset = 0
    out_part = np.zeros(n, np.int32)
    for c in range(int(part.max()) + 1):
        members = np.nonzero(part == c)[0]
        sub_part, sub_cents = hierarchical_kmeans(
            points[members], coarsening_ratio, metric, seed + c + 1,
            device=device)
        out_part[members] = sub_part + offset
        out_cents.append(sub_cents)
        offset += len(sub_cents)
    return out_part, np.concatenate(out_cents, axis=0)


def our_pyramid_partitioning(
    points: np.ndarray,
    num_clusters: int,
    eps: float = 0.05,
    coarsening_rate: float = 0.002,
    metric: Metric = "l2",
    seed: int = 555,
    routing_index_path: Optional[str] = None,
    degree: int = 20,
    *,
    device,
) -> Partition:
    """OurPyramid (partitioning.cpp:509-552): HierKMeans coarsening ->
    weighted kNN-graph partition of leaf centroids -> projection.

    As in the JAX package, the coarsening rate is floored so that at least
    ~16 cells exist per target part (below that the weighted coarse graph
    cannot be balanced)."""
    n = points.shape[0]
    coarsening_rate = max(coarsening_rate,
                          min(1.0, 16.0 * num_clusters / max(n, 1)))
    cells, routing_points = hierarchical_kmeans(points, coarsening_rate,
                                                metric, seed, device=device)
    weights = np.bincount(cells, minlength=len(routing_points)).astype(np.float32)
    rp_graph = _aggregate_graph(routing_points, degree, metric, seed, device)
    coarse_part = partition_dense_graph(rp_graph, num_clusters, eps,
                                        node_weights=weights, seed=seed,
                                        device=device)
    if routing_index_path:
        from gpann_tpu_torch.route.flat import FlatRouter

        FlatRouter(routing_points, coarse_part, num_shards=num_clusters,
                   metric=metric, device=device).save(routing_index_path)
    return coarse_part[cells].astype(np.int32)
