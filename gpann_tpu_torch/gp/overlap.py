"""Overlapping (multi-assignment) partitioning (counterpart of
``gpann_tpu/gp/overlap.py``; reference ``src/overlapping_partitioning.cpp``).

- :func:`overlapping_graph_partitioning` (OGP, ``:50-141``): partition the
  kNN graph into k' = ceil((n + overlap*n) / L_max) clusters, then rounds of
  globally-highest-affinity extra assignments: each point's affinity to a
  foreign cluster is the number of its kNN neighbors whose *base* partition is
  that cluster; every round admits only moves at the round's maximum affinity,
  per-cluster up to capacity, until the overlap budget is spent.
- :func:`make_overlapping_with_centroids` (``:143-227``): train a k-means
  tree router on the clusters, rank each point's closest foreign clusters by
  representative distance (keep 5), sort all (point, cluster) ratings
  globally by distance and admit greedily under capacity.
- :func:`overlapping_kmeans_partitioning_spann` (``:229-235``): wrapper
  applying the centroid method on top of any base partition.
- :func:`centroid_overlap_streamed`: the large-base form of the centroid
  method — blocked device scoring (per-point best foreign clusters via a
  representatives matmul, a scatter-min fold and a top-k, with only
  [block, keep] read back) and chunked cheapest-first capacity admission.

The kNN graph, the graph partition, the router and the scoring run on the
``device`` given; the affinity fold and the admission are host numpy, as in
the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpann_tpu_torch.core.distances import Metric, sq_norms, to_device
from gpann_tpu_torch.core.partition import (
    Clusters,
    Partition,
    partition_to_clusters,
)
from gpann_tpu_torch.gp.partitioning import partition_dense_graph
from gpann_tpu_torch.graph.knn import ApproximateKNNGraphBuilder


def overlapping_graph_partitioning(
    points: np.ndarray,
    num_clusters: int,
    eps: float = 0.05,
    overlap: float = 0.2,
    strong: bool = False,
    metric: Metric = "l2",
    seed: int = 555,
    degree: int = 10,
    graph: Optional[np.ndarray] = None,
    *,
    device,
) -> Clusters:
    """OGP (overlapping_partitioning.cpp:50-141). ``graph``: a dense
    [n, degree] kNN graph to partition instead of building one."""
    n = points.shape[0]
    max_cluster_size = int((1.0 + eps) * n / num_clusters)
    num_extra = int(overlap * n)
    total_assignments = n + num_extra
    k_eff = int(np.ceil(total_assignments / max_cluster_size))

    if graph is None:
        builder = ApproximateKNNGraphBuilder(metric=metric, seed=seed,
                                             strong=strong, device=device)
        graph = builder.build(points, degree)
    part = partition_dense_graph(graph, k_eff, eps, seed=seed, device=device)
    k_eff = int(part.max()) + 1

    member = np.zeros((n, k_eff), dtype=bool)  # cover as dense bool
    member[np.arange(n), part] = True
    sizes = np.bincount(part, minlength=k_eff).astype(np.int64)

    u = np.repeat(np.arange(n), graph.shape[1])
    v = graph.reshape(-1)
    valid = v >= 0
    u, v = u[valid], v[valid]
    # affinity to each cluster = #neighbors whose base partition is there
    aff = np.zeros((n, k_eff), dtype=np.int32)
    np.add.at(aff, (u, part[v]), 1)

    remaining = num_extra
    while remaining > 0:
        masked = np.where(member | (sizes[None, :] >= max_cluster_size), -1, aff)
        best_target = masked.argmax(axis=1)
        best_aff = masked[np.arange(n), best_target]
        best = int(best_aff.max())
        if best <= 0:
            break
        movers = np.nonzero(best_aff == best)[0]
        targets = best_target[movers]
        # per-cluster admission up to room, then global budget
        order = np.argsort(targets, kind="stable")
        movers, targets = movers[order], targets[order]
        within = np.arange(len(movers)) - np.searchsorted(targets, targets)
        room = max_cluster_size - sizes
        admit = within < room[targets]
        movers, targets = movers[admit], targets[admit]
        if len(movers) > remaining:
            movers, targets = movers[:remaining], targets[:remaining]
        if len(movers) == 0:
            break
        member[movers, targets] = True
        np.add.at(sizes, targets, 1)
        remaining -= len(movers)

    return [np.nonzero(member[:, c])[0].astype(np.int32) for c in range(k_eff)]


def make_overlapping_with_centroids(
    points: np.ndarray,
    clusters: Clusters,
    max_cluster_size: int,
    num_extra_assignments: int,
    metric: Metric = "l2",
    seed: int = 555,
    num_keep: int = 5,
    *,
    device,
) -> Clusters:
    """Centroid-distance-ranked overlap (overlapping_partitioning.cpp:143-227).

    Returns a new Clusters list (input order preserved, empties dropped).
    """
    from gpann_tpu_torch.route.kmeans_tree import (
        KMeansTreeRouter,
        KMeansTreeRouterOptions,
    )

    clusters = [np.asarray(c, np.int32) for c in clusters if len(c)]
    n = points.shape[0]
    kc = len(clusters)

    num_centroids = 64
    opts = KMeansTreeRouterOptions(
        num_centroids=num_centroids,
        min_cluster_size=350,
        budget=kc * num_centroids,
        search_budget=0,
    )
    router = KMeansTreeRouter(metric=metric, device=device).train(
        points, clusters, opts, seed=seed)

    # per-point min distance to each cluster's representatives
    min_d, _ = router.flat.query_votes(points, num_voting_neighbors=len(router.flat))
    member = np.zeros((n, kc), dtype=bool)
    for c, mem in enumerate(clusters):
        member[mem, c] = True
    min_d = np.where(member, np.inf, min_d)

    sizes = np.asarray([len(c) for c in clusters], dtype=np.int64)
    # keep the 5 closest foreign clusters per point, flatten, global sort
    keep = min(num_keep, kc)
    targets = np.argsort(min_d, axis=1, kind="stable")[:, :keep]
    dists = np.take_along_axis(min_d, targets, axis=1)
    flat_p = np.repeat(np.arange(n), keep)
    flat_c = targets.reshape(-1)
    flat_d = dists.reshape(-1)
    finite = np.isfinite(flat_d)
    flat_p, flat_c, flat_d = flat_p[finite], flat_c[finite], flat_d[finite]
    order = np.argsort(flat_d, kind="stable")

    extra: list[list[int]] = [[] for _ in range(kc)]
    left = num_extra_assignments
    for idx in order:
        if left == 0:
            break
        c = int(flat_c[idx])
        if sizes[c] < max_cluster_size:
            extra[c].append(int(flat_p[idx]))
            sizes[c] += 1
            left -= 1
    return [
        np.concatenate([clusters[c], np.asarray(extra[c], np.int32)])
        if extra[c]
        else clusters[c]
        for c in range(kc)
    ]


def overlapping_kmeans_partitioning_spann(
    points: np.ndarray,
    partition: Partition,
    requested_num_clusters: int,
    eps: float = 0.05,
    overlap: float = 0.2,
    metric: Metric = "l2",
    seed: int = 555,
    *,
    device,
) -> Clusters:
    """Wrapper (overlapping_partitioning.cpp:229-235)."""
    num_extra = int(overlap * points.shape[0])
    max_cluster_size = int((1.0 + eps) * points.shape[0] / requested_num_clusters)
    clusters = partition_to_clusters(partition)
    return make_overlapping_with_centroids(
        points, clusters, max_cluster_size, num_extra, metric=metric, seed=seed,
        device=device,
    )


def foreign_cluster_candidates(
    points,                      # array-like [n, d] (memmap ok)
    assign: Partition,           # [n] base cluster of each point
    reps: np.ndarray,            # [r, d] cluster representatives
    rep_labels: np.ndarray,      # [r] cluster of each representative
    num_clusters: int,
    keep: int = 5,
    metric: Metric = "l2",
    block: int = 262144,
    *,
    device,
):
    """Each point's ``keep`` best FOREIGN clusters, scored like the
    reference's centroid method (closest representative per cluster,
    overlapping_partitioning.cpp:174-189) but computed blocked on ``device``:
    one [block, r] distance matmul -> scatter-min fold per cluster
    (``scatter_reduce_(..., "amin")``) -> top-k, with only [n, keep]
    (dist, cluster) read back. Equal distances keep the lower cluster id, as
    ``lax.top_k`` does.

    Returns (dists [n, keep] float32, clusters [n, keep] int32)."""
    device = torch.device(device)
    reps_t = to_device(np.asarray(reps, np.float32), device)
    lbl = torch.as_tensor(np.asarray(rep_labels, np.int64)).to(device)
    rsq = to_device(
        (np.asarray(reps, np.float64) ** 2).sum(1).astype(np.float32), device)
    n = points.shape[0]
    keep = min(keep, num_clusters - 1)
    out_d = np.empty((n, keep), np.float32)
    out_c = np.empty((n, keep), np.int32)

    for s in range(0, n, block):
        p = to_device(np.asarray(points[s:s + block], np.float32), device)
        own = torch.as_tensor(np.asarray(assign[s:s + block], np.int64)).to(device)
        m = p.shape[0]
        dots = p @ reps_t.T
        if metric == "mips":
            dm = dots.neg_().add_(1.0)
        else:
            dm = (sq_norms(p)[:, None] + rsq[None, :]).sub_(dots.mul_(2.0))
            del dots
        best = torch.full((m, num_clusters), torch.inf, device=device)
        best.scatter_reduce_(1, lbl.expand(m, -1), dm, reduce="amin")
        del dm
        best[torch.arange(m, device=device), own] = torch.inf
        d, c = torch.sort(best, dim=1, stable=True)
        out_d[s:s + m] = d[:, :keep].cpu().numpy()
        out_c[s:s + m] = c[:, :keep].cpu().numpy()
    return out_d, out_c


def centroid_overlap_streamed(
    points,
    assign: Partition,
    reps: np.ndarray,
    rep_labels: np.ndarray,
    num_clusters: int,
    max_cluster_size: int,
    num_extra_assignments: int,
    keep: int = 5,
    metric: Metric = "l2",
    block: int = 262144,
    admit_chunk: int = 4_000_000,
    *,
    device,
):
    """Large-base centroid-ranked overlap: global cheapest-first admission
    under per-cluster capacity (overlapping_partitioning.cpp:190-216
    semantics; admission is exact within each ``admit_chunk`` of the global
    distance order and capacity-consistent across chunks).

    Returns ``(extra_points [e], extra_clusters [e])`` — apply with
    :func:`apply_extra_assignments`."""
    assign = np.asarray(assign)
    od, oc = foreign_cluster_candidates(
        points, assign, reps, rep_labels, num_clusters, keep=keep,
        metric=metric, block=block, device=device)
    keep_eff = od.shape[1]
    flat_p = np.repeat(np.arange(points.shape[0], dtype=np.int64), keep_eff)
    flat_c = oc.reshape(-1)
    flat_d = od.reshape(-1)
    order = np.argsort(flat_d, kind="stable")
    sizes = np.bincount(assign, minlength=num_clusters).astype(np.int64)
    chosen_p, chosen_c = [], []
    left = int(num_extra_assignments)
    for s in range(0, len(order), admit_chunk):
        sl = order[s:s + admit_chunk]
        cs, ps = flat_c[sl], flat_p[sl]
        o2 = np.argsort(cs, kind="stable")
        cs_s, ps_s = cs[o2], ps[o2]
        first = np.searchsorted(cs_s, np.arange(num_clusters), side="left")
        rank = np.arange(len(cs_s)) - first[cs_s]
        admit = rank < np.maximum(max_cluster_size - sizes, 0)[cs_s]
        ps_a, cs_a = ps_s[admit], cs_s[admit]
        if len(ps_a) > left:
            keep_ix = np.argsort(o2[admit], kind="stable")[:left]
            ps_a, cs_a = ps_a[keep_ix], cs_a[keep_ix]
        chosen_p.append(ps_a)
        chosen_c.append(cs_a)
        np.add.at(sizes, cs_a, 1)
        left -= len(ps_a)
        if left <= 0:
            break
    if not chosen_p:
        return (np.empty(0, np.int64), np.empty(0, np.int32))
    return np.concatenate(chosen_p), np.concatenate(chosen_c)


def apply_extra_assignments(
    clusters: Clusters, extra_points: np.ndarray, extra_clusters: np.ndarray
) -> Clusters:
    """Clusters + the streamed overlap's extra assignments -> a Cover-style
    Clusters list (same return convention as make_overlapping_with_centroids)."""
    return [
        np.concatenate([np.asarray(c, np.int32),
                        extra_points[extra_clusters == b].astype(np.int32)])
        for b, c in enumerate(clusters)
    ]
