"""K-means-tree router: budgeted hierarchical k-means per shard (counterpart
of ``gpann_tpu/route/kmeans_tree.py``; reference
``src/kmeans_tree_router.{h,cpp}``).

- ``Train`` (``kmeans_tree_router.cpp:9-33``): per shard, a hierarchical
  k-means tree under a global *size budget* split across shards in
  proportion to cluster sizes; recursion (``:35-78``) with at most
  ``num_centroids`` children per node; children below ``min_cluster_size``
  or with no budget left become leaves.
- ``ExtractPoints`` (``:174-201``): all centroids + shard labels as one
  routing point set.
- ``Query``/``FrequencyQuery`` (``:93-172``): as in the JAX package, an exact
  scan of the extracted centroids (:class:`FlatRouter`), plus the budgeted
  variant that admits whole top-level subtrees while they fit the
  distance-computation budget.

The host runs the recursion; every node's k-means runs on the router's
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from gpann_tpu_torch.cluster.kmeans import kmeans
from gpann_tpu_torch.core.distances import (
    Metric,
    pairwise_distances,
    to_device,
    topk_neighbors,
)
from gpann_tpu_torch.core.partition import Clusters
from gpann_tpu_torch.route.flat import FlatRouter, rank_frequency, rank_min_dist


def _budgeted_votes(queries, points, labels, group_of, top_index, group_sizes,
                    *, t: int, num_shards: int, metric: Metric, budget: int):
    """Capped-descent vote fold on device tensors: top-level scan -> greedy
    subtree admission under the distance-computation budget -> top-t votes
    masked to admitted subtrees (kmeans_tree_router.cpp:93-130 semantics).
    Returns (min_d [m, s], freq [m, s], distance comps per query [m])."""
    m = queries.shape[0]
    g = top_index.shape[0]
    dev = queries.device
    dm_top = pairwise_distances(queries, points[top_index], metric)
    order = torch.argsort(dm_top, dim=1, stable=True)
    costs = group_sizes[order]                       # [m, g]
    cum = torch.cumsum(costs, dim=1)
    remaining = max(budget - g, 0)
    # admit whole subtrees in top-centroid distance order while they fit;
    # always admit at least the nearest subtree
    sel_sorted = cum <= torch.clamp(cum[:, :1], min=remaining)
    sel = torch.zeros((m, g), dtype=torch.bool, device=dev).scatter_(
        1, order, sel_sorted)
    calcs = g + torch.where(sel_sorted, costs, 0).sum(dim=1)
    dists, ids = topk_neighbors(queries, points, t, metric=metric)
    ids = ids.long()
    keep = sel.gather(1, group_of[ids])
    vd = torch.where(keep, dists, torch.inf)
    vs = torch.where(keep, labels[ids], num_shards)  # dummy slot for dropped
    min_d = torch.full((m, num_shards + 1), torch.inf, device=dev)
    min_d.scatter_reduce_(1, vs, vd, reduce="amin")
    freq = torch.zeros((m, num_shards + 1), dtype=torch.int32, device=dev)
    freq.scatter_add_(1, vs, keep.to(torch.int32))
    return min_d[:, :num_shards], freq[:, :num_shards], calcs


@dataclass
class KMeansTreeRouterOptions:
    """Defaults match reference ``kmeans_tree_router.h:6-11`` exactly
    (num_centroids=64, min_cluster_size=250, budget=50000,
    search_budget=50000). ``search_budget`` caps the distance comps of
    :meth:`KMeansTreeRouter.query_budgeted`; the plain
    :meth:`KMeansTreeRouter.query` scans every extracted centroid."""

    num_centroids: int = 64
    min_cluster_size: int = 250
    budget: int = 50_000
    search_budget: int = 50_000


class KMeansTreeRouter:
    """Budgeted hierarchical k-means router over a clustering, resident on
    ``device``."""

    def __init__(self, metric: Metric = "l2", *, device) -> None:
        self.metric: Metric = metric
        self.device = torch.device(device)
        self.points: Optional[np.ndarray] = None  # extracted centroids [R, d]
        self.labels: Optional[np.ndarray] = None  # shard ids [R]
        self._flat: Optional[FlatRouter] = None
        self.num_shards = 0

    # -- training -------------------------------------------------------------
    def train(self, points: np.ndarray, clusters: Clusters,
              options: KMeansTreeRouterOptions = KMeansTreeRouterOptions(),
              seed: int = 555) -> "KMeansTreeRouter":
        points = np.ascontiguousarray(points, dtype=np.float32)
        n_total = sum(len(c) for c in clusters)
        all_centroids: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        all_groups: List[np.ndarray] = []
        group_offset = 0
        for shard, members in enumerate(clusters):
            members = np.asarray(members, dtype=np.int64)
            if len(members) == 0:
                continue
            # budget split proportional to cluster size (kmeans_tree_router.cpp:20-27)
            budget_i = max(
                1, int(round(options.budget * len(members) / max(n_total, 1))))
            cents, groups = self._train_shard(points[members], budget_i,
                                              options, seed + shard)
            all_centroids.append(cents)
            all_labels.append(np.full(len(cents), shard, dtype=np.int32))
            all_groups.append(groups + group_offset)
            group_offset += int(groups.max()) + 1 if len(groups) else 0
        group_of = np.concatenate(all_groups)
        # top_index[g] = the first centroid emitted with group id g (the
        # worklist emits each top-level centroid before its subtree)
        first = np.full(group_offset, -1, np.int64)
        rev = np.arange(len(group_of))[::-1]
        first[group_of[rev]] = rev
        if (first < 0).any():
            raise RuntimeError("a subtree has no top-level centroid")
        return self._set(np.concatenate(all_centroids, axis=0),
                         np.concatenate(all_labels, axis=0), group_of, first,
                         len(clusters), options.search_budget)

    @classmethod
    def from_arrays(cls, points: np.ndarray, labels: np.ndarray,
                    group_of: np.ndarray, top_index: np.ndarray,
                    num_shards: int, metric: Metric = "l2",
                    search_budget: int = 50_000, *,
                    device) -> "KMeansTreeRouter":
        """A trained router from another router's arrays (numpy): the
        extracted points and labels, ``group_of`` (top-level subtree of each
        point) and ``top_index`` (the point that heads each subtree)."""
        router = cls(metric, device=device)
        return router._set(np.asarray(points, np.float32),
                           np.asarray(labels, np.int32),
                           np.asarray(group_of, np.int64),
                           np.asarray(top_index, np.int64), num_shards,
                           search_budget)

    def _set(self, points, labels, group_of, top_index, num_shards,
             search_budget) -> "KMeansTreeRouter":
        self.points, self.labels = points, labels
        self.group_of, self.top_index = group_of, top_index
        self.num_shards = int(num_shards)
        self.search_budget = search_budget
        self._flat = FlatRouter(points, labels, num_shards=self.num_shards,
                                metric=self.metric, device=self.device)
        return self

    def _train_shard(self, pts: np.ndarray, budget: int,
                     options: KMeansTreeRouterOptions,
                     seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host-orchestrated recursion (kmeans_tree_router.cpp:35-78) via an
        explicit worklist; returns (extracted centroids, top-level subtree id
        per centroid) for this shard. Subtree ids are local (0-based)."""
        out: List[np.ndarray] = []
        out_groups: List[np.ndarray] = []
        next_group = 0
        # (points of node, remaining budget, seed, subtree id or None=root)
        work: List[Tuple[np.ndarray, int, int, Optional[int]]] = [
            (pts, budget, seed, None)]
        while work:
            node_pts, node_budget, node_seed, group = work.pop()
            if node_budget <= 0 or len(node_pts) <= 1:
                continue
            k = int(min(options.num_centroids, node_budget, len(node_pts)))
            cents, assign = kmeans(node_pts, k=k, metric=self.metric,
                                   seed=node_seed, device=self.device)
            sizes = np.bincount(assign, minlength=k)
            live = sizes > 0
            cents = cents[live]
            out.append(cents.astype(np.float32))
            if group is None:
                # each top-level centroid starts its own subtree
                child_groups = np.arange(next_group, next_group + len(cents))
                next_group += len(cents)
            else:
                child_groups = np.full(len(cents), group, np.int64)
            out_groups.append(child_groups.astype(np.int64))
            remaining = node_budget - len(cents)
            if remaining <= 0:
                continue
            # children get budget proportional to size; below min_cluster_size
            # they stay leaves (kmeans_tree_router.cpp:58-74)
            total = int(sizes.sum())
            for ci, c in enumerate(np.nonzero(live)[0]):
                if sizes[c] < options.min_cluster_size:
                    continue
                child_budget = int(round(remaining * sizes[c] / max(total, 1)))
                if child_budget <= 0:
                    continue
                work.append((node_pts[assign == c], child_budget,
                             node_seed * 31 + ci + 1, int(child_groups[ci])))
        if not out:
            # degenerate: single representative (mean)
            return (pts.mean(axis=0, keepdims=True).astype(np.float32),
                    np.zeros(1, np.int64))
        return np.concatenate(out, axis=0), np.concatenate(out_groups)

    # -- extraction + queries --------------------------------------------------
    def extract_points(self) -> Tuple[np.ndarray, np.ndarray]:
        """(routing points, shard labels) — reference ExtractPoints
        (kmeans_tree_router.cpp:174-201)."""
        if self.points is None:
            raise RuntimeError("router not trained")
        return self.points, self.labels

    @property
    def flat(self) -> FlatRouter:
        if self._flat is None:
            raise RuntimeError("router not trained")
        return self._flat

    def query(self, queries: np.ndarray, search_budget: int = 5_000) -> np.ndarray:
        """Probe order [m, s]: shards by min extracted-centroid distance over
        the top ``search_budget`` centroids (the budget -> exact limit of
        reference Query, kmeans_tree_router.cpp:93-130)."""
        t = int(min(search_budget, len(self.flat)))
        min_d, _ = self.flat.query_votes(queries, t)
        return rank_min_dist(min_d)

    def frequency_query(self, queries: np.ndarray,
                        num_voting_neighbors: int = 120) -> np.ndarray:
        """Probe order by centroid vote frequency (FrequencyQuery,
        kmeans_tree_router.cpp:132-172)."""
        min_d, freq = self.flat.query_votes(queries, num_voting_neighbors)
        return rank_frequency(freq, min_d)

    # -- budgeted tree-walk analog ---------------------------------------------
    def budgeted_votes(self, queries: np.ndarray, search_budget: int,
                       num_voting_neighbors: int = 500
                       ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Capped-descent votes: (min_d [m, s], freq [m, s], mean distance
        comps per query).

        Per query: scan every top-level centroid (one per subtree), admit
        whole subtrees in increasing top-centroid distance while the running
        centroid count fits ``search_budget``, and let only admitted
        subtrees' centroids vote (the visibility of the reference's
        best-first walk, ``kmeans_tree_router.cpp:93-130``).
        """
        if self._flat is None:
            raise RuntimeError("router not trained")
        g = len(self.top_index)
        dev = self.device
        sizes = np.bincount(self.group_of, minlength=g)
        t = int(min(num_voting_neighbors, len(self.flat)))
        min_d, freq, calcs = _budgeted_votes(
            to_device(queries, dev), self.flat.points, self.flat.labels,
            torch.as_tensor(self.group_of).to(dev),
            torch.as_tensor(self.top_index).to(dev),
            torch.as_tensor(sizes).to(dev),
            t=t, num_shards=self.num_shards, metric=self.metric,
            budget=int(search_budget))
        return (min_d.cpu().numpy(), freq.cpu().numpy(),
                float(calcs.double().mean()))

    def query_budgeted(self, queries: np.ndarray,
                       search_budget: Optional[int] = None) -> np.ndarray:
        """Budget-capped probe order by min admitted-centroid distance —
        the reference Query's semantics (kmeans_tree_router.cpp:93-130)."""
        budget = self.search_budget if search_budget is None else search_budget
        min_d, _, _ = self.budgeted_votes(queries, budget)
        return rank_min_dist(min_d)

    def frequency_query_budgeted(self, queries: np.ndarray,
                                 num_voting_neighbors: int = 120,
                                 search_budget: Optional[int] = None
                                 ) -> np.ndarray:
        """Budget-capped frequency probe order (FrequencyQuery,
        kmeans_tree_router.cpp:132-172: same walk, vote fold over the top
        ``num_voting_neighbors`` admitted centroids)."""
        budget = self.search_budget if search_budget is None else search_budget
        min_d, freq, _ = self.budgeted_votes(
            queries, budget, num_voting_neighbors=num_voting_neighbors)
        return rank_frequency(freq, min_d)
