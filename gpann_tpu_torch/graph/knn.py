"""kNN-graph construction: exact oracle + approximate leader-sketching builder
(counterpart of ``gpann_tpu/graph/knn.py``; reference ``src/knn_graph.h``).

- :func:`build_exact_knn_graph` — O(n^2) oracle (``knn_graph.h:30-34``).
- :class:`ApproximateKNNGraphBuilder` — REPETITIONS x recursive leader
  sketching (``knn_graph.h:52-143``), then brute force inside each bucket
  and a per-point top-k merge with dedup (``:165-250``). Tuning constants
  mirror ``knn_graph.h:254-265``.

Graphs are dense ``[n, num_neighbors]`` int32 arrays. The leader assignment
(distance matmul + top-fanout), the bucket all-pairs (batched matmul +
top-k) and the global merge's sorts run on the builder's device; the
recursion stays on the host. Randomness is ``np.random.default_rng`` exactly where the JAX
package draws it, so both builders pick the same leaders.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from gpann_tpu_torch.core.distances import (
    Metric,
    chunked_topk_neighbors,
    pairwise_distances,
    sq_norms,
    to_device,
    topk_smallest,
)

Graph = np.ndarray  # [n, num_neighbors] int32 neighbor ids

log = logging.getLogger(__name__)

# device bytes one batch of [cap, cap] bucket tiles may peak at, budgeted as
# 12 bytes an entry (see _crunch_group)
CRUNCH_BATCH_BYTES = 3 << 30
LEADER_ROWS = 1 << 16  # points matched against the leaders per step


def build_exact_knn_graph(points: np.ndarray, num_neighbors: int,
                          metric: Metric = "l2", block_rows: int = 65536,
                          query_block: int = 8192, *, device) -> Graph:
    """Exact kNN graph (oracle; reference BuildExactKNNGraph, knn_graph.h:30-34)."""
    _, ids = chunked_topk_neighbors(
        points, points, num_neighbors + 1, metric=metric,
        query_block=query_block, block_rows=block_rows, device=device)
    return _drop_self(ids, num_neighbors)


def _drop_self(ids: np.ndarray, k: int) -> np.ndarray:
    """Remove each point's self-match from a top-(k+1) list (order preserved)."""
    is_self = ids == np.arange(ids.shape[0])[:, None]
    push_back = np.argsort(is_self, axis=1, kind="stable")  # self (True) last
    return np.take_along_axis(ids, push_back, axis=1)[:, :k].astype(np.int32)


def _crunch_group(bucket_points: torch.Tensor, bucket_sizes: torch.Tensor,
                  k: int, metric: Metric) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs top-k inside each padded bucket of one batch.

    bucket_points [nb, cap, d]; returns (dists [nb, cap, k], local ids).
    Rows and columns past a bucket's size, and the diagonal (no self edges,
    knn_graph.h:172), are masked to +inf. Bytes an entry of the [nb, cap,
    cap] tile: 8 while it is built (the f32 product and the f32 tile), 10 in
    the top-k (the tile, two bool masks and int32 ranks of
    :func:`~gpann_tpu_torch.core.distances.topk_smallest`)."""
    nb, cap, _ = bucket_points.shape
    dev = bucket_points.device
    dots = torch.bmm(bucket_points, bucket_points.transpose(1, 2))
    if metric == "mips":
        dm = dots.neg_().add_(1.0)
    else:
        sq = sq_norms(bucket_points)
        dm = (sq[:, :, None] + sq[:, None, :]).sub_(dots.mul_(2.0))
        del dots
    pos = torch.arange(cap, device=dev)
    valid = pos[None, :] < bucket_sizes[:, None]                     # [nb, cap]
    dm.masked_fill_(~(valid[:, :, None] & valid[:, None, :]), torch.inf)
    dm.masked_fill_((pos[:, None] == pos[None, :])[None], torch.inf)
    # equal distances to the lowest local id, as the JAX package's
    # lax.top_k: byte data ties often (ROADMAP C12)
    return topk_smallest(dm, k)


def _lexsort(keys) -> torch.Tensor:
    """``np.lexsort(keys)`` for 1-D tensors on their device: the last key
    sorts first, ties go to the keys before it, full ties keep their
    order. Stable sorts from the first key to the last."""
    order = None
    for key in keys:
        k = key if order is None else key[order]
        step = torch.sort(k, stable=True).indices
        order = step if order is None else order[step]
    return order


class ApproximateKNNGraphBuilder:
    """Recursive leader-sketching approximate kNN-graph builder."""

    # tuning constants: parity with knn_graph.h:254-265
    FRACTION_LEADERS = 0.005
    TOP_LEVEL_NUM_LEADERS = 950
    MAX_NUM_LEADERS = 1500
    MAX_CLUSTER_SIZE = 5000
    MIN_CLUSTER_SIZE = 50
    MAX_MERGED_CLUSTER_SIZE = 2500
    REPETITIONS = 3
    FANOUT = 3
    MAX_DEPTH = 14
    CONCERNING_DEPTH = 10
    TOO_SMALL_SHRINKAGE_FRACTION = 0.8

    def __init__(self, metric: Metric = "l2", seed: int = 555,
                 quiet: bool = True, strong: bool = False, *, device):
        self.metric: Metric = metric
        self.seed = seed
        self.quiet = quiet
        self.device = torch.device(device)
        if strong:  # GraphPartitioning 'strong' preset (partitioning.cpp:253-257)
            self.FANOUT = 5
            self.REPETITIONS = 5

    # -- sketching ------------------------------------------------------------
    def _closest_leaders(self, points: torch.Tensor, ids: np.ndarray,
                         leaders: np.ndarray, fanout: int) -> np.ndarray:
        """[len(ids), fanout] leader indices (into ``leaders``) per point,
        equal distances to the lowest index (C12); ``points`` is the whole
        set, resident on the device."""
        lead = points[torch.as_tensor(leaders).to(self.device)]
        k = min(fanout, len(leaders))
        out = []
        for s in range(0, len(ids), LEADER_ROWS):
            sel = torch.as_tensor(ids[s : s + LEADER_ROWS]).to(self.device)
            dm = pairwise_distances(points[sel], lead, self.metric)
            out.append(topk_smallest(dm, k)[1].cpu().numpy())
        return np.concatenate(out).astype(np.int32)

    def _sketch(self, points: torch.Tensor, ids: np.ndarray, depth: int,
                fanout: int, rng: np.random.Generator) -> List[np.ndarray]:
        if len(ids) <= self.MAX_CLUSTER_SIZE:
            return [ids]
        num_leaders = (self.TOP_LEVEL_NUM_LEADERS if depth == 0
                       else int(len(ids) * self.FRACTION_LEADERS))
        num_leaders = max(4, min(num_leaders, self.MAX_NUM_LEADERS))
        # the JAX package rounds the leader count up to a power of two (a
        # sampling-size heuristic, knn_graph.h:62-67); kept, so that both
        # packages draw the same leaders
        num_leaders = 1 << (num_leaders - 1).bit_length()
        num_leaders = min(num_leaders, len(ids))
        leaders = rng.choice(ids, size=num_leaders, replace=False)

        closest = self._closest_leaders(points, ids, leaders, fanout)
        fanout_eff = closest.shape[1]
        # group points by leader (parlay group_by_index, knn_graph.h:83)
        flat_leader = closest.reshape(-1)
        flat_point = np.repeat(ids, fanout_eff)
        order = np.argsort(flat_leader, kind="stable")
        sorted_leader = flat_leader[order]
        sorted_point = flat_point[order]
        boundaries = np.searchsorted(sorted_leader, np.arange(num_leaders + 1))
        clusters = [sorted_point[boundaries[i] : boundaries[i + 1]]
                    for i in range(num_leaders)]

        # sort by size desc; merge small trailing clusters (knn_graph.h:100-112)
        clusters.sort(key=len, reverse=True)
        buckets: List[np.ndarray] = []
        merged: List[np.ndarray] = []
        merged_size = 0
        while clusters and len(clusters[-1]) < self.MIN_CLUSTER_SIZE:
            c = clusters.pop()
            if merged and merged_size + len(c) > self.MAX_MERGED_CLUSTER_SIZE:
                buckets.append(np.concatenate(merged))
                merged, merged_size = [], 0
            merged.append(c)
            merged_size += len(c)
        if merged:
            buckets.append(np.concatenate(merged))

        for cluster in clusters:
            if depth > self.MAX_DEPTH or (
                depth > self.CONCERNING_DEPTH
                and len(cluster) > self.TOO_SMALL_SHRINKAGE_FRACTION * len(ids)
            ):
                # near-duplicate base case: random split (knn_graph.h:120-130)
                shuffled = rng.permutation(cluster)
                for s in range(0, len(shuffled), self.MAX_CLUSTER_SIZE):
                    buckets.append(shuffled[s : s + self.MAX_CLUSTER_SIZE])
            else:
                buckets.extend(self._sketch(points, cluster, depth + 1, 1, rng))
        return buckets

    # -- bucket brute force ----------------------------------------------------
    def _crunch_buckets(self, points: torch.Tensor, buckets: List[np.ndarray],
                        num_neighbors: int) -> Graph:
        """Batched all-pairs within buckets + global per-point top-k merge with
        dedup (reference BruteForceBuckets, knn_graph.h:187-250).

        Buckets are grouped into power-of-two capacity classes and crunched
        in batches that peak at ``CRUNCH_BATCH_BYTES`` (and at most 64
        buckets). The merge sorts every candidate edge on the device
        (``_lexsort``).
        """
        t0 = time.perf_counter()
        n = points.shape[0]
        k = num_neighbors
        groups: dict[int, List[np.ndarray]] = {}
        for b in buckets:
            if len(b) < 2:
                continue
            cap = 1 << max(int(np.ceil(np.log2(len(b)))), 5)
            groups.setdefault(cap, []).append(b)

        src_list: List[np.ndarray] = []
        dst_list: List[np.ndarray] = []
        dist_list: List[np.ndarray] = []
        for cap, bs in sorted(groups.items()):
            per_batch = max(1, min(64, CRUNCH_BATCH_BYTES // (12 * cap * cap)))
            kk = min(k, cap - 1)
            for s in range(0, len(bs), per_batch):
                chunk = bs[s : s + per_batch]
                sizes = np.asarray([len(b) for b in chunk])
                # rows of each bucket, padded with row 0 (masked in the tile)
                rows = np.zeros((len(chunk), cap), np.int64)
                for j, b in enumerate(chunk):
                    rows[j, : len(b)] = b
                rows_t = torch.as_tensor(rows).to(self.device)
                d, li = _crunch_group(points[rows_t],
                                      torch.as_tensor(sizes).to(self.device),
                                      kk, self.metric)
                d, li = d.cpu().numpy(), li.cpu().numpy()
                for j, b in enumerate(chunk):
                    sz = len(b)
                    kv = min(kk, sz - 1)
                    src_list.append(np.repeat(b, kv))
                    dst_list.append(b[li[j, :sz, :kv].reshape(-1)])
                    dist_list.append(d[j, :sz, :kv].reshape(-1))
        t1 = time.perf_counter()

        def edges(parts):
            return torch.from_numpy(np.concatenate(parts)).to(self.device)

        src, dst, dist = edges(src_list), edges(dst_list), edges(dist_list)
        num_edges = len(src)
        # global merge on the device: per point, dedup neighbors, keep k
        # smallest (replaces the reference's per-point spinlock merge,
        # knn_graph.h:221-234; the JAX package's host lexsort, same order)
        order = _lexsort((dist, dst, src))
        src, dst, dist = src[order], dst[order], dist[order]
        first = torch.ones(len(src), dtype=torch.bool, device=self.device)
        first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst, dist = src[first], dst[first], dist[first]
        order = _lexsort((dist, src))
        src, dst = src[order].cpu().numpy(), dst[order].cpu().numpy()
        del dist, order, first
        starts = np.searchsorted(src, np.arange(n + 1))
        graph = np.full((n, k), -1, dtype=np.int32)
        rank = np.arange(len(src)) - starts[src]
        keep = rank < k
        graph[src[keep], rank[keep]] = dst[keep]
        # fill ragged tails by repeating the closest neighbor; fully isolated
        # points (never in a >=2 bucket) fall back to a non-self neighbor id
        bad = graph < 0
        if bad.any():
            fallback = (np.arange(n, dtype=np.int32) + 1) % max(n, 1)
            first_col = np.where(graph[:, 0] >= 0, graph[:, 0], fallback)
            graph = np.where(bad, first_col[:, None], graph)
        log.info("knn crunch: %d buckets in %.3f s; merge of %d edges in %.3f s",
                 sum(len(bs) for bs in groups.values()), t1 - t0, num_edges,
                 time.perf_counter() - t1)
        return graph

    def build(self, points: np.ndarray, num_neighbors: int) -> Graph:
        """Reference BuildApproximateNearestNeighborGraph (knn_graph.h:145-162)."""
        t0 = time.perf_counter()
        points = np.ascontiguousarray(points, dtype=np.float32)
        n = points.shape[0]
        pts = to_device(points, self.device)
        all_ids = np.arange(n, dtype=np.int64)
        buckets: List[np.ndarray] = []
        for rep in range(self.REPETITIONS):
            rng = np.random.default_rng(self.seed + rep)
            buckets.extend(self._sketch(pts, all_ids, 0, self.FANOUT, rng))
            if not self.quiet:
                print(f"sketching rep {rep}: {len(buckets)} buckets so far")
        log.info("knn sketch: %d points, %d buckets in %.3f s", n,
                 len(buckets), time.perf_counter() - t0)
        return self._crunch_buckets(pts, buckets, num_neighbors)


def symmetrize_to_csr(graph: Graph, n: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense [n,k] kNN graph -> symmetrized CSR (indptr, indices, edge_weights).

    Duplicate directed edges collapse with weight = multiplicity (an edge
    confirmed both ways weighs 2), mirroring the union semantics of the
    reference's Symmetrize (knn_graph.h:272-283) while keeping the extra
    signal as an edge weight for the partitioner.
    """
    n = n or graph.shape[0]
    k = graph.shape[1]
    u = np.repeat(np.arange(n, dtype=np.int64), k)
    v = graph.reshape(-1).astype(np.int64)
    valid = (v >= 0) & (v != u)
    u, v = u[valid], v[valid]
    uu = np.concatenate([u, v])
    vv = np.concatenate([v, u])
    key = uu * n + vv
    key, counts = np.unique(key, return_counts=True)
    uu = (key // n).astype(np.int32)
    vv = (key % n).astype(np.int32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(uu, minlength=n), out=indptr[1:])
    return indptr, vv, counts.astype(np.float32)


def graph_recall(approx: Graph, exact: Graph) -> float:
    """Fraction of exact kNN edges recovered (graph_quality_benchmark.cpp:53-66).

    Both neighbor lists sorted per row, then a row-wise lookup of the rank of
    each approximate neighbor in its exact row (no per-node Python loop)."""
    n, k = exact.shape
    ex = np.sort(exact, axis=1)
    hits = 0
    for c in range(approx.shape[1]):
        col = approx[:, c : c + 1]
        pos = np.clip((ex < col).sum(axis=1), 0, k - 1)
        hits += int((np.take_along_axis(ex, pos[:, None], axis=1)[:, 0]
                     == col[:, 0]).sum())
    return hits / (n * k)
