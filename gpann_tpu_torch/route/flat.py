"""Flat routing-point router: exact top-T scan + the 4 probe-ranking rules
(counterpart of ``gpann_tpu/route/flat.py``; reference ``src/hnsw_router.h``).

The reference walks an hnswlib graph over the routing points, folds the
returned neighbors into per-shard ``min_dist`` and ``frequency``
(``hnsw_router.h:106-119``) and ranks shards with one of four rules:

- ``RoutingQuery``  — all shards sorted by min distance (``:59-64``).
- ``PyramidRoutingQuery`` — only shards seen among the neighbors (``:66-74``).
- ``SPANNRoutingQuery``   — shards within ``(1+eps) * d_closest`` (``:76-85``).
- ``FrequencyQuery``      — shards by vote frequency (``:87-103``).

As in the JAX package, the graph walk is an exact top-T scan of the routing
points (fp32 matmul + top-k on the router's device); the rules are numpy on
the folded votes. Probe orders use -1 padding where a rule cuts the list
short.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpann_tpu_torch.core.distances import Metric, to_device, topk_neighbors


def _fold_votes(neigh_dists: torch.Tensor, neigh_shards: torch.Tensor,
                num_shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query per-shard (min_dist, frequency) from the top-T neighbor list
    (reference hnsw_router.h:106-119)."""
    m = neigh_dists.shape[0]
    dev = neigh_dists.device
    shards = neigh_shards.long()
    min_d = torch.full((m, num_shards), torch.inf, device=dev).scatter_reduce_(
        1, shards, neigh_dists, reduce="amin")
    freq = torch.zeros((m, num_shards), dtype=torch.int32, device=dev)
    freq.scatter_add_(1, shards, torch.ones_like(shards, dtype=torch.int32))
    return min_d, freq


def rank_min_dist(min_d: np.ndarray) -> np.ndarray:
    """All shards by min distance; unseen (inf) shards trail (hnsw_router.h:59-64)."""
    return np.argsort(min_d, axis=1, kind="stable").astype(np.int32)


def rank_pyramid(min_d: np.ndarray) -> np.ndarray:
    """Only shards seen among the neighbors (hnsw_router.h:66-74); -1 padded,
    in min-dist order (the reference consumes the list as a set)."""
    order = np.argsort(min_d, axis=1, kind="stable").astype(np.int32)
    seen = np.isfinite(np.take_along_axis(min_d, order, axis=1))
    return np.where(seen, order, -1)


def rank_spann(min_d: np.ndarray, eps: float = 0.6) -> np.ndarray:
    """Shards with min_dist <= (1+eps)*closest (hnsw_router.h:76-85); -1
    padded, in min-dist order."""
    order = np.argsort(min_d, axis=1, kind="stable").astype(np.int32)
    sorted_d = np.take_along_axis(min_d, order, axis=1)
    closest = sorted_d[:, :1]
    keep = sorted_d <= (1.0 + eps) * closest
    keep &= np.isfinite(sorted_d)
    return np.where(keep, order, -1)


def rank_frequency(freq: np.ndarray, min_d: np.ndarray) -> np.ndarray:
    """Reference FrequencyQuery (hnsw_router.h:87-103): ONLY the single
    highest-frequency shard goes first (ties -> lowest index); every
    remaining shard — seen or not — is ordered by min_dist."""
    m, s = freq.shape
    finite_d = np.where(np.isfinite(min_d), min_d, np.float64(3e38))
    top = np.argmax(freq, axis=1)
    key = finite_d.copy()
    key[np.arange(m), top] = -np.inf
    return np.argsort(key, axis=1, kind="stable").astype(np.int32)


class FlatRouter:
    """Routing points + shard labels resident on ``device``; exact top-T
    scan + 4 ranking rules."""

    def __init__(self, routing_points: np.ndarray, shard_labels: np.ndarray,
                 num_shards: Optional[int] = None, metric: Metric = "l2", *,
                 device) -> None:
        self.device = torch.device(device)
        self.points = to_device(np.asarray(routing_points, np.float32),
                                self.device)
        self.labels_np = np.asarray(shard_labels, np.int32)
        self.labels = torch.as_tensor(self.labels_np.astype(np.int64)).to(
            self.device)
        self.num_shards = int(num_shards or self.labels_np.max() + 1)
        self.metric: Metric = metric

    def __len__(self) -> int:
        return int(self.points.shape[0])

    def query_votes(self, queries: np.ndarray, num_voting_neighbors: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-query per-shard (min_dist [m, s], frequency [m, s])."""
        t = min(num_voting_neighbors, len(self))
        dists, ids = topk_neighbors(to_device(queries, self.device),
                                    self.points, t, metric=self.metric)
        min_d, freq = _fold_votes(dists, self.labels[ids.long()],
                                  self.num_shards)
        return min_d.cpu().numpy(), freq.cpu().numpy()

    def query(self, queries: np.ndarray, num_voting_neighbors: int = 120,
              rule: str = "min_dist", spann_eps: float = 0.6) -> np.ndarray:
        """Probe order [m, s] (possibly -1-padded) under the given rule."""
        min_d, freq = self.query_votes(queries, num_voting_neighbors)
        if rule == "min_dist":
            return rank_min_dist(min_d)
        if rule == "pyramid":
            return rank_pyramid(min_d)
        if rule == "spann":
            return rank_spann(min_d, eps=spann_eps)
        if rule == "frequency":
            return rank_frequency(freq, min_d)
        raise ValueError(f"unknown probe rule {rule!r}")

    # -- persistence: the JAX package's .npz sidecar format -------------------
    def save(self, path: str) -> None:
        np.savez(path, points=self.points.cpu().numpy(), labels=self.labels_np,
                 num_shards=self.num_shards, metric=self.metric)

    @classmethod
    def load(cls, path: str, *, device) -> "FlatRouter":
        z = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=False)
        return cls(z["points"], z["labels"], int(z["num_shards"]),
                   str(z["metric"]), device=device)


def centroid_router(points: np.ndarray, clusters, metric: Metric = "l2", *,
                    device) -> FlatRouter:
    """One centroid per shard — the reference's single-center routing baseline
    (analyze_approximation_losses.cpp:92-142)."""
    cents = np.stack([
        np.asarray(points[np.asarray(c, np.int64)]).mean(axis=0)
        if len(c) else np.zeros(points.shape[1], np.float32)
        for c in clusters
    ]).astype(np.float32)
    if metric == "mips":
        norms = np.sqrt(np.maximum((cents**2).sum(1), 1e-12))
        cents = cents / norms[:, None]
    labels = np.arange(len(clusters), dtype=np.int32)
    return FlatRouter(cents, labels, num_shards=len(clusters), metric=metric,
                      device=device)
