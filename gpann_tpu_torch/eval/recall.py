"""Ground truth, recall and oracle recall (counterpart of
``gpann_tpu/eval/recall.py``; reference ``src/recall.h``).

- :func:`compute_ground_truth` — exact kNN of the queries in the base
  (``recall.h:10-39``): bin-top-2 candidates (kernel B2 on a CUDA device),
  then an exact re-sort.
- :func:`kth_neighbor_distance` / :func:`verify_ground_truth` — recompute the
  distances of published GT ids, count mismatches at 10 tolerance levels and
  re-sort (``recall.h:74-137``).
- :func:`recall_from_candidate_distances` — recall@k counts returned points
  with ``dist <= d_k(q)`` (distance-threshold definition, ``recall.h:139-150``).
- :func:`recall_from_ids` — the same, with candidate distances recomputed
  exactly from ids.
- :func:`oracle_recall` / :func:`max_first_shard_routing_recall` — the best
  probe order from ground truth (``recall.h:41-68``) and the first-probe
  recall of a router's order (``routes.cpp:11-31``).

Inputs may be numpy arrays or torch tensors (moved to the host); the exact
distances are computed on the host in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from gpann_tpu_torch.core.distances import (
    Metric,
    chunked_topk_neighbors,
    to_device,
    topk_neighbors,
)
from gpann_tpu_torch.core.partition import Cover, Partition, cover_to_csr, csr_gather
from gpann_tpu_torch.search.bin_scan import BIN, fused_topk


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _exact_candidate_distances(base, queries, ids: np.ndarray,
                               metric: Metric) -> np.ndarray:
    """[m, c] exact f32 distances of ``base[ids]`` to each query."""
    m, c = ids.shape
    out = np.empty((m, c), dtype=np.float32)
    block = 2048
    for s in range(0, m, block):
        q = np.asarray(queries[s : s + block], np.float32)
        cand = np.asarray(base[ids[s : s + block].reshape(-1)],
                          np.float32).reshape(q.shape[0], c, -1)
        if metric == "mips":
            out[s : s + block] = 1.0 - np.einsum("qd,qkd->qk", q, cand)
        else:
            out[s : s + block] = ((q[:, None, :] - cand) ** 2).sum(-1)
    return out


def compute_ground_truth(base, queries, k: int, metric: Metric = "l2",
                         query_block: int = 4096, block_rows: int = 262144,
                         scan_oversample: int = 4, *, device
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN ids and distances of each query (reference
    ComputeGroundTruth). Returns numpy ``(ids [m, k] int32, dists [m, k] f32)``.

    Two phases, as ``bench.py:189-205``: the bin-top-2 scan
    (:func:`~gpann_tpu_torch.search.bin_scan.fused_topk`, kernel B2 on a CUDA
    ``device``, its plain version on the CPU) collects
    ``scan_oversample*k + 16`` candidates per query, and
    :func:`verify_ground_truth` recomputes their distances exactly on the host
    and re-sorts them. The scan keeps two rows per 128-row bin, so a true
    neighbour can only be missed behind two better rows of its own bin; those
    two are then both among the k found, so a query whose k found ids share
    a bin is rescanned exactly with :func:`topk_neighbors`. The result is
    exact either way.

    ``scan_oversample=0`` is the single-phase exact
    :func:`~gpann_tpu_torch.core.distances.chunked_topk_neighbors`.
    """
    n, m = base.shape[0], queries.shape[0]
    k_scan = min(scan_oversample * k + 16, n, 2 * (-(-n // BIN)))
    if scan_oversample <= 0 or k_scan < k:
        dists, ids = chunked_topk_neighbors(
            queries, base, k, metric=metric, query_block=query_block,
            block_rows=block_rows, device=device)
        return ids.astype(np.int32), dists.astype(np.float32)
    base_t = to_device(base, device)
    ids = np.empty((m, k_scan), np.int64)
    for s in range(0, m, query_block):
        q = to_device(queries[s : s + query_block], device)
        _, cand = fused_topk(q, base_t, n, k_scan, metric=metric)
        bins = (cand[:, :k].long() // BIN).sort(dim=1).values
        shared = (bins[:, 1:] == bins[:, :-1]).any(dim=1)
        if bool(shared.any()):
            rows = shared.nonzero()[:, 0]
            _, exact = topk_neighbors(q[rows], base_t, k_scan, metric=metric,
                                      block_rows=block_rows)
            cand[rows] = exact
        ids[s : s + q.shape[0]] = cand.cpu().numpy()
    sids, sdists = verify_ground_truth(base, queries, ids,
                                       np.full(ids.shape, np.nan), metric)
    return sids[:, :k].astype(np.int32), sdists[:, :k].astype(np.float32)


def kth_neighbor_distance(gt_dists, k: int) -> np.ndarray:
    """Distance to the k-th ground-truth neighbor, per query (recall.h:30-39)."""
    gt_dists = _host(gt_dists)
    if gt_dists.shape[1] < k:
        raise ValueError(f"ground truth has only {gt_dists.shape[1]} < k={k} columns")
    return gt_dists[:, k - 1].astype(np.float32)


def verify_ground_truth(base, queries, gt_ids, gt_dists, metric: Metric = "l2",
                        verbose: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Recompute the distances of published GT ids and repair ordering.

    Mirrors ``ConvertGroundTruthToDistanceToKthNeighbor`` (recall.h:74-137):
    distances are recomputed from the vectors, mismatches counted at 10
    tolerance levels, and each row re-sorted by recomputed distance.
    Returns (sorted ids, sorted recomputed dists).
    """
    gt_ids, gt_dists = _host(gt_ids), _host(gt_dists)
    recomputed = _exact_candidate_distances(_host(base), _host(queries),
                                            gt_ids, metric)
    if not np.all(np.isnan(gt_dists)):
        for i, eps in enumerate(10.0 ** -np.arange(1, 11)):
            mism = int((np.abs(recomputed - gt_dists) > eps).sum())
            if verbose:
                print(f"eps=1e-{i+1}: {mism} mismatches")
    order = np.argsort(recomputed, axis=1, kind="stable")
    return (np.take_along_axis(gt_ids, order, axis=1),
            np.take_along_axis(recomputed, order, axis=1))


def recall_from_candidate_distances(cand_dists, kth_dist, k: int,
                                    eps: float = 1e-5,
                                    rel_eps: float = 1e-4) -> float:
    """recall@k with the distance-threshold definition (recall.h:139-150).

    A candidate is a hit if its distance is within
    ``d_k(q) + eps + rel_eps*|d_k|``; at most k hits per query count.
    """
    cand_dists, kth_dist = _host(cand_dists), _host(kth_dist)
    thresh = kth_dist[:, None] + eps + rel_eps * np.abs(kth_dist[:, None])
    hits = (cand_dists <= thresh).sum(axis=1)
    return float(np.minimum(hits, k).sum()) / (k * len(kth_dist))


def recall_from_hit_counts(hit_counts: np.ndarray, k: int) -> float:
    return float(np.minimum(hit_counts, k).sum()) / (k * len(hit_counts))


def recall_from_ids(base, queries, cand_ids, kth_dist, k: int,
                    metric: Metric = "l2", eps: float = 1e-5) -> float:
    """recall@k with candidate distances recomputed exactly from ids.

    ``cand_ids`` may contain -1 padding. Duplicate ids in a row count once.
    ``base`` may be a numpy array or memmap; only the candidate rows are read.
    """
    cand_ids = _host(cand_ids)
    safe_ids = np.where(cand_ids < 0, 0, cand_ids)
    out = _exact_candidate_distances(_host(base), _host(queries), safe_ids,
                                     metric)
    out = np.where(cand_ids < 0, np.inf, out)
    # dedup ids per query: sort columns by id, mask all but the first copy
    ordix = np.argsort(cand_ids, axis=1, kind="stable")
    sids = np.take_along_axis(cand_ids, ordix, axis=1)
    dup_sorted = np.zeros_like(sids, dtype=bool)
    dup_sorted[:, 1:] = (sids[:, 1:] == sids[:, :-1]) & (sids[:, 1:] >= 0)
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, ordix, dup_sorted, axis=1)
    out = np.where(dup, np.inf, out)
    return recall_from_candidate_distances(out, _host(kth_dist), k, eps=eps)


def gt_shard_counts(gt_ids: np.ndarray, partition: Optional[Partition] = None,
                    cover: Optional[Cover] = None,
                    num_shards: Optional[int] = None) -> np.ndarray:
    """[nq, num_shards] — how many GT neighbors of each query live in each
    shard. With a cover (overlap) a neighbor counts in *every* shard holding
    it."""
    gt_ids = _host(gt_ids)
    nq, k = gt_ids.shape
    if partition is not None:
        partition = _host(partition)
        s = num_shards or int(partition.max()) + 1
        counts = np.zeros((nq, s), dtype=np.int32)
        shard_of = partition[gt_ids]  # [nq, k]
        for j in range(k):
            np.add.at(counts, (np.arange(nq), shard_of[:, j]), 1)
        return counts
    if cover is None:
        raise ValueError("pass a partition or a cover")
    s = num_shards or int(max((c.max() for c in cover if len(c)), default=-1)) + 1
    counts = np.zeros((nq, s), dtype=np.int32)
    indptr, indices = cover_to_csr(cover)
    owners, shards = csr_gather(indptr, indices, gt_ids.reshape(-1))
    np.add.at(counts, (owners // k, shards), 1)
    return counts


def oracle_recall(gt_ids: np.ndarray, partition: Optional[Partition] = None,
                  cover: Optional[Cover] = None,
                  num_shards: Optional[int] = None) -> np.ndarray:
    """Best-possible cumulative recall per #probes (recall.h:41-68).

    Probe shards in decreasing GT-neighbor count per query; with overlap each
    neighbor is counted once (greedy max coverage, oracle_recall.cpp:10-38).
    Returns the [num_shards] cumulative recall@k curve.
    """
    gt_ids = _host(gt_ids)
    nq, k = gt_ids.shape
    if cover is None:
        counts = gt_shard_counts(gt_ids, partition=partition,
                                 num_shards=num_shards)
        sorted_counts = -np.sort(-counts, axis=1)
        cum = np.cumsum(sorted_counts, axis=1)
        return cum.sum(axis=0) / (k * nq)
    # membership M[q, b, j] = "GT neighbor j of query q lives in shard b",
    # then s rounds of masked argmax
    s = num_shards or int(max((c.max() for c in cover if len(c)), default=-1)) + 1
    M = np.zeros((nq, s, k), dtype=bool)
    indptr, indices = cover_to_csr(cover)
    owners, shards = csr_gather(indptr, indices, gt_ids.reshape(-1))
    M[owners // k, shards, owners % k] = True
    covered = np.zeros((nq, k), dtype=bool)
    total = np.zeros(s, dtype=np.int64)
    rows = np.arange(nq)
    for probe in range(s):
        gains = (M & ~covered[:, None, :]).sum(axis=2)  # [nq, s]
        best = gains.argmax(axis=1)  # first max
        covered |= M[rows, best]
        total[probe] = int(covered.sum())
        M[rows, best] = False
    return total / (k * nq)


def max_first_shard_routing_recall(gt_ids: np.ndarray,
                                   probe_orders: Sequence[np.ndarray],
                                   partition: Partition) -> float:
    """Fraction of GT neighbors captured by the first probed shard
    (reference MaxFirstShardRoutingRecall, routes.cpp:11-31)."""
    gt_ids = _host(gt_ids)
    counts = gt_shard_counts(gt_ids, partition=partition)
    k = gt_ids.shape[1]
    first = np.asarray([po[0] for po in probe_orders])
    return float(counts[np.arange(len(first)), first].sum()) / (k * len(first))
