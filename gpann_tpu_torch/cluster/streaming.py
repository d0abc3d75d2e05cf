"""Streaming clustering for bases larger than device memory (counterpart of
``gpann_tpu/cluster/streaming.py``).

Host-resident (numpy or memmap) points go through the device in row chunks:

- :func:`streaming_kmeans` — Lloyd with per-chunk assignment and sums on the
  device, accumulated across chunks on the host (``kmeans.cpp:151-204``).
- :func:`capacity_stream_assign` — every point to the part of its nearest
  OPEN representative under per-part capacity ``(1+eps)*ceil(n/k)``, with
  retry rounds (the Pyramid assignment rule, ``partitioning.cpp:305-356``).
- :func:`streaming_capacity_partition` — Lloyd centroids, then the capacity
  assignment.

Chunks are not padded: the last one is simply shorter.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpann_tpu_torch.cluster.kmeans import _segment_sum
from gpann_tpu_torch.core.distances import Metric, pairwise_distances, to_device


def _masked_nearest(chunk: torch.Tensor, centroids: torch.Tensor,
                    open_mask: torch.Tensor, metric: Metric = "l2"):
    """(nearest OPEN centroid int32, its distance) per row, on the device;
    only [m] ids and distances need to come back, not the [m, k] matrix."""
    dm = pairwise_distances(chunk, centroids, metric)
    dm.masked_fill_(~open_mask[None, :], torch.inf)
    tgt = dm.argmin(dim=1)
    return tgt.to(torch.int32), dm.gather(1, tgt[:, None])[:, 0]


def _chunk_stats(chunk: torch.Tensor, centroids: torch.Tensor, k: int,
                 metric: Metric):
    """(per-centroid sums [k, d], counts [k], assignment int32) of a chunk."""
    assign = pairwise_distances(chunk, centroids, metric).argmin(dim=1)
    sums = _segment_sum(chunk, assign, k, torch.float32)
    counts = torch.bincount(assign, minlength=k).float()
    return sums, counts, assign.to(torch.int32)


def streaming_kmeans(
    points,                      # array-like / np.memmap [n, d]
    k: int,
    rounds: int = 10,
    chunk_rows: int = 1 << 20,
    metric: Metric = "l2",
    seed: int = 555,
    init: Optional[np.ndarray] = None,
    *,
    device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd k-means over host-resident points. Returns (centroids, assignment)."""
    n, d = points.shape
    rng = np.random.default_rng(seed)
    if init is None:
        idx = np.sort(rng.choice(n, size=min(k, n), replace=False))
        init = np.asarray(points[idx], np.float32)
    centroids = to_device(init, device)
    for _ in range(rounds):
        sums = np.zeros((k, d), np.float64)
        counts = np.zeros(k, np.float64)
        for s in range(0, n, chunk_rows):
            cs, cc, _ = _chunk_stats(to_device(points[s : s + chunk_rows], device),
                                     centroids, k, metric)
            sums += cs.double().cpu().numpy()
            counts += cc.double().cpu().numpy()
        new_c = np.where(
            counts[:, None] > 0, sums / np.maximum(counts, 1)[:, None],
            centroids.double().cpu().numpy(),
        ).astype(np.float32)
        if metric == "mips":
            norms = np.sqrt(np.maximum((new_c ** 2).sum(1), 1e-12))
            new_c = new_c / norms[:, None]
        centroids = to_device(new_c, device)

    assignment = np.empty(n, np.int32)
    for s in range(0, n, chunk_rows):
        _, _, a = _chunk_stats(to_device(points[s : s + chunk_rows], device),
                               centroids, k, metric)
        assignment[s : s + a.shape[0]] = a.cpu().numpy()
    return centroids.cpu().numpy(), assignment


def admit_priority(target: np.ndarray, d_best: np.ndarray,
                   room: np.ndarray):
    """Vectorized distance-priority admission under per-part ``room``
    (MUTATED in place). Returns ``(placed_local, placed_parts,
    rest_local)`` — local indices into ``target`` of admitted points, their
    parts, and the indices that could not be placed in their nearest open
    part. The admission order (closest-first within each part) is the
    Pyramid assignment rule, ``partitioning.cpp:305-356``."""
    prio = np.argsort(d_best, kind="stable")
    t_prio = target[prio]
    by_t = np.argsort(t_prio, kind="stable")
    final = prio[by_t]
    t_fin = target[final]
    within = np.arange(len(final)) - np.searchsorted(t_fin, t_fin)
    ok = within < room[t_fin]
    np.subtract.at(room, t_fin[ok], 1)
    return final[ok], t_fin[ok], final[~ok]


class RepSet:
    """Labeled representatives resident on ``device`` for nearest-OPEN-part
    queries (used by :func:`capacity_stream_assign`)."""

    def __init__(self, reps: np.ndarray, rep_labels: np.ndarray,
                 metric: Metric = "l2", *, device) -> None:
        self.labels = np.asarray(rep_labels, np.int64)
        self.reps = to_device(np.asarray(reps, np.float32), device)
        self.labels_t = torch.as_tensor(self.labels).to(device)
        self.metric: Metric = metric
        self.device = torch.device(device)

    def nearest_open(self, chunk, room: np.ndarray):
        """(part of the nearest open representative, its distance) per row
        of ``chunk``; a representative is open while its part has room."""
        open_mask = torch.as_tensor(room > 0).to(self.device)[self.labels_t]
        tgt, db = _masked_nearest(to_device(chunk, self.device), self.reps,
                                  open_mask, self.metric)
        return self.labels[tgt.cpu().numpy()], db.cpu().numpy()


def capacity_stream_assign(
    points,
    reps: np.ndarray,
    rep_labels: np.ndarray,
    k: int,
    eps: float = 0.05,
    chunk_rows: int = 1 << 19,
    metric: Metric = "l2",
    *,
    device,
) -> np.ndarray:
    """Assign every point to the part of its nearest representative, under
    per-part capacity ``(1+eps)*ceil(n/k)`` — the reference's Pyramid
    assignment rule (``partitioning.cpp:305-356``) applied to any labeled
    representative set, streamed in ``chunk_rows`` chunks through the device.

    Per chunk: masked nearest-OPEN-representative on the device,
    distance-priority admission against global per-part room on the host;
    then retry rounds over the leftovers (total capacity k*cap >= n
    guarantees termination). The device holds two [chunk_rows, len(reps)]
    f32 tiles: 16 GiB at the default ``chunk_rows`` with 4096
    representatives, within an 80 GB H100.
    """
    n = points.shape[0]
    rs = RepSet(reps, rep_labels, metric=metric, device=device)
    cap = int((1.0 + eps) * np.ceil(n / k))
    room = np.full(k, cap, np.int64)
    part = np.full(n, -1, np.int32)

    def admit(global_ids: np.ndarray, target: np.ndarray,
              d_best: np.ndarray) -> np.ndarray:
        placed, pparts, rest = admit_priority(target, d_best, room)
        part[global_ids[placed]] = pparts
        return global_ids[rest]

    leftovers = []
    for s in range(0, n, chunk_rows):
        chunk = np.asarray(points[s : s + chunk_rows])
        tgt, db = rs.nearest_open(chunk, room)
        leftovers.append(admit(np.arange(s, s + len(chunk)), tgt, db))
    rest = np.concatenate(leftovers) if leftovers else np.empty(0, np.int64)
    while len(rest):
        tgt, db = rs.nearest_open(np.asarray(points[rest]), room)
        rest = admit(rest, tgt, db)
    return part


def streaming_capacity_partition(
    points,
    k: int,
    eps: float = 0.05,
    rounds: int = 10,
    chunk_rows: int = 1 << 20,
    metric: Metric = "l2",
    seed: int = 555,
    train_sample: Optional[int] = None,
    *,
    device,
) -> np.ndarray:
    """Balanced partition for bases larger than device memory: Lloyd
    centroids (streamed, or on an in-RAM uniform ``train_sample``), then
    :func:`capacity_stream_assign`. Max part size <= (1+eps)*ceil(n/k)."""
    n, d = points.shape
    if train_sample is not None and n > train_sample:
        from gpann_tpu_torch.cluster.kmeans import kmeans

        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(n, size=train_sample, replace=False))
        centroids, _ = kmeans(np.asarray(points[idx], np.float32), k=k,
                              metric=metric, rounds=rounds, seed=seed,
                              device=device)
    else:
        centroids, _ = streaming_kmeans(
            points, k, rounds=rounds, chunk_rows=chunk_rows, metric=metric,
            seed=seed, device=device)
    return capacity_stream_assign(
        points, centroids, np.arange(k), k, eps=eps, chunk_rows=chunk_rows,
        metric=metric, device=device)
