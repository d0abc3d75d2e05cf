"""GP at scale: subsample graph partitioning + capacity stream-assignment
(counterpart of ``gpann_tpu/gp/scale.py``).

The reference's GP pipeline (kNN graph -> balanced graph partition,
``src/partitioning.cpp:251-264``) reaches large bases through Pyramid-style
subsampling (``partitioning.cpp:266-356``):

1. **Subsample** ``num_subsample`` points (host RAM).
2. **GP on the subsample**: approximate kNN graph
   (:mod:`gpann_tpu_torch.graph.knn`) + balanced LP partition
   (:mod:`gpann_tpu_torch.gp.lp`).
3. **Aggregate within parts**: per-part k-means on the subsample members
   (budget split proportional to part size) yields ``num_aggregate``
   representatives that respect the graph-partition boundary.
4. **Stream-assign all points** to the part of their nearest open aggregate
   under capacity ``(1+eps)*ceil(n/k)`` with retry rounds
   (:func:`gpann_tpu_torch.cluster.streaming.capacity_stream_assign`).

Each stage's wall seconds are logged (logger ``gpann_tpu_torch.gp.scale``).
"""

from __future__ import annotations

import logging
import time
from typing import Tuple

import numpy as np

from gpann_tpu_torch.cluster.kmeans import kmeans
from gpann_tpu_torch.cluster.streaming import capacity_stream_assign
from gpann_tpu_torch.core.distances import Metric

log = logging.getLogger(__name__)


def gp_aggregates(sample: np.ndarray, sub_part: np.ndarray, k: int,
                  num_aggregate: int, metric: Metric = "l2", seed: int = 555,
                  rounds: int = 10, *, device) -> Tuple[np.ndarray, np.ndarray]:
    """Per-part k-means representatives of a partitioned sample.

    The aggregate budget is split across parts proportionally to part size
    (>= 1 each, as the tree router's budget split,
    ``kmeans_tree_router.cpp:9-33``). Returns (aggregates [a, d], labels [a])
    with ``labels[i]`` the part whose sample members produced aggregate ``i``.
    """
    sizes = np.bincount(sub_part, minlength=k).astype(np.float64)
    quota = np.maximum(
        1, np.round(num_aggregate * sizes / max(sizes.sum(), 1)).astype(int))
    reps, labels = [], []
    for p in range(k):
        members = np.nonzero(sub_part == p)[0]
        if len(members) == 0:
            continue
        kp = int(min(quota[p], len(members)))
        if kp >= len(members):
            cents = sample[members]
        else:
            cents, _ = kmeans(sample[members], k=kp, metric=metric,
                              rounds=rounds, seed=seed + p, device=device)
            # drop empty-cluster duplicates kmeans may leave behind
            cents = np.unique(cents, axis=0)
        reps.append(np.asarray(cents, np.float32))
        labels.append(np.full(len(cents), p, np.int64))
    return np.concatenate(reps, axis=0), np.concatenate(labels)


def subsample_gp_aggregates(
    points,                     # array-like / np.memmap [n, d]
    k: int,
    eps: float = 0.05,
    metric: Metric = "l2",
    seed: int = 555,
    num_subsample: int = 2_000_000,
    num_aggregate: int = 4096,
    degree: int = 10,
    strong: bool = False,
    *,
    device,
):
    """Steps 1-3 of the pipeline (module docstring): subsample -> GP on the
    subsample's kNN graph -> per-part aggregates. Returns
    ``(aggregates, agg_labels, sample_idx, sub_part)``.

    A base advertising ``iid_rows`` is sampled by contiguous prefix —
    distributionally identical for exchangeable rows.
    """
    from gpann_tpu_torch.gp.partitioning import partition_dense_graph
    from gpann_tpu_torch.graph.knn import ApproximateKNNGraphBuilder

    t0 = time.perf_counter()
    n = points.shape[0]
    rng = np.random.default_rng(seed)
    ns = min(num_subsample, n)
    if ns == n:
        sample_idx = np.arange(n)
        sample = np.asarray(points, np.float32)
    elif getattr(points, "iid_rows", False):
        sample_idx = np.arange(ns)
        sample = np.asarray(points[:ns], np.float32)
    else:
        sample_idx = np.sort(rng.choice(n, size=ns, replace=False))
        sample = np.asarray(points[sample_idx], np.float32)
    t1 = time.perf_counter()

    builder = ApproximateKNNGraphBuilder(metric=metric, seed=seed,
                                         strong=strong, device=device)
    graph = builder.build(sample, degree)
    t2 = time.perf_counter()
    sub_part = partition_dense_graph(graph, k, eps, seed=seed, device=device)
    del graph
    t3 = time.perf_counter()

    aggregates, agg_labels = gp_aggregates(
        sample, sub_part, k, num_aggregate, metric=metric, seed=seed,
        device=device)
    log.info("subsample_gp: sample %d of %d %.3f s, knn graph %.3f s, "
             "graph partition %.3f s, %d aggregates %.3f s", ns, n, t1 - t0,
             t2 - t1, t3 - t2, len(aggregates), time.perf_counter() - t3)
    return aggregates, agg_labels, sample_idx, sub_part


def subsample_gp_partition(
    points,                     # array-like / np.memmap [n, d]
    k: int,
    eps: float = 0.05,
    metric: Metric = "l2",
    seed: int = 555,
    num_subsample: int = 2_000_000,
    num_aggregate: int = 4096,
    degree: int = 10,
    strong: bool = False,
    chunk_rows: int = 1 << 19,
    return_artifacts: bool = False,
    *,
    device,
):
    """GP partition of an arbitrarily large (memmap) base.

    Balance guarantee: ``max part size <= (1+eps)*ceil(n/k)`` — the
    reference's Pyramid capacity rule (``partitioning.cpp:303``).

    ``return_artifacts=True`` also returns ``(aggregates, agg_labels,
    sample_idx, sub_part)`` for router training / diagnostics.
    """
    aggregates, agg_labels, sample_idx, sub_part = subsample_gp_aggregates(
        points, k, eps=eps, metric=metric, seed=seed,
        num_subsample=num_subsample, num_aggregate=num_aggregate,
        degree=degree, strong=strong, device=device)
    t0 = time.perf_counter()
    part = capacity_stream_assign(points, aggregates, agg_labels, k, eps=eps,
                                  chunk_rows=chunk_rows, metric=metric,
                                  device=device)
    log.info("subsample_gp: capacity assignment of %d points %.3f s",
             points.shape[0], time.perf_counter() - t0)
    if return_artifacts:
        return part, (aggregates, agg_labels, sample_idx, sub_part)
    return part
