"""Partition / Clusters / Cover representations and conversions.

Reference parity (``src/defs.h:25-42``, ``src/defs.cpp:30-79``):

- ``Partition``  — int32 array [n], point -> shard id (non-overlapping).
- ``Clusters``   — list of int arrays, shard -> member point ids.
- ``Cover``      — list of int arrays, point -> shard ids (overlapping
  assignments; a point may belong to several shards).

These live on host as NumPy: they are irregular bookkeeping, not compute.
Device-side code uses the dense ``Partition`` array or padded cluster tensors
produced by :func:`pad_clusters`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

Partition = np.ndarray  # [n] int32
Clusters = List[np.ndarray]  # num_clusters x [size_i] int32
Cover = List[np.ndarray]  # n x [num_shards_of_point] int32


def num_parts(partition: Partition) -> int:
    return int(partition.max()) + 1 if partition.size else 0


def partition_to_clusters(partition: Partition, k: int | None = None) -> Clusters:
    """point->shard array to shard->points lists (defs.cpp:30-41)."""
    partition = np.asarray(partition)
    if k is None:
        k = num_parts(partition)
    order = np.argsort(partition, kind="stable")
    sorted_parts = partition[order]
    boundaries = np.searchsorted(sorted_parts, np.arange(k + 1))
    return [
        order[boundaries[i] : boundaries[i + 1]].astype(np.int32) for i in range(k)
    ]


def clusters_to_partition(clusters: Clusters, n: int | None = None) -> Partition:
    """shard->points lists to point->shard array (inverse of the above)."""
    if n is None:
        n = int(max((c.max() for c in clusters if len(c)), default=-1)) + 1
    partition = np.full(n, -1, dtype=np.int32)
    for part_id, members in enumerate(clusters):
        partition[np.asarray(members, dtype=np.int64)] = part_id
    return partition


def clusters_to_cover(clusters: Clusters, n: int | None = None) -> Cover:
    """shard->points to point->shards, supporting overlap (defs.cpp:43-55).

    Vectorized: flat (point, part) pairs sorted by point, split by
    searchsorted boundaries — no per-element Python loop."""
    if n is None:
        n = int(max((c.max() for c in clusters if len(c)), default=-1)) + 1
    sizes = np.asarray([len(c) for c in clusters], np.int64)
    if sizes.sum() == 0:
        return [np.empty(0, np.int32) for _ in range(n)]
    pts = np.concatenate([np.asarray(c, np.int64) for c in clusters])
    parts = np.repeat(np.arange(len(clusters), dtype=np.int32), sizes)
    order = np.argsort(pts, kind="stable")
    sorted_pts = pts[order]
    sorted_parts = parts[order]
    bounds = np.searchsorted(sorted_pts, np.arange(n + 1))
    return [sorted_parts[bounds[i] : bounds[i + 1]] for i in range(n)]


def cover_to_clusters(cover: Cover, k: int | None = None) -> Clusters:
    """point->shards to shard->points (defs.cpp:57-62). Vectorized like
    :func:`clusters_to_cover`."""
    if k is None:
        k = int(max((c.max() for c in cover if len(c)), default=-1)) + 1
    deg = np.asarray([len(c) for c in cover], np.int64)
    if deg.sum() == 0:
        return [np.empty(0, np.int32) for _ in range(k)]
    shards = np.concatenate([np.asarray(c, np.int64) for c in cover])
    pts = np.repeat(np.arange(len(cover), dtype=np.int32), deg)
    order = np.argsort(shards, kind="stable")
    sorted_shards = shards[order]
    sorted_pts = pts[order]
    bounds = np.searchsorted(sorted_shards, np.arange(k + 1))
    return [sorted_pts[bounds[i] : bounds[i + 1]] for i in range(k)]


def cover_to_csr(cover: Cover) -> tuple[np.ndarray, np.ndarray]:
    """CSR form (indptr [n+1] int64, indices int32) of a point->shards
    cover — the vectorization substrate for cover-aware recall/oracle paths
    (per-element Python loops over covers crawl at 100k-query scale on the
    single-core host)."""
    deg = np.asarray([len(c) for c in cover], np.int64)
    indptr = np.zeros(len(cover) + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = (np.concatenate([np.asarray(c, np.int32) for c in cover])
               if len(cover) and deg.sum() else np.empty(0, np.int32))
    return indptr, indices


def clusters_to_cover_csr(clusters: Clusters,
                          n: int) -> tuple[np.ndarray, np.ndarray]:
    """``cover_to_csr(clusters_to_cover(clusters, n))`` without the per-point
    list: (indptr [n+1] int64, shard ids int32), each point's shards in
    ascending order."""
    sizes = np.asarray([len(c) for c in clusters], np.int64)
    if sizes.sum() == 0:
        return np.zeros(n + 1, np.int64), np.empty(0, np.int32)
    pts = np.concatenate([np.asarray(c, np.int64) for c in clusters])
    parts = np.repeat(np.arange(len(clusters), dtype=np.int32), sizes)
    order = np.argsort(pts, kind="stable")
    indptr = np.searchsorted(pts[order], np.arange(n + 1)).astype(np.int64)
    return indptr, parts[order]


def csr_gather(indptr: np.ndarray, indices: np.ndarray,
               row_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Ragged gather: concatenated CSR rows of ``row_ids``.

    Returns (owners, values): ``values`` is the concatenation of the rows'
    entries, ``owners[i]`` the position in ``row_ids`` that produced
    ``values[i]``. Pure vector ops (repeat/cumsum), no Python loop."""
    row_ids = np.asarray(row_ids, np.int64)
    deg = indptr[row_ids + 1] - indptr[row_ids]
    total = int(deg.sum())
    owners = np.repeat(np.arange(len(row_ids)), deg)
    base = np.repeat(indptr[row_ids], deg)
    local = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
    return owners, indices[base + local]


def remap_partition_ids(partition: Partition) -> Partition:
    """Compact partition ids to remove empty parts (defs.cpp:64-79)."""
    partition = np.asarray(partition)
    used = np.unique(partition)
    remap = np.full(int(used.max()) + 1 if used.size else 0, -1, dtype=np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    return remap[partition]


def cluster_sizes(clusters: Clusters) -> np.ndarray:
    return np.asarray([len(c) for c in clusters], dtype=np.int64)


def max_part_size(n: int, k: int, eps: float) -> int:
    """The balance constraint L_max = (1+eps) * ceil(n/k) used throughout the
    reference (e.g. ``partition.cpp:88``, ``partitioning.cpp:183``)."""
    return int((1.0 + eps) * np.ceil(n / max(k, 1)))


def pad_clusters(
    clusters: Clusters, pad_to: int | None = None, fill: int = -1
) -> tuple[np.ndarray, np.ndarray]:
    """Pack ragged clusters into a dense [k, pad_to] id tensor + sizes [k].

    Fixed shapes are what XLA wants; ``fill`` marks padding slots. This is the
    device-side counterpart of ``Clusters`` used by the IVF search layout.
    """
    sizes = cluster_sizes(clusters).astype(np.int32)
    if pad_to is None:
        pad_to = int(sizes.max()) if sizes.size else 0
    out = np.full((len(clusters), pad_to), fill, dtype=np.int32)
    for i, members in enumerate(clusters):
        out[i, : len(members)] = members
    return out, sizes


def check_cover_consistency(cover: Cover, clusters: Clusters) -> bool:
    """Property check: cover and clusters describe the same assignment."""
    back = clusters_to_cover(clusters, n=len(cover))
    return all(
        np.array_equal(np.sort(a), np.sort(b)) for a, b in zip(cover, back)
    )
