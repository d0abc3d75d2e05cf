"""Text I/O for partitions, clusters and graphs — Metis conventions.

Format parity with the reference (``src/metis_io.cpp``) so artifacts are
interchangeable for cross-validation:

- partition file: one part id per line (``metis_io.cpp:18-24``).
- clusters file: one whitespace-separated list of point ids per line
  (``metis_io.cpp:26-44``).
- Metis graph: header ``num_nodes num_edges`` then per-node 1-indexed
  adjacency lines (``metis_io.cpp:46-64``).

Numpy only: a copy of ``gpann_tpu/core/metis_io.py``, so that both packages
write byte-identical files.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gpann_tpu_torch.core.partition import Clusters, Partition


def read_metis_partition(path: str) -> Partition:
    return np.loadtxt(path, dtype=np.int32, ndmin=1)


def write_metis_partition(path: str, partition: Partition) -> None:
    np.savetxt(path, np.asarray(partition, dtype=np.int32), fmt="%d")


def read_clusters(path: str) -> Clusters:
    clusters: Clusters = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            clusters.append(
                np.fromstring(line, dtype=np.int32, sep=" ")
                if line
                else np.empty(0, dtype=np.int32)
            )
    return clusters


def write_clusters(path: str, clusters: Clusters) -> None:
    with open(path, "w") as f:
        for members in clusters:
            f.write(" ".join(str(int(x)) for x in np.asarray(members)))
            f.write("\n")


def read_metis_graph(path: str) -> List[np.ndarray]:
    """Read a Metis graph into a 0-indexed adjacency list."""
    adj: List[np.ndarray] = []
    with open(path) as f:
        header = f.readline().split()
        num_nodes = int(header[0])
        for line in f:
            row = np.fromstring(line, dtype=np.int64, sep=" ")
            adj.append((row - 1).astype(np.int32))
    if len(adj) != num_nodes:
        raise ValueError(
            f"metis graph {path!r}: header says {num_nodes} nodes, got {len(adj)}"
        )
    return adj


def write_metis_graph(path: str, adjacency: List[np.ndarray]) -> None:
    """Write a 0-indexed adjacency list as a (1-indexed) Metis graph
    (``metis_io.cpp:46-64``)."""
    num_edges = sum(len(a) for a in adjacency)
    if num_edges % 2 != 0:
        raise ValueError("metis graphs must be symmetric (even directed-edge count)")
    with open(path, "w") as f:
        f.write(f"{len(adjacency)} {num_edges // 2}\n")
        for neigh in adjacency:
            f.write(" ".join(str(int(v) + 1) for v in np.asarray(neigh)))
            f.write("\n")


def csr_from_adjacency(adjacency: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Adjacency list -> CSR (indptr int64 [n+1], indices int32 [m])."""
    indptr = np.zeros(len(adjacency) + 1, dtype=np.int64)
    indptr[1:] = np.cumsum([len(a) for a in adjacency])
    indices = (
        np.concatenate([np.asarray(a, dtype=np.int32) for a in adjacency])
        if adjacency
        else np.empty(0, dtype=np.int32)
    )
    return indptr, indices


def adjacency_from_csr(indptr: np.ndarray, indices: np.ndarray) -> List[np.ndarray]:
    return [
        indices[indptr[i] : indptr[i + 1]].astype(np.int32)
        for i in range(len(indptr) - 1)
    ]
