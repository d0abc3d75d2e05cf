"""Native (C++) host ops of the graph partitioner, bound with ctypes
(counterpart of ``gpann_tpu/native``).

``src/graph_ops.cc`` is a copy of ``gpann_tpu/native/src/graph_ops.cc``:
heavy-edge mutual matching for coarsening, greedy BFS region growing for the
initial partition, and the capacity-repair pass. These are irregular host
loops, not device work. At first use :func:`library` compiles the source
with ``g++`` into ``gpann_tpu_torch/_build/libgpann_native_<hash>.so``
(ignored by git; the hash covers the source and the flags, so an edit
rebuilds it). A failed build raises: the partitioner has no path without
these ops. Their plain numpy versions are in :mod:`gpann_tpu_torch.gp.lp`.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "graph_ops.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# no -march=native: the library must not depend on the build host's CPU
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]


def build() -> str:
    """Compile ``src/graph_ops.cc`` unless the hashed library exists; returns
    its path. Raises ``RuntimeError`` when ``g++`` fails."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR,
                       f"libgpann_native_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    lib = ctypes.CDLL(build())
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    lib.heavy_edge_matching.restype = ctypes.c_int64
    lib.heavy_edge_matching.argtypes = [
        ctypes.c_int64, i64p, i32p, f32p, f32p, ctypes.c_float,
        ctypes.c_uint64, i64p,
    ]
    lib.bfs_grow_partition.restype = ctypes.c_int32
    lib.bfs_grow_partition.argtypes = [
        ctypes.c_int64, i64p, i32p, f32p, ctypes.c_int32, ctypes.c_double,
        ctypes.c_uint64, i32p,
    ]
    lib.force_balance.restype = ctypes.c_int32
    lib.force_balance.argtypes = [
        ctypes.c_int64, i64p, i32p, f32p, f32p, ctypes.c_int32,
        ctypes.c_double, i32p,
    ]
    return lib


def _csr(indptr, indices, n_nodes=None):
    """CSR arrays in the types the C ABI takes, with their sizes checked."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    n = len(indptr) - 1
    if n < 0 or indptr[0] != 0 or indptr[-1] != len(indices):
        raise ValueError("indptr does not describe indices")
    if n_nodes is not None and n != n_nodes:
        raise ValueError(f"{n} CSR rows for {n_nodes} nodes")
    if len(indices) and not (0 <= indices.min() and indices.max() < n):
        raise ValueError("CSR indices out of range")
    return n, indptr, indices


def _per_edge(a, m: int, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.shape != (m,):
        raise ValueError(f"{name} has shape {a.shape}, expected ({m},)")
    return a


def heavy_edge_matching(indptr, indices, weights, node_w, max_node_w,
                        seed) -> np.ndarray:
    """partner[i] = the node i is matched with, or i (int64 [n])."""
    n, indptr, indices = _csr(indptr, indices)
    weights = _per_edge(weights, len(indices), "weights")
    node_w = _per_edge(node_w, n, "node_w")
    partner = np.empty(n, np.int64)
    library().heavy_edge_matching(n, indptr, indices, weights, node_w,
                                  float(max_node_w),
                                  int(seed) & (2**64 - 1), partner)
    return partner


def bfs_grow_partition(indptr, indices, node_w, k, cap, seed) -> np.ndarray:
    """Greedy balanced region growing from ``k`` spread seeds (int32 [n])."""
    n, indptr, indices = _csr(indptr, indices)
    node_w = _per_edge(node_w, n, "node_w")
    part = np.full(n, -1, np.int32)
    library().bfs_grow_partition(n, indptr, indices, node_w, int(k),
                                 float(cap), int(seed) & (2**64 - 1), part)
    return part


def force_balance(indptr, indices, weights, node_w, k, cap,
                  part) -> np.ndarray:
    """Evict lowest-affinity nodes from parts heavier than ``cap`` (returns
    a new int32 [n] partition)."""
    n, indptr, indices = _csr(indptr, indices)
    weights = _per_edge(weights, len(indices), "weights")
    node_w = _per_edge(node_w, n, "node_w")
    part = np.array(part, np.int32)
    if part.shape != (n,) or (n and not (0 <= part.min() and part.max() < k)):
        raise ValueError("part must hold n ids in [0, k)")
    library().force_balance(n, indptr, indices, weights, node_w, int(k),
                            float(cap), part)
    return part
