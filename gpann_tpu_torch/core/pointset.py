"""Binary vector I/O in the big-ann-benchmarks formats.

File formats (parity with reference ``src/points_io.cpp:114-179``):

- ``.fbin``  — header ``uint32 n, uint32 d`` followed by ``n*d`` float32 values.
- ``.u8bin`` — same header, ``n*d`` uint8 values (widened to float32 on load).
- ``.i8bin`` — same header, ``n*d`` int8 values (widened to float32 on load).
- ground truth — header ``uint32 n, uint32 k``, then ``n*k`` uint32 neighbor ids,
  then ``n*k`` float32 distances (reference ``src/points_io.cpp:136-179``).

A prefix-only read is supported via ``size`` (reference ``points_io.cpp:25-27``).
Reads go through ``np.memmap`` so only the requested prefix touches RAM.

Numpy only: a copy of ``gpann_tpu/core/pointset.py``, so that both packages
write byte-identical files.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

_SUFFIX_DTYPES = {
    ".fbin": np.float32,
    ".u8bin": np.uint8,
    ".i8bin": np.int8,
    ".bin": np.uint8,  # SPACEV-style
}


def _dtype_for(path: str) -> np.dtype:
    for suffix, dtype in _SUFFIX_DTYPES.items():
        if path.endswith(suffix):
            return np.dtype(dtype)
    raise ValueError(
        f"unsupported point-file suffix for {path!r}; expected one of "
        f"{sorted(_SUFFIX_DTYPES)}"
    )


def read_header(path: str) -> Tuple[int, int]:
    """Read the (n, d) header of a binary point file."""
    with open(path, "rb") as f:
        n, d = struct.unpack("<II", f.read(8))
    return int(n), int(d)


def read_points(path: str, size: Optional[int] = None, dtype=np.float32) -> np.ndarray:
    """Read an ``[n, d]`` float32 matrix from a big-ann binary file.

    ``size`` limits the read to the first ``size`` points (prefix read,
    reference ``src/points_io.cpp:25-27``).
    """
    n, d = read_header(path)
    if size is not None and 0 < size < n:
        n = size
    raw_dtype = _dtype_for(path)
    mm = np.memmap(path, dtype=raw_dtype, mode="r", offset=8, shape=(n, d))
    return np.asarray(mm, dtype=dtype)


def write_points(path: str, points: np.ndarray) -> None:
    """Write an ``[n, d]`` matrix in the matching binary format for ``path``."""
    raw_dtype = _dtype_for(path)
    points = np.ascontiguousarray(points, dtype=raw_dtype)
    with open(path, "wb") as f:
        f.write(struct.pack("<II", points.shape[0], points.shape[1]))
        points.tofile(f)


def read_ground_truth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read big-ann ground truth: ``(ids [n,k] int32, dists [n,k] float32)``.

    Format parity with reference ``src/points_io.cpp:136-158``.
    """
    with open(path, "rb") as f:
        n, k = struct.unpack("<II", f.read(8))
    ids = np.memmap(path, dtype=np.uint32, mode="r", offset=8, shape=(n, k))
    dist_off = 8 + n * k * 4
    file_size = os.path.getsize(path)
    ids = np.asarray(ids, dtype=np.int32)
    if file_size >= dist_off + n * k * 4:
        dists = np.memmap(path, dtype=np.float32, mode="r", offset=dist_off, shape=(n, k))
        dists = np.asarray(dists, dtype=np.float32)
    else:  # ids-only ground-truth files exist in the wild
        dists = np.full((n, k), np.nan, dtype=np.float32)
    return ids, dists


def write_ground_truth(path: str, ids: np.ndarray, dists: np.ndarray) -> None:
    """Write big-ann ground truth (reference ``src/points_io.cpp:160-179``)."""
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    assert ids.shape == dists.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<II", ids.shape[0], ids.shape[1]))
        ids.tofile(f)
        dists.tofile(f)
