"""Peaks of the card and the work of kernel B1 (``bintop2_blocks``).

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit): 495 TFLOP/s in TF32 on the tensor cores, 3.35 TB/s of HBM3.
B1 multiplies in split TF32 (three TF32 products a dot), so its time can
never come under a third of the share that operations alone would allow.

B1's work for one served batch comes from the grouping that
``ServingEngine.scan_inputs`` returns: per block, the count of real
(query, probe) rows ``live_q`` and the live rows ``sizes`` of the shard
window it scans (0 for a block the kernel skips), at ``row_off``.

- operations: ``2 d sum_b live_q[b] sizes[b]``, real rows only;
- bytes: each probed shard's live rows once, each real query row once, and
  each real row's output once (two distances and two int32 ids per 128-row
  bin of its window), all 4-byte words.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

BIN = 128
PEAKS = {
    # torch.cuda.get_device_name() -> (TF32 FLOP/s, HBM bytes/s)
    "NVIDIA H100 80GB HBM3": (495e12, 3.35e12),
}


def peaks(kind: str) -> Optional[tuple]:
    return PEAKS.get(kind)


def b1_ops(live_q: np.ndarray, sizes: np.ndarray, d: int) -> float:
    live_q, sizes = np.asarray(live_q, np.int64), np.asarray(sizes, np.int64)
    return 2.0 * d * float((live_q * sizes).sum())


def b1_bytes(live_q: np.ndarray, sizes: np.ndarray, row_off: np.ndarray,
             d: int) -> float:
    live_q, sizes = np.asarray(live_q, np.int64), np.asarray(sizes, np.int64)
    row_off = np.asarray(row_off, np.int64)
    live = (sizes > 0) & (live_q > 0)
    _, first = np.unique(row_off[live], return_index=True)
    shard_rows = int(sizes[live][first].sum())
    query_rows = int(live_q[live].sum())
    bins = -(-sizes[live] // BIN)
    out_words = int((live_q[live] * 4 * bins).sum())
    return 4.0 * ((shard_rows + query_rows) * d + out_words)


def roofline_pct(ops: float, nbytes: float, seconds: float,
                 kind: str) -> Optional[float]:
    """Least time by the card's peaks over ``seconds``, in percent; None for
    a card without peaks in the table or no time."""
    pk = peaks(kind)
    if pk is None or not seconds:
        return None
    return 100.0 * max(ops / pk[0], nbytes / pk[1]) / seconds


def padding_pct(live_q: np.ndarray, sizes: np.ndarray, qb: int) -> float:
    """Padding rows in the blocks the kernel scans over all their rows."""
    live_q, sizes = np.asarray(live_q, np.int64), np.asarray(sizes, np.int64)
    scanned = sizes > 0
    rows = int(scanned.sum()) * qb
    return 100.0 * (rows - int(live_q[scanned].sum())) / rows if rows else 0.0
