"""The work of kernel B2 (``binmin_scan``) in the streamed engine's pass,
beside ``roofline.py``, whose peaks and ``roofline_pct`` it is read with.

A pass of ``StreamedShardEngine.search`` scans each probed shard once, for
the queries that probe it; the engine's public ``probe_order`` on the batch
sets that work, as ``scan_inputs`` sets B1's. Per shard b: ``mq[b]``, the
(query, probe) pairs on b, and ``sizes[b]``, its rows; a shard too small
for the binned scan (``takes_binned``) takes the exact one and counts no B2
work.

- operations: ``2 d sum_b mq[b] sizes[b]``;
- bytes: each probed shard's rows once, each probing query row once, and
  each query row's output once (two distances and two int32 ids per
  128-row bin), all 4-byte words: B1's conventions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from annbench.roofline import BIN


def b2_work(engine, cfg: dict, queries: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """``(mq, sizes)`` [num_shards] of one batch (``queries`` on the host)
    served by the streamed ``engine`` over its store; ``mq`` is 0 where B2
    scans nothing."""
    probes = engine.probe_order(queries, cfg["nprobes"],
                                voting_t=cfg["voting_t"], rule=cfg["rule"])
    s = engine.num_shards
    mq = np.bincount(probes[probes < s].ravel(), minlength=s)
    sizes = np.asarray(engine.store.sizes, np.int64)
    binned = np.array([engine.takes_binned(int(n), cfg["k"]) for n in sizes])
    return np.where(binned, mq, 0).astype(np.int64), sizes


def b2_ops(mq: np.ndarray, sizes: np.ndarray, d: int) -> float:
    mq, sizes = np.asarray(mq, np.int64), np.asarray(sizes, np.int64)
    return 2.0 * d * float((mq * sizes).sum())


def b2_bytes(mq: np.ndarray, sizes: np.ndarray, d: int) -> float:
    mq, sizes = np.asarray(mq, np.int64), np.asarray(sizes, np.int64)
    live = (mq > 0) & (sizes > 0)
    shard_rows = int(sizes[live].sum())
    query_rows = int(mq[live].sum())
    bins = -(-sizes[live] // BIN)
    out_words = int((mq[live] * 4 * bins).sum())
    return 4.0 * ((shard_rows + query_rows) * d + out_words)
