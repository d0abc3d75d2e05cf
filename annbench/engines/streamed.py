"""The streamed engine,
``gpann_tpu_torch.search.streamed.StreamedShardEngine``: the base stays on
the host, in a shard-major store
(``search/relayout.py::ShardMajorStore``: each shard's rows one contiguous
file, one read a shard, as gp-ann streams a rank's owned ranges,
``distributed_query_benchmark.h:48-84``), and only the router lives on the
card. A batch is one pass: routing on the card, then each probed shard read,
uploaded and scanned (kernel B2, ``binmin_scan``) for the queries that probe
it, and the candidates merged on the host.

``build`` writes the store with the program's ``relayout_to_store`` from the
benchmark's base and the shipped partition into a fresh temporary directory
(under ``TMPDIR``), inside set-up; ``close`` removes it. ``serve`` copies the
batch from the card, where the harness keeps its pool, into the host array
that the public ``search`` takes; the copy is part of the timed batch. The
engine scans no blocks of grouped queries: ``grouping`` gives None.

:class:`Streamed` keeps the ``stats`` dict of every pass (``route_s``,
``gather_s``, ``upload_s``, ``scan_s``, ``device_scan_ms``,
``bytes_uploaded``, ... as ``search`` documents them), with the seconds of
the copy from the card as ``copy_s``, in ``passes``, oldest first.
"""

import shutil
import tempfile
import time
from pathlib import Path
from dataclasses import dataclass, field
from typing import List

import numpy as np

from annbench.cell import log

STAT_KEYS = ("copy_s", "route_s", "gather_s", "upload_s", "scan_s",
             "device_scan_ms", "shards_scanned", "bytes_uploaded")


@dataclass
class Streamed:
    engine: object          # the program's StreamedShardEngine
    store_dir: str
    passes: List[dict] = field(default_factory=list)


def build(base, shard_of, routing_points, routing_labels, cfg, device):
    from gpann_tpu_torch.search.relayout import relayout_to_store
    from gpann_tpu_torch.search.streamed import StreamedShardEngine

    store_dir = tempfile.mkdtemp(prefix="annbench-store-")
    try:
        t = time.perf_counter()
        store = relayout_to_store(base, shard_of, cfg["num_shards"],
                                  store_dir)
        written = sum(p.stat().st_size for p in Path(store_dir).iterdir())
        log(f"store written: {written} bytes in "
            f"{time.perf_counter() - t:.3f} s")
        engine = StreamedShardEngine(
            None, None, routing_points, routing_labels, metric=cfg["metric"],
            store=store, device=device, **cfg["engine"])
    except BaseException:
        shutil.rmtree(store_dir, ignore_errors=True)
        raise
    return Streamed(engine, store_dir)


def serve(s: Streamed, cfg, queries):
    t = time.perf_counter()
    host = queries.cpu().numpy()
    copy_s = time.perf_counter() - t
    dists, ids, stats = s.engine.search(host, cfg["k"], cfg["nprobes"],
                                        voting_t=cfg["voting_t"],
                                        rule=cfg["rule"])
    s.passes.append(dict(stats, copy_s=copy_s))
    return dists, ids


def grouping(s: Streamed, cfg, queries):
    return None


def close(s: Streamed):
    """Logs the median pass and removes the store."""
    if s.passes:
        log(f"streamed passes: {len(s.passes)}; the median pass: " + ", ".join(
            f"{key} {float(np.median([p[key] for p in s.passes]))!r}"
            for key in STAT_KEYS))
    shutil.rmtree(s.store_dir)
