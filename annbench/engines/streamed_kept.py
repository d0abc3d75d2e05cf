"""The streamed engine over a store kept at a fixed path: served as
``streamed`` serves it (``engines/streamed.py``: the base on the host in a
shard-major store, one pass of ``StreamedShardEngine.search`` a batch),
but the store is written once a machine and kept, so the runs after the
first read it warm from the page cache and write nothing.

``build`` keeps the store at
``<tempfile.gettempdir()>/annbench-store-<config name>-<key>``, ``<key>``
16 hex digits of the sha256 over the configuration file's bytes, the
shipped partition's ``shard_of`` bytes and the bytes of the program's
``search/relayout.py`` (a change to the store's format writes a new
store). A complete store there (``ShardMajorStore`` opens it, and its
shard sizes and files are the partition's) is reused, and the run logs
``store reused``. Otherwise whatever lies at the path is removed, the store
is written into the sibling ``<path>.partial-<pid>`` and renamed into
place, and the run logs the bytes written and the seconds taken; a write
that fails removes its partial directory. Partial directories of
processes that are gone are removed first. ``close`` logs the median pass
and keeps the store.
"""

import hashlib
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from annbench.cell import log
from annbench.engines.streamed import STAT_KEYS, Streamed, grouping, serve
from annbench.spec import HERE

__all__ = ["build", "serve", "grouping", "close", "store_path"]

PREFIX = "annbench-store-"
PARTIAL = ".partial-"


def store_path(cfg, shard_of) -> str:
    from gpann_tpu_torch.search import relayout

    key = hashlib.sha256()
    key.update((HERE / "configs" / f"{cfg['name']}.json").read_bytes())
    key.update(np.ascontiguousarray(shard_of).tobytes())
    key.update(Path(relayout.__file__).read_bytes())
    return os.path.join(tempfile.gettempdir(),
                        f"{PREFIX}{cfg['name']}-{key.hexdigest()[:16]}")


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:     # alive, and another user's
        pass
    return True


def _remove_stale_partials(path: str) -> None:
    parent, name = os.path.split(path)
    for entry in os.listdir(parent):
        pid = entry[len(name + PARTIAL):]
        if entry.startswith(name + PARTIAL) and pid.isdigit() \
                and not _alive(int(pid)):
            shutil.rmtree(os.path.join(parent, entry), ignore_errors=True)


def _open(path: str, shard_of, num_shards: int, d: int):
    """The complete store at ``path`` that holds this partition's shards,
    else None."""
    from gpann_tpu_torch.search.relayout import ShardMajorStore

    try:
        store = ShardMajorStore(path)
    except (OSError, ValueError, KeyError, AssertionError):
        return None
    sizes = np.bincount(np.asarray(shard_of, np.int64), minlength=num_shards)
    if (store.num_shards != num_shards or store.d != d
            or not np.array_equal(store.sizes, sizes)):
        return None
    try:
        for b in range(num_shards):
            for arr in (store.shard_rows(b), store.shard_ids(b)):
                if len(arr) and os.path.getsize(arr.filename) != arr.nbytes:
                    return None
    except (OSError, ValueError):   # a file missing or too short to map
        return None
    return store


def _write(base, shard_of, num_shards: int, path: str):
    from gpann_tpu_torch.search.relayout import (ShardMajorStore,
                                                 relayout_to_store)

    if os.path.isdir(path):
        log(f"store at {path} is incomplete or not this partition's: "
            f"removed")
        shutil.rmtree(path)
    partial = f"{path}{PARTIAL}{os.getpid()}"
    shutil.rmtree(partial, ignore_errors=True)
    t = time.perf_counter()
    try:
        relayout_to_store(base, shard_of, num_shards, partial)
        written = sum(p.stat().st_size for p in Path(partial).iterdir())
        os.rename(partial, path)
    except BaseException:
        shutil.rmtree(partial, ignore_errors=True)
        raise
    log(f"store written: {written} bytes in {time.perf_counter() - t:.3f} "
        f"s, kept at {path}")
    return ShardMajorStore(path)


def build(base, shard_of, routing_points, routing_labels, cfg, device):
    from gpann_tpu_torch.search.streamed import StreamedShardEngine

    path = store_path(cfg, shard_of)
    _remove_stale_partials(path)
    store = _open(path, shard_of, cfg["num_shards"], base.shape[1])
    if store is not None:
        log(f"store reused: {path}")
    else:
        store = _write(base, shard_of, cfg["num_shards"], path)
    engine = StreamedShardEngine(
        None, None, routing_points, routing_labels, metric=cfg["metric"],
        store=store, device=device, **cfg["engine"])
    return Streamed(engine, path)


def close(s: Streamed):
    """Logs the median pass and each pass's host read and upload seconds;
    the store stays for the next run."""
    if s.passes:
        log(f"streamed passes: {len(s.passes)}; the median pass: " + ", ".join(
            f"{key} {float(np.median([p[key] for p in s.passes]))!r}"
            for key in STAT_KEYS))
        log("each pass's gather_s / upload_s: " + ", ".join(
            f"{p['gather_s']:.3f}/{p['upload_s']:.3f}" for p in s.passes))
