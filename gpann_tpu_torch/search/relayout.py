"""Shard-major on-disk point layout for the streamed path, which serves a
base that does not fit the device (counterpart of
``gpann_tpu/search/relayout.py``; directories written by either package are
read by the other: same ``meta.json``, file names and dtypes).

The reference re-lays points contiguously by cluster before searching
(``src/inverted_index.h:20-41``: offsets + id permutation) and each rank of
the distributed benchmark seek-reads only contiguous owned ranges from the
base file (``src/distributed_query_benchmark.h:48-84``). Fancy-indexing a
shard's scattered rows out of a chunk-ordered memmap is a random gather over
the whole file; this module is the layout that avoids it:

- :class:`ShardMajorStore`: a directory of per-shard raw row files plus
  original-id sidecars. Shard ``b`` reads as ONE contiguous slice; original
  ids come from the sidecar (``inverted_index.h``'s permutation).
- :func:`relayout_to_store`: one sequential pass re-laying an existing
  (memmap) base given its partition.
- :func:`capacity_assign_to_store`: the fusion for the largest bases: ONE
  pass that streams chunks (possibly regenerated on the fly from a
  :class:`~gpann_tpu_torch.eval.synth.VirtualPoints` base), assigns each
  point to its nearest open part on the device (the Pyramid capacity rule,
  ``partitioning.cpp:305-356``), and appends admitted rows straight into the
  shard files, so the base touches disk exactly once, already shard-major.
  Checkpointed per chunk-batch: an interrupted build is resumed by calling
  it again. Each shard holds the points the JAX package's store holds; the
  order inside a chunk's rows differs (:meth:`_Writer.append`), so these
  files are read by the other package but are not byte-identical to its own.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from gpann_tpu_torch.core.distances import Metric

_META = "meta.json"
_CKPT = "ckpt.json"
_SUBS = "subclusters.npz"


def _ids_dtype(n: int):
    return np.uint32 if n <= np.iinfo(np.uint32).max else np.int64


def _shard_path(d: str, b: int) -> str:
    return os.path.join(d, f"shard_{b:05d}.bin")


def _ids_path(d: str, b: int) -> str:
    return os.path.join(d, f"ids_{b:05d}.bin")


class ShardMajorStore:
    """Reader over a shard-major layout directory (see module docstring)."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if not meta.get("complete"):
            raise ValueError(f"store at {path} is incomplete")
        self.n = int(meta["n"])
        self.d = int(meta["d"])
        self.dtype = np.dtype(meta["dtype"])
        self.ids_dtype = np.dtype(meta["ids_dtype"])
        self.num_shards = int(meta["num_shards"])
        self.sizes = np.asarray(meta["sizes"], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        assert self.offsets[-1] == self.n, (self.offsets[-1], self.n)
        self.shape = (self.n, self.d)

    @staticmethod
    def exists(path: str) -> bool:
        try:
            with open(os.path.join(path, _META)) as f:
                return bool(json.load(f).get("complete"))
        except Exception:
            return False

    def shard_rows(self, b: int) -> np.ndarray:
        """Shard ``b``'s rows as ONE contiguous memmap slice [sizes[b], d]."""
        if self.sizes[b] == 0:
            return np.empty((0, self.d), self.dtype)
        return np.memmap(_shard_path(self.path, b), dtype=self.dtype,
                         mode="r", shape=(int(self.sizes[b]), self.d))

    def shard_ids(self, b: int) -> np.ndarray:
        """Original point ids of shard ``b``'s rows (the permutation
        sidecar, ``inverted_index.h:20-41``)."""
        if self.sizes[b] == 0:
            return np.empty(0, self.ids_dtype)
        return np.memmap(_ids_path(self.path, b), dtype=self.ids_dtype,
                         mode="r", shape=(int(self.sizes[b]),))

    # -- concatenated-position helpers ------------------------------------
    def shard_of_positions(self, pos: np.ndarray) -> np.ndarray:
        """Shard index of each concatenated position."""
        return (np.searchsorted(self.offsets, np.asarray(pos), side="right")
                - 1).astype(np.int32)

    def orig_ids(self, pos: np.ndarray) -> np.ndarray:
        """Map concatenated positions -> original point ids (-1 passthrough
        for -1 fillers)."""
        pos = np.asarray(pos)
        out = np.full(pos.shape, -1, np.int64)
        flat = pos.reshape(-1)
        ok = flat >= 0
        sh = self.shard_of_positions(flat[ok])
        res = np.empty(ok.sum(), np.int64)
        local = flat[ok] - self.offsets[sh]
        for b in np.unique(sh):
            sel = sh == b
            res[sel] = np.asarray(self.shard_ids(int(b)))[local[sel]]
        out.reshape(-1)[ok] = res
        return out

    def sample(self, ns: int, seed: int = 555,
               widen: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Uniform row sample with shard labels: ``(rows [ns, d] f32,
        labels [ns])``. Sampling positions uniformly over the concatenation
        is uniform over points (the layout is a permutation)."""
        rng = np.random.default_rng(seed)
        ns = min(ns, self.n)
        if ns * 8 >= self.n:
            pos = np.sort(rng.choice(self.n, size=ns, replace=False))
        else:
            # Generator.choice(replace=False) materializes a permutation of
            # n (8 GB at n=1B). Unique-of-uniform draws are an unbiased
            # without-replacement sample by symmetry and cost O(ns); top up
            # the rare collision shortfall, then thin the (sorted) surplus
            # with a permutation of only ~1.03*ns.
            pos = np.unique(rng.integers(0, self.n, size=int(ns * 1.03) + 64))
            while len(pos) < ns:
                extra = rng.integers(0, self.n, size=int(ns * 0.05) + 64)
                pos = np.unique(np.concatenate([pos, extra]))
            if len(pos) > ns:
                pos = np.sort(pos[rng.choice(len(pos), size=ns,
                                             replace=False)])
        sh = self.shard_of_positions(pos)
        rows = np.empty((len(pos), self.d),
                        np.float32 if widen else self.dtype)
        for b in np.unique(sh):
            sel = sh == b
            rows[sel] = self.shard_rows(int(b))[pos[sel] - self.offsets[b]]
        return rows, sh.astype(np.int64)

    def concat_view(self) -> "ConcatView":
        return ConcatView(self)

    # -- sub-cluster-major layout (in-shard pruning on the store) ----------
    def permute_shard(self, b: int, order: np.ndarray) -> None:
        """Rewrite shard ``b``'s row + id files in ``order`` (tmp + rename,
        so a crash leaves the old files). Any within-shard permutation keeps
        the store valid: the ids sidecar moves in lockstep, and original ids
        (not positions) are what every cached artifact stores."""
        order = np.asarray(order)
        assert len(order) == self.sizes[b], (len(order), self.sizes[b])
        rows = np.asarray(self.shard_rows(b))[order]
        ids = np.asarray(self.shard_ids(b))[order]
        for path, arr in ((_shard_path(self.path, b), rows),
                          (_ids_path(self.path, b), ids)):
            with open(path + ".tmp", "wb") as f:
                f.write(np.ascontiguousarray(arr).tobytes())
            os.replace(path + ".tmp", path)

    def save_subclusters(self, offsets: List[np.ndarray],
                         cents: List[np.ndarray]) -> None:
        """Sidecar for a sub-cluster-major row order: per shard ``b``,
        sub-cluster ``j`` spans LOCAL rows ``[offsets[b][j],
        offsets[b][j+1])`` of the shard file; ``cents[b]`` are the
        sub-centroids (f32). The two-level analog of the reference's
        cluster offsets (inverted_index.h:20-41), one level down."""
        optr = np.concatenate(
            [[0], np.cumsum([len(o) for o in offsets])]).astype(np.int64)
        np.savez(
            os.path.join(self.path, _SUBS),
            optr=optr,
            off=(np.concatenate(offsets) if offsets
                 else np.empty(0, np.int64)).astype(np.int64),
            cents=(np.concatenate(cents) if cents
                   else np.empty((0, self.d), np.float32)),
            cptr=np.concatenate(
                [[0], np.cumsum([len(c) for c in cents])]).astype(np.int64),
        )

    def load_subclusters(self):
        """``(offsets, cents)`` lists per shard, or None if no sidecar."""
        p = os.path.join(self.path, _SUBS)
        if not os.path.exists(p):
            return None
        z = np.load(p)
        optr, off, cents, cptr = z["optr"], z["off"], z["cents"], z["cptr"]
        offsets = [off[optr[b]: optr[b + 1]] for b in range(self.num_shards)]
        cent_l = [cents[cptr[b]: cptr[b + 1]] for b in range(self.num_shards)]
        return offsets, cent_l


class ConcatView:
    """Row-slice view over a store's concatenated shards — the array-like
    the streaming GT/scan helpers consume (``points[s:e]``)."""

    def __init__(self, store: ShardMajorStore) -> None:
        self.store = store
        self.shape = store.shape
        self.dtype = store.dtype

    def __len__(self) -> int:
        return self.store.n

    def __getitem__(self, idx):
        st = self.store
        if isinstance(idx, tuple):
            return self[idx[0]][(slice(None),) + tuple(idx[1:])]
        if not isinstance(idx, slice):
            idx = np.asarray(idx)
            sh = st.shard_of_positions(idx)
            out = np.empty((len(idx), st.d), st.dtype)
            for b in np.unique(sh):
                sel = sh == b
                out[sel] = st.shard_rows(int(b))[idx[sel] - st.offsets[b]]
            return out
        s, e, step = idx.indices(st.n)
        assert step == 1
        if s >= e:
            return np.empty((0, st.d), st.dtype)
        b0 = int(st.shard_of_positions(np.asarray([s]))[0])
        parts = []
        b = b0
        while b < st.num_shards and st.offsets[b] < e:
            lo = max(s, st.offsets[b]) - st.offsets[b]
            hi = min(e, st.offsets[b + 1]) - st.offsets[b]
            if hi > lo:
                parts.append(st.shard_rows(b)[lo:hi])
            b += 1
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


class _Writer:
    """Append-only shard-file writer (build side of the store)."""

    def __init__(self, path: str, num_shards: int, d: int, dtype,
                 ids_dtype) -> None:
        os.makedirs(path, exist_ok=True)
        self.path, self.num_shards, self.d = path, num_shards, d
        self.dtype, self.ids_dtype = np.dtype(dtype), np.dtype(ids_dtype)
        self.sizes = np.zeros(num_shards, np.int64)
        for b in range(num_shards):  # ensure files exist for truncation
            for p in (_shard_path(path, b), _ids_path(path, b)):
                if not os.path.exists(p):
                    open(p, "ab").close()

    def truncate_to(self, sizes: np.ndarray) -> None:
        """Resume support: cut files back to a checkpoint's row counts."""
        self.sizes = np.asarray(sizes, np.int64).copy()
        row = self.d * self.dtype.itemsize
        for b in range(self.num_shards):
            os.truncate(_shard_path(self.path, b), int(self.sizes[b]) * row)
            os.truncate(_ids_path(self.path, b),
                        int(self.sizes[b]) * self.ids_dtype.itemsize)

    def append(self, parts: np.ndarray, ids: np.ndarray,
               rows: np.ndarray) -> None:
        """Append ``rows`` to the files of their ``parts``; the rows of one
        call land in each shard file in ascending id order. (The fused
        assignment hands them over in admission order, closest to their
        representative first; written so, the points of one dense cluster
        sit side by side in the file and share 128-row bins, of which the
        bin-top-2 scan keeps two candidates each.)"""
        by_id = np.argsort(ids, kind="stable")
        parts, ids, rows = parts[by_id], ids[by_id], rows[by_id]
        order = np.argsort(parts, kind="stable")
        sp = parts[order]
        bounds = np.nonzero(np.diff(sp))[0] + 1
        for grp in np.split(order, bounds) if len(sp) else []:
            b = int(parts[grp[0]])
            with open(_shard_path(self.path, b), "ab") as f:
                f.write(np.ascontiguousarray(rows[grp], self.dtype).tobytes())
            with open(_ids_path(self.path, b), "ab") as f:
                f.write(ids[grp].astype(self.ids_dtype).tobytes())
            self.sizes[b] += len(grp)

    def finalize(self, n: int) -> ShardMajorStore:
        meta = {"n": int(n), "d": self.d, "dtype": self.dtype.name,
                "ids_dtype": self.ids_dtype.name,
                "num_shards": self.num_shards,
                "sizes": [int(x) for x in self.sizes], "complete": True}
        with open(os.path.join(self.path, _META), "w") as f:
            json.dump(meta, f)
        ck = os.path.join(self.path, _CKPT)
        if os.path.exists(ck):
            os.remove(ck)
        return ShardMajorStore(self.path)


def relayout_to_store(points, part: np.ndarray, num_shards: int,
                      out_dir: str, chunk_rows: int = 1 << 20,
                      ) -> ShardMajorStore:
    """One sequential pass re-laying an existing base shard-major
    (``inverted_index.h:20-41``). ``points`` is any row-sliceable array-like;
    ``part`` the point->shard assignment."""
    n, d = points.shape
    part = np.asarray(part)
    w = _Writer(out_dir, num_shards, d,
                getattr(points, "dtype", np.float32), _ids_dtype(n))
    w.truncate_to(np.zeros(num_shards, np.int64))
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        rows = np.asarray(points[s:e])
        w.append(part[s:e], np.arange(s, e, dtype=np.int64), rows)
    return w.finalize(n)


def capacity_assign_to_store(
    points,
    reps: np.ndarray,
    rep_labels: np.ndarray,
    k: int,
    out_dir: str,
    eps: float = 0.05,
    chunk_rows: int = 1 << 20,
    metric: Metric = "l2",
    max_chunks: Optional[int] = None,
    log=None,
    *,
    device,
) -> bool:
    """Fused capacity stream-assignment + shard-major relayout.

    Identical admission semantics to
    :func:`gpann_tpu_torch.cluster.streaming.capacity_stream_assign` (chunk-order
    greedy, distance-priority within chunk, global retry rounds over the
    leftovers), but every admitted row is appended straight to its shard
    file: the base is read (or regenerated, for a virtual base) exactly
    ONCE and lands on disk already shard-major. Unplaced rows spill to a
    leftover file so retry rounds never re-touch ``points``.

    Checkpointed every chunk-batch (``ckpt.json`` + append-only files +
    truncate-on-resume): a call stops after ``max_chunks`` chunks and
    returns False; call again until it returns True (complete).
    """
    from gpann_tpu_torch.cluster.streaming import RepSet, admit_priority

    n, d = points.shape
    dtype = np.dtype(getattr(points, "dtype", np.float32))
    rs = RepSet(reps, rep_labels, metric=metric, device=device)
    cap = int((1.0 + eps) * np.ceil(n / k))
    idt = _ids_dtype(n)
    w = _Writer(out_dir, k, d, dtype, idt)
    lo_path = os.path.join(out_dir, "leftover.bin")
    lo_ids_path = os.path.join(out_dir, "leftover_ids.bin")
    ck_path = os.path.join(out_dir, _CKPT)
    row_b = d * dtype.itemsize

    if os.path.exists(ck_path):
        with open(ck_path) as f:
            ck = json.load(f)
        room = np.asarray(ck["room"], np.int64)
        next_chunk = int(ck["next_chunk"])
        w.truncate_to(np.asarray(ck["sizes"], np.int64))
        os.truncate(lo_path, int(ck["leftover_rows"]) * row_b)
        os.truncate(lo_ids_path,
                    int(ck["leftover_rows"]) * np.dtype(idt).itemsize)
    else:
        room = np.full(k, cap, np.int64)
        next_chunk = 0
        w.truncate_to(np.zeros(k, np.int64))
        for p in (lo_path, lo_ids_path):
            open(p, "wb").close()

    def save_ckpt(nc: int) -> None:
        lo_rows = os.path.getsize(lo_path) // row_b
        with open(ck_path + ".tmp", "w") as f:
            json.dump({"next_chunk": nc, "room": [int(x) for x in room],
                       "sizes": [int(x) for x in w.sizes],
                       "leftover_rows": int(lo_rows)}, f)
        os.replace(ck_path + ".tmp", ck_path)

    starts = list(range(0, n, chunk_rows))
    done_in_call = 0

    # prefetch thread: chunk regeneration (a VirtualPoints base pays host RNG
    # per chunk, the pass's critical path) overlaps the device assignment
    # and the shard-file writes of the previous chunk. Only the producer
    # touches `points`; consumption is strictly in ci order.
    import queue as _queue
    import threading as _threading

    feed: _queue.Queue = _queue.Queue(maxsize=2)

    def _producer(begin: int) -> None:
        for ci in range(begin, len(starts)):
            s = starts[ci]
            feed.put((ci, np.asarray(points[s : min(s + chunk_rows, n)])))
        feed.put(None)

    _threading.Thread(target=_producer, args=(next_chunk,),
                      daemon=True).start()
    for ci in range(next_chunk, len(starts)):
        if max_chunks is not None and done_in_call >= max_chunks:
            save_ckpt(ci)
            return False  # daemon producer dies with the process
        got = feed.get()
        assert got is not None and got[0] == ci, (got and got[0], ci)
        chunk = got[1]
        s = starts[ci]
        e = min(s + chunk_rows, n)
        tgt, db = rs.nearest_open(chunk, room)
        placed, pparts, rest = admit_priority(tgt, db, room)
        gids = np.arange(s, e, dtype=np.int64)
        w.append(pparts, gids[placed], chunk[placed])
        if len(rest):
            with open(lo_path, "ab") as f:
                f.write(np.ascontiguousarray(chunk[rest], dtype).tobytes())
            with open(lo_ids_path, "ab") as f:
                f.write(gids[rest].astype(idt).tobytes())
        done_in_call += 1
        if done_in_call % 16 == 0:
            save_ckpt(ci + 1)
            if log:
                log(f"assign+relayout chunk {ci + 1}/{len(starts)} "
                    f"(leftover {os.path.getsize(lo_path) // row_b})")

    # retry rounds over the spilled leftovers (in RAM from here; the
    # checkpoint pins the pre-retry sizes so a crash redoes retry cleanly)
    save_ckpt(len(starts))
    lo_rows = os.path.getsize(lo_path) // row_b
    if lo_rows:
        rows = np.fromfile(lo_path, dtype=dtype).reshape(lo_rows, d)
        gids = np.fromfile(lo_ids_path, dtype=idt).astype(np.int64)
        if log:
            log(f"retry rounds over {lo_rows} leftover rows")
        while len(gids):
            # chunked retry: a 1B run can spill tens of millions of rows;
            # one global nearest_open over them would not fit the device.
            # Each batch is the same greedy admission as a main-pass
            # chunk; k*cap >= n guarantees termination.
            keep_r, keep_g = [], []
            for s0 in range(0, len(gids), chunk_rows):
                br, bg = rows[s0 : s0 + chunk_rows], gids[s0 : s0 + chunk_rows]
                tgt, db = rs.nearest_open(br, room)
                placed, pparts, rest = admit_priority(tgt, db, room)
                w.append(pparts, bg[placed], br[placed])
                if len(rest):
                    keep_r.append(br[rest])
                    keep_g.append(bg[rest])
            rows = (np.concatenate(keep_r) if keep_r
                    else np.empty((0, d), dtype))
            gids = (np.concatenate(keep_g) if keep_g
                    else np.empty(0, np.int64))
    w.finalize(n)
    for p in (lo_path, lo_ids_path):
        if os.path.exists(p):
            os.remove(p)
    return True
