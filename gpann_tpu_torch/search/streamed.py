"""Shard-at-a-time streamed serving for bases that exceed device memory
(counterpart of ``gpann_tpu/search/streamed.py``).

The reference serves 1B points by giving each rank only its own shards and
streaming owned points from disk at startup (``src/distributed_query_
benchmark.h:48-84``); no machine ever holds the whole base. The single-device
analog: the base stays on the host (a ``np.memmap`` or a
:class:`~gpann_tpu_torch.search.relayout.ShardMajorStore`), only the small
router is resident on the device, and an evaluation pass streams each probed
shard through the device exactly once: upload the shard's rows, scan every
query that probes it, scatter the candidates into per-(query, probe-slot)
tables, and do one vectorized host merge at the end.

This is the complement of :class:`~gpann_tpu_torch.search.serve.ServingEngine`
(which keeps all shard windows resident): the price of exactness over a base
that does not fit is one upload of every probed shard per evaluation batch,
so a pass is amortized by batching many queries, exactly like the reference
amortizes disk streaming over its query set.

PyTorch runs eagerly, so nothing is padded to bound a count of compiled
programs: a block is uploaded with its real rows (the bin-top-2 kernel masks
by ``n_valid`` and covers the last partial 128-row bin itself) and the
queries of a shard go up as they are. ``stats["bytes_uploaded"]`` counts the
bytes really copied.

Every block goes through a ring of two staging slots (:class:`_Staging`),
made at first use and kept across passes: the host read copies a block's
rows straight into a slot's host buffer (no fresh array a block), the upload
copies that buffer into the slot's device block, and the scan reads the
device block. On a CUDA device the host buffers are page-locked and the
upload is an asynchronous copy on a copy stream that the compute stream
waits on, so the host reads block ``j + 1`` while block ``j`` is copied and
scanned; a block's results come back to the host asynchronously and are
taken two blocks later. Before refilling a host buffer the host waits for the
copy that last read it; a device block is overwritten only after the scan
that last read it. On the CPU the host buffer is the block and the upload is
the identity: the same path, run in order. The rows, their order, the blocks
and the merge are those of a serial pass, so the answers are too. A store's
block is cut into contiguous row ranges that a pool of reader threads, made
with the ring, copies side by side from the shard file, each through a
memmap of its own (``np.copyto`` leaves the interpreter lock); the pass
waits for every range before the upload.

With a recorder installed (:func:`gpann_tpu_torch.core.profiling.recording`)
a pass records the spans ``stream.pass`` (one batch id a pass) and, inside
it, ``stream.route``, then per block ``stream.gather`` (the host read into
the staging buffer; a shard's first block also looks up what to read),
``stream.upload`` (the copy's enqueue and any wait for the other host
buffer to come free) and ``stream.scan`` (from the compute stream's wait on
the copy: the scan, phase 2 and the enqueue of the results' copy to the
host), and ``stream.merge``; the spans are disjoint in host time. Counters:
``stream.bytes_read``, ``stream.bytes_uploaded``
(``stats["bytes_uploaded"]``), ``stream.blocks_binned``,
``stream.blocks_exact``, ``stream.b2_pair_rows`` (query rows times real rows
of each binned block), ``stream.blocks_staged`` (blocks through the staging
ring), ``stream.staging_waits`` (refills whose host buffer's copy was
still in flight) and ``stream.fill_parts`` (the row ranges each block's fill
ran as: one a block outside a store). Without one, each call site only reads
the module global.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gpann_tpu_torch.core import profiling
from gpann_tpu_torch.core.distances import (
    Metric, assign_closest, to_device, topk_neighbors)
from gpann_tpu_torch.core.partition import Clusters
from gpann_tpu_torch.search.bin_scan import BIN, fused_topk, scan_order
from gpann_tpu_torch.search.exact import exact_rescore, scan_k
from gpann_tpu_torch.search.serve import _probe_rank

_ROUTE_CHUNK = 65536    # queries per routing step
_ASSIGN_CHUNK = 262144  # rows per sub-cluster assignment step
# share of the device's free memory one scanned block may take
_FREE_SHARE = 0.5
# threads that fill one staging buffer of a store pass side by side: one
# core is left to the host's launches and takes, and more than
# _READER_CAP read no faster from the page cache of an 8-core H100 host
_READER_CAP = 6
_READERS = max(1, min(_READER_CAP, len(os.sched_getaffinity(0)) - 1))


def _masked_rescored_topk(q_block: torch.Tensor, blk: torch.Tensor, size: int,
                          k: int, metric: Metric):
    """Exact-scan shard top-k: rows ``>= size`` masked, fp32 scan, then the
    exact f32 rescore of ``search/exact.py`` that every engine applies. The
    one-window form of :func:`gpann_tpu_torch.search.exact.blocks_topk`: a
    block of any length, scanned in ``topk_neighbors``' chunks. Returns
    ``(dists [m, k], positions [m, k])``; where the block has fewer than
    ``k`` live rows the tail is (+inf, 0)."""
    blk = blk.float()  # byte blocks widen on the device, once
    kk = scan_k(k, blk.shape[0], True)
    dscan, pos = topk_neighbors(q_block, blk, kk, metric=metric, n_valid=size)
    # padded ids of topk_neighbors (== n) must not index the block
    pos = pos.long().clamp_(max=max(blk.shape[0] - 1, 0))
    d, pos = exact_rescore(q_block, blk, dscan, pos, min(k, kk), metric)
    if kk < k:
        m = q_block.shape[0]
        d = torch.cat([d, d.new_full((m, k - kk), torch.inf)], dim=1)
        pos = torch.cat([pos, pos.new_zeros((m, k - kk))], dim=1)
    return d, pos


def _chosen_subclusters(qv: np.ndarray, cents: np.ndarray, t: int,
                        metric: Metric) -> np.ndarray:
    """Union of each probing query's ``t`` closest sub-centroids (on the
    host; [mq, n_sub_b] is tiny), ascending."""
    if metric == "mips":
        dm = 1.0 - qv @ cents.T
    else:
        dm = ((qv**2).sum(1)[:, None] + (cents**2).sum(1)[None]
              - 2.0 * (qv @ cents.T))
    t = min(t, dm.shape[1])
    top = np.argpartition(dm, t - 1, axis=1)[:, :t]
    return np.nonzero(np.bincount(top.reshape(-1),
                                  minlength=dm.shape[1]) > 0)[0]


def _copy_runs(src: np.ndarray, runs: List[Tuple[int, int]], out: np.ndarray,
               lo: int, hi: int) -> None:
    """Rows ``[lo, hi)`` of the concatenation of ``src``'s row ranges
    ``runs`` into ``out`` [hi - lo, d]."""
    at = 0
    for s, e in runs:
        a, z = max(lo, at), min(hi, at + e - s)
        if a < z:
            np.copyto(out[a - lo : z - lo], src[s + a - at : s + z - at])
        at += e - s


def _parts(lo: int, hi: int, readers: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` cut into at most ``readers`` contiguous non-empty row
    ranges of near-equal length."""
    n = hi - lo
    w = max(1, min(readers, n))
    return [(lo + n * k // w, lo + n * (k + 1) // w) for k in range(w)]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host. From a CUDA device the copy goes into page-locked
    memory and is only enqueued: read it after an event recorded behind it
    on the current stream has completed."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


class _Staging:
    """The ring of two staging slots of a streamed pass: slot ``i`` is the
    host buffer ``host[i]`` (numpy view ``views[i]``) that the read fills
    and the device block ``blocks[i]`` that the upload fills from it, each
    ``rows`` x ``d`` of the source dtype. On a CUDA device the host buffers
    are page-locked and :meth:`upload` is an asynchronous copy on a copy
    stream; on the CPU the host buffer is the block and the upload is the
    identity. With ``readers`` > 1 the ring keeps a pool of that many
    threads that fill a host buffer side by side (:meth:`fill`).

    The ring's two conditions: a host buffer is refilled only after the copy
    that last read it has ended (:meth:`wait_free`), and a device block is
    overwritten only after the scan that last read it (:meth:`upload` makes
    the copy stream wait on the event given to :meth:`scanned`)."""

    def __init__(self, rows: int, d: int, dtype: np.dtype,
                 device: torch.device, readers: int) -> None:
        self.rows = rows
        self.readers = readers
        # the threads that fill a host buffer side by side (see fill)
        self.pool = None
        if readers > 1:
            self.pool = ThreadPoolExecutor(readers, "stream-read")
        self.cuda = device.type == "cuda"
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        self.host = [torch.empty((rows, d), dtype=tdtype,
                                 pin_memory=self.cuda) for _ in range(2)]
        self.views = [h.numpy() for h in self.host]
        self.blocks = self.host
        if self.cuda:
            self.device = device
            self.stream = torch.cuda.Stream(device)
            self.blocks = [torch.empty((rows, d), dtype=tdtype, device=device)
                           for _ in range(2)]
            for blk in self.blocks:     # freed only after the copies on it
                blk.record_stream(self.stream)
        self._copied = [None, None]     # event after the copy from host[i]
        self._scanned = [None, None]    # event after the scan of blocks[i]

    def device_bytes(self) -> int:
        return sum(b.nbytes for b in self.blocks) if self.cuda else 0

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown()

    def fill(self, i: int, fill, lo: int, hi: int) -> int:
        """Fill host buffer ``i`` with the rows ``[lo, hi)`` of a read
        (``fill(out, lo, hi)``, see :meth:`StreamedShardEngine._reader`):
        with a pool, cut into :func:`_parts` that its threads read into
        disjoint rows of the buffer side by side. Returns, once every part
        has ended, the number of parts."""
        out = self.views[i]
        if self.pool is None:
            fill(out[: hi - lo], lo, hi)
            return 1
        parts = _parts(lo, hi, self.readers)
        futures = [self.pool.submit(fill, out[a - lo : z - lo], a, z)
                   for a, z in parts]
        wait(futures)
        for f in futures:
            f.result()
        return len(parts)

    def upload(self, i: int, n: int) -> torch.Tensor:
        """Enqueue the copy of slot ``i``'s first ``n`` host rows into its
        device block; returns the block's rows, which the compute stream
        may read after :meth:`ready`."""
        if self.cuda:
            with torch.cuda.stream(self.stream):
                if self._scanned[i] is not None:
                    self.stream.wait_event(self._scanned[i])
                self.blocks[i][:n].copy_(self.host[i][:n], non_blocking=True)
                self._copied[i] = torch.cuda.Event()
                self._copied[i].record(self.stream)
        return self.blocks[i][:n]

    def ready(self, i: int) -> None:
        """Make the current stream wait for slot ``i``'s copy."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self._copied[i])

    def scanned(self, i: int, event) -> None:
        """``event`` follows the last read of slot ``i``'s device block."""
        self._scanned[i] = event

    def wait_free(self, i: int) -> bool:
        """Wait until host buffer ``i`` may be refilled; True if its copy
        was still in flight."""
        ev = self._copied[i]
        if ev is None or ev.query():
            return False
        ev.synchronize()
        return True


class _ShardScan:
    """A probed shard whose blocks are in flight: its probing query rows
    ``qidx`` at probe slots ``slot``, its ids, and each block's host
    results as they are taken."""

    def __init__(self, b: int, qidx: np.ndarray, slot: np.ndarray,
                 members: np.ndarray, blocks: int) -> None:
        self.b, self.qidx, self.slot, self.members = b, qidx, slot, members
        self.blocks = blocks
        self.parts: List[Tuple[np.ndarray, np.ndarray]] = []


class _Inflight(NamedTuple):
    """One scanned block whose results are on their way to the host."""

    shard: _ShardScan
    lo: int                         # the block's first row in its shard
    dists: torch.Tensor             # [mq, k], host
    pos: torch.Tensor               # [mq, k] block-local positions, host
    perm: Optional[torch.Tensor]    # the scan's row permutation (grouped)
    events: Optional[tuple]         # CUDA: scan start, scan end, on the host


class StreamedShardEngine:
    """Routed search over a host-resident (memmap) base, one shard at a time.

    Parameters mirror :class:`ServingEngine`; ``points`` may be a
    ``np.memmap``: only the two staging slots' rows are ever materialized on
    the host, and only those rows plus the router live on the device.
    """

    def __init__(
        self,
        points,                       # array-like / np.memmap [n, d]
        clusters: Optional[Clusters],
        routing_points: np.ndarray,
        routing_labels: np.ndarray,
        metric: Metric = "l2",
        scan_mode: str = "binned",
        voting_impl: str = "exact",
        store=None,
        max_scan_rows: Optional[int] = None,
        *,
        device,
    ) -> None:
        """``store``: a :class:`~gpann_tpu_torch.search.relayout.ShardMajorStore`.
        When given, ``points``/``clusters`` may be None: each shard reads
        as ONE contiguous memmap slice (the reference's re-layout,
        ``inverted_index.h:20-41``) instead of fancy-indexing scattered rows
        out of a chunk-ordered base.

        ``scan_mode``: "binned" = the bin-top-2 scan (CUDA kernel on a CUDA
        device), "exact" = fp32 matmul + top-k + exact rescore.

        ``max_scan_rows``: most rows of one device block; a larger shard is
        scanned as consecutive row slices whose top-k lists merge on the
        host. ``None`` derives the limit from the device's free memory on
        CUDA (see :meth:`_scan_row_limit`) and means no slicing on the CPU.
        """
        if scan_mode not in ("exact", "binned"):
            raise ValueError(f"unknown scan_mode {scan_mode!r}")
        if max_scan_rows is not None and max_scan_rows < 1:
            raise ValueError(f"max_scan_rows={max_scan_rows} must be >= 1")
        self.points = points
        self.store = store
        self.metric: Metric = metric
        self.scan_mode = scan_mode
        self.voting_impl = voting_impl
        self.max_scan_rows = max_scan_rows
        self.device = torch.device(device)
        if store is not None:
            self.num_shards = store.num_shards
            self.clusters = None
            self.dim = store.d
            self.dtype = store.dtype
        else:
            self.num_shards = len(clusters)
            self.clusters: List[np.ndarray] = [
                np.asarray(c, np.int64)[scan_order(c)] for c in clusters
            ]
            self.dim = points.shape[1]
            self.dtype = np.dtype(points.dtype)
        rp = np.asarray(routing_points, np.float32)
        self.router_points = torch.tensor(rp, device=self.device)
        self.router_labels = torch.tensor(
            np.asarray(routing_labels, np.int64), device=self.device)
        # exact squared norms (f64 on the host, stored f32)
        self.router_sq = torch.tensor(
            (rp.astype(np.float64) ** 2).sum(1).astype(np.float32),
            device=self.device)
        # optional two-level structure (build_subclusters): per shard, member
        # ids grouped by sub-cluster + sub-centroids, for in-shard pruning
        self.sub_members: Optional[List[List[np.ndarray]]] = None
        self.sub_centroids: Optional[List[np.ndarray]] = None
        # store mode: sub-clusters are CONTIGUOUS local row ranges of each
        # shard file (sub-cluster-major layout, relayout.py sidecar), so
        # pruned reads slice instead of fancy-indexing
        self.sub_slices: Optional[List[np.ndarray]] = None
        if store is not None:
            side = store.load_subclusters()
            if side is not None:
                self.sub_slices, self.sub_centroids = side
        # block size -> the fixed row permutation of a grouped block's scan
        self._perms: dict = {}
        self._stage: Optional[_Staging] = None   # made by the first pass

    # -- in-shard sub-clusters (streamed-serving pruning) ----------------------
    def _subcluster_assign(self, rows, target_sub_size: int,
                           train_sample: int, seed: int, rng):
        """(sub-centroids [n_sub, d], assignment int32 [len(rows)]) of one
        shard's rows: k-means on a sample, then every row to its nearest
        sub-centroid on the device, in row chunks of the source dtype."""
        from gpann_tpu_torch.cluster.kmeans import kmeans

        nb = len(rows)
        n_sub = max(1, -(-nb // target_sub_size))
        sample = np.asarray(rows[np.sort(rng.choice(
            nb, min(train_sample, nb), replace=False))], np.float32)
        cents, _ = kmeans(sample, k=n_sub, metric=self.metric, seed=seed,
                          device=self.device)
        cents_t = to_device(cents, self.device)
        assign = np.empty(nb, np.int32)
        for s0 in range(0, nb, _ASSIGN_CHUNK):
            # byte bases upload raw chunks and widen on the device
            _, a = assign_closest(
                to_device(rows[s0 : s0 + _ASSIGN_CHUNK], self.device),
                cents_t, self.metric)
            assign[s0 : s0 + _ASSIGN_CHUNK] = a.cpu().numpy()
        return cents, assign

    def build_subclusters(
        self, target_sub_size: int = 65536, train_sample: int = 262144,
        seed: int = 555, verbose: bool = False,
    ) -> dict:
        """One streamed pass building an in-shard IVF level: each shard's
        rows k-means'd into ~``target_sub_size``-point sub-clusters.

        ``search(..., sub_nprobe=t)`` then gathers and uploads ONLY the
        union of each query's ``t`` closest sub-clusters of every probed
        shard (the TwoLevelIVF knob of ``search/two_level.py`` applied to
        the streamed path), cutting streamed bytes whenever the per-shard
        query set's locality overlaps. Returns a dict artifact (cacheable
        as npz); :meth:`load_subclusters` restores it without the pass."""
        rng = np.random.default_rng(seed)
        self.sub_members, self.sub_centroids = [], []
        for b, members in enumerate(self.clusters):
            if len(members) == 0:
                self.sub_members.append([])
                self.sub_centroids.append(np.zeros((0, self.dim), np.float32))
                continue
            rows = np.asarray(self.points[members])  # source dtype
            if len(rows) <= target_sub_size:
                self.sub_members.append([np.asarray(members, np.int64)])
                self.sub_centroids.append(
                    rows.mean(axis=0, keepdims=True).astype(np.float32))
                continue
            cents, assign = self._subcluster_assign(
                rows, target_sub_size, train_sample, seed, rng)
            subs, live_cents = [], []
            for c in range(len(cents)):
                sel = np.nonzero(assign == c)[0]
                if len(sel) == 0:
                    continue
                subs.append(np.asarray(members, np.int64)[sel])
                live_cents.append(rows[sel].mean(axis=0))
            self.sub_members.append(subs)
            self.sub_centroids.append(
                np.stack(live_cents).astype(np.float32))
            if verbose:
                print(f"# shard {b}: {len(subs)} sub-clusters", flush=True)
        return self.subcluster_artifact()

    def build_subclusters_store(
        self, target_sub_size: int = 65536, train_sample: int = 262144,
        seed: int = 555, log=None,
    ) -> None:
        """Sub-cluster-major RE-LAYOUT of a ShardMajorStore: each shard's
        rows are k-means'd into ~``target_sub_size``-point sub-clusters, the
        shard FILE is rewritten with rows grouped by sub-cluster (ids
        sidecar in lockstep), and the boundaries + sub-centroids persist as
        a store sidecar. ``search(..., sub_nprobe=t)`` then reads each
        chosen sub-cluster as one CONTIGUOUS slice: pruning composed with
        the contiguous layout, the role the in-shard HNSW's sublinear scan
        plays in the reference (``shard_searches.cpp:50-96``).

        Idempotent and restartable: re-permuting an already-grouped shard is
        still a valid within-shard permutation; the sidecar is written only
        at the end."""
        st = self.store
        rng = np.random.default_rng(seed)
        offsets, cent_l = [], []
        for b in range(st.num_shards):
            rows = st.shard_rows(b)
            nb = len(rows)
            if nb == 0:
                offsets.append(np.zeros(1, np.int64))
                cent_l.append(np.zeros((0, st.d), np.float32))
                continue
            if nb <= target_sub_size:
                offsets.append(np.asarray([0, nb], np.int64))
                cent_l.append(np.asarray(rows, np.float32)
                              .mean(0, keepdims=True))
                continue
            cents, assign = self._subcluster_assign(
                rows, target_sub_size, train_sample, seed, rng)
            order = np.argsort(assign, kind="stable")
            st.permute_shard(b, order)
            counts = np.bincount(assign, minlength=len(cents))
            live = np.nonzero(counts > 0)[0]
            offsets.append(np.concatenate(
                [[0], np.cumsum(counts[live])]).astype(np.int64))
            # recompute live centroids as true means of the (grouped) rows
            grouped = st.shard_rows(b)
            off = offsets[-1]
            cent_l.append(np.stack([
                np.asarray(grouped[off[j]: off[j + 1]], np.float32).mean(0)
                for j in range(len(live))
            ]).astype(np.float32))
            if log:
                log(f"shard {b}: {len(live)} sub-clusters regrouped")
        st.save_subclusters(offsets, cent_l)
        self.sub_slices, self.sub_centroids = offsets, cent_l

    def subcluster_artifact(self) -> dict:
        """Flat (npz-compatible) form of the sub-cluster structure."""
        flat, indptr, shard_ptr, cents = [], [0], [0], []
        for subs, sc in zip(self.sub_members, self.sub_centroids):
            for s in subs:
                flat.append(s)
                indptr.append(indptr[-1] + len(s))
            shard_ptr.append(shard_ptr[-1] + len(subs))
            cents.append(sc)
        return {
            "flat": (np.concatenate(flat) if flat else np.empty(0, np.int64)),
            "indptr": np.asarray(indptr, np.int64),
            "shard_ptr": np.asarray(shard_ptr, np.int64),
            "cents": (np.concatenate(cents) if cents
                      else np.empty((0, self.dim), np.float32)),
        }

    def load_subclusters(self, art: dict) -> None:
        """Restore :meth:`subcluster_artifact`'s dict (of either package)."""
        flat = np.asarray(art["flat"])
        indptr = np.asarray(art["indptr"])
        shard_ptr = np.asarray(art["shard_ptr"])
        cents = np.asarray(art["cents"])
        self.sub_members, self.sub_centroids = [], []
        cent_off = 0
        for b in range(self.num_shards):
            lo, hi = shard_ptr[b], shard_ptr[b + 1]
            subs = [flat[indptr[j] : indptr[j + 1]] for j in range(lo, hi)]
            self.sub_members.append(subs)
            self.sub_centroids.append(cents[cent_off : cent_off + len(subs)])
            cent_off += len(subs)

    # -- routing (device; tiny) ------------------------------------------------
    def probe_order(
        self,
        queries: np.ndarray,
        nprobes: int,
        voting_t: int = 60,
        rule: str = "min_dist",
        spann_eps: float = 0.6,
    ) -> np.ndarray:
        """[m, nprobes] probe list (dummy shard ``num_shards`` where a rule
        cuts the list short), with the semantics of ServingEngine and
        FlatRouter (``hnsw_router.h:55-104``)."""
        out = []
        for s0 in range(0, len(queries), _ROUTE_CHUNK):
            q = torch.as_tensor(
                np.asarray(queries[s0 : s0 + _ROUTE_CHUNK], np.float32),
                device=self.device)
            out.append(_probe_rank(
                q, self.router_points, self.router_labels, self.router_sq,
                s=self.num_shards, voting_t=voting_t, rule=rule,
                spann_eps=spann_eps, nprobes=nprobes, metric=self.metric,
                voting_impl=self.voting_impl).cpu().numpy())
        if not out:
            return np.empty((0, nprobes), np.int32)
        return np.concatenate(out, axis=0)

    # -- the staged shard scan -------------------------------------------------
    def _scan_row_limit(self, mq: int, itemsize: int,
                        grouped: bool = False) -> Optional[int]:
        """Most rows of one device block, or None for no limit; read once a
        pass.

        ``max_scan_rows`` when the engine was given one. Otherwise, on CUDA,
        what fits ``_FREE_SHARE`` of the device's free memory at this
        moment, the staging blocks the engine keeps counted as free: a row
        costs its raw bytes twice (the ring's two device blocks), its f32
        copy when the base is bytes, one more f32 copy when the block is
        ``grouped`` (the permuted rows, see :meth:`_scan`), and its share of
        the two [mq, 2 * rows / 128] summary arrays (f32 distances and int32
        ids), ``mq`` the most query rows of a probed shard. Shards above the
        limit scan as consecutive row slices merged on the host."""
        if self.max_scan_rows is not None:
            return self.max_scan_rows
        if self.device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(self.device)
        if self._stage is not None:
            free += self._stage.device_bytes()
        per_row = 2 * self.dim * itemsize + mq * 2 * 8 / BIN
        if itemsize != 4:
            per_row += self.dim * 4
        if grouped:
            per_row += self.dim * 4
        return max(int(_FREE_SHARE * free / per_row) // BIN * BIN, BIN)

    def _staging(self, rows: int) -> _Staging:
        """The ring, made at first use and kept across passes; made anew
        only when a pass uploads a larger block. A store's reads fill each
        host buffer over ``_READERS`` threads, made with the ring; other
        sources (an array or an array-like base, whose reads may hold the
        interpreter lock) over the calling thread alone."""
        if self._stage is None or self._stage.rows < rows:
            if self._stage is not None:
                self._stage.close()
            self._stage = None      # the old ring goes before the new one
            self._stage = _Staging(
                rows, self.dim, self.dtype, self.device,
                _READERS if self.store is not None else 1)
        return self._stage

    def takes_binned(self, size: int, k: int) -> bool:
        """Whether a block of ``size`` rows takes the binned scan:
        bin-top-2 caps candidates at 2*ceil(size/BIN); tiny blocks cannot
        fill k finite candidates and take the exact scan (the guard of
        ServingEngine._binned)."""
        return self.scan_mode == "binned" and 2 * (size // BIN + 1) >= 4 * k

    def scan_permutation(self, size: int) -> torch.Tensor:
        """The fixed row permutation (on the host) in which a grouped block
        of ``size`` rows is scanned (see :meth:`_scan`): seeded by the
        size, made once a size."""
        if size not in self._perms:
            self._perms[size] = torch.from_numpy(
                np.random.default_rng(size).permutation(size))
        return self._perms[size]

    def _scan(self, q_block: torch.Tensor, blk: torch.Tensor, k: int,
              grouped: bool):
        """Enqueue the top-k of each query row within one device block of
        ``len(blk)`` real rows: ``(dists [mq, k], block-local positions
        [mq, k], perm)``, on the device.

        ``grouped``: the block holds sub-clusters side by side (a
        sub-cluster-major store, or the union of chosen sub-clusters). Near
        neighbours then share 128-row bins, of which the binned scan keeps
        two rows each, so the binned scan runs over the block's rows in a
        fixed permutation ``perm`` (seeded by the block's size, made once a
        size) that scatters each sub-cluster over the bins; positions are
        mapped back through it when taken. (The store keeps its sub-cluster
        order on purpose, for pruned reads, so the id order of
        :func:`~gpann_tpu_torch.search.bin_scan.scan_order` is not used
        here.) The permuting gather is a second f32 copy of the block on
        the device (budgeted by :meth:`_scan_row_limit`) and falls inside
        ``device_scan_ms``."""
        size = len(blk)
        rec = profiling.RECORDER
        blk = blk.float()  # byte blocks widen on the device
        perm = None
        if self.takes_binned(size, k):
            if rec is not None:
                rec.count("stream.blocks_binned", 1)
                rec.count("stream.b2_pair_rows", q_block.shape[0] * size)
            if grouped:
                perm = self.scan_permutation(size)
                blk = blk[perm.to(self.device)]
            d, pos = fused_topk(q_block, blk, size, k, self.metric)
        else:
            if rec is not None:
                rec.count("stream.blocks_exact", 1)
            d, pos = _masked_rescored_topk(q_block, blk, size, k, self.metric)
        return d, pos, perm

    def _reader(self, b: int, qv: np.ndarray, sub_nprobe: Optional[int]):
        """How a pass reads probed shard ``b`` for its probing queries
        ``qv``: ``(fill, members, grouped)``. ``fill(out, lo, hi)`` copies
        the rows ``[lo, hi)`` of the shard's read, in the order of the
        upload, into ``out`` [hi - lo, d] of the source dtype; ``members``
        are their ids; ``grouped``: the rows lie sub-cluster by sub-cluster
        (scanned in :meth:`scan_permutation`'s order, see :meth:`_scan`).
        ``sub_nprobe``: read only the union of each query's ``sub_nprobe``
        closest sub-clusters (None: the whole shard)."""
        if self.store is not None:
            members = self.store.shard_ids(b)
        else:
            members = self.clusters[b]
        if len(members) == 0:
            return None, members, False
        # a sub-cluster-major store holds sub-clusters side by side in
        # every read of its shards, pruned or whole
        grouped = self.store is not None and self.sub_slices is not None
        if self.store is not None:
            # each call maps the shard file anew, so each reader thread
            # faults its rows in through a mapping of its own (one mapping
            # shared by the readers of a block read slower)
            store = self.store
            if sub_nprobe is not None \
                    and len(self.sub_centroids[b]) > sub_nprobe:
                # pruning COMPOSED with the contiguous layout: the store
                # is sub-cluster-major, so each chosen sub-cluster reads
                # as one contiguous slice of the shard file; members are
                # concatenated in the same order as the rows
                chosen = _chosen_subclusters(
                    qv, self.sub_centroids[b], sub_nprobe, self.metric)
                off = self.sub_slices[b]
                runs = [(int(off[c]), int(off[c + 1])) for c in chosen]
                members = np.concatenate(
                    [np.asarray(members[s:e]) for s, e in runs]
                ).astype(np.int64)
                return (lambda out, lo, hi: _copy_runs(
                    store.shard_rows(b), runs, out, lo, hi)), members, grouped
            # shard-major layout: ONE contiguous read, the reference's
            # streaming read of owned ranges
            # (distributed_query_benchmark.h:48-84)
            return (lambda out, lo, hi:
                    np.copyto(out, store.shard_rows(b)[lo:hi])), \
                members, grouped
        if sub_nprobe is not None and len(self.sub_members[b]) > sub_nprobe:
            # in-shard pruning: gather and upload ONLY the union of each
            # probing query's sub_nprobe closest sub-clusters
            chosen = _chosen_subclusters(
                qv, self.sub_centroids[b], sub_nprobe, self.metric)
            members = np.concatenate(
                [self.sub_members[b][c] for c in chosen])
            grouped = True
        # fancy-indexing reads only this shard's rows
        points = self.points
        if not isinstance(points, np.ndarray):
            return (lambda out, lo, hi:
                    np.copyto(out, points[members[lo:hi]])), members, grouped
        if not 0 <= members.min() <= members.max() < len(points):
            raise IndexError(f"shard {b} holds ids outside "
                             f"[0, {len(points)})")
        # "clip": no buffered copy (the ids were checked above)
        return (lambda out, lo, hi: np.take(points, members[lo:hi], axis=0,
                                            out=out, mode="clip")), \
            members, grouped

    def shard_block(self, b: int, qv: np.ndarray,
                    sub_nprobe: Optional[int] = None):
        """What a pass reads of probed shard ``b`` for its probing queries
        ``qv``: ``(rows, members, grouped)``, the host rows in the order of
        the upload, their ids, and whether the rows lie sub-cluster by
        sub-cluster (scanned in :meth:`scan_permutation`'s order, see
        :meth:`_scan`). ``sub_nprobe``: read only the union of each
        query's ``sub_nprobe`` closest sub-clusters (None: the whole
        shard). A pass reads the same rows, block by block, into its
        staging buffers."""
        fill, members, grouped = self._reader(b, qv, sub_nprobe)
        rows = np.empty((len(members), self.dim), self.dtype)
        if fill is not None:
            fill(rows, 0, len(members))
        return rows, members, grouped

    def _take(self, blk: _Inflight, k: int, stats: dict, tab_d: np.ndarray,
              tab_i: np.ndarray, verbose: bool) -> None:
        """Wait for a block's results on the host and keep them; once its
        shard's last block is in, merge the blocks' top-k lists (positions
        stay shard-local) and write the shard's probe slots of the
        tables."""
        if blk.events is not None:
            ev0, ev1, done = blk.events
            done.synchronize()
            stats["device_scan_ms"] += ev0.elapsed_time(ev1)
        dn, pn = blk.dists.numpy(), blk.pos.numpy()
        # inf-distance fillers may carry positions past the real rows:
        # clamp them so that members[pos] stays in bounds
        live = np.isfinite(dn)
        pn = np.where(live, pn, 0)
        if blk.perm is not None:
            pn = np.where(live, blk.perm.numpy()[pn], 0)
        sh = blk.shard
        sh.parts.append((dn, pn.astype(np.int64) + blk.lo
                         if sh.blocks > 1 else pn))
        if len(sh.parts) < sh.blocks:
            return
        if sh.blocks == 1:
            d, pos = sh.parts[0]
        else:
            dcat = np.concatenate([p[0] for p in sh.parts], axis=1)
            pcat = np.concatenate([p[1] for p in sh.parts], axis=1)
            sel = np.argsort(dcat, axis=1, kind="stable")[:, :k]
            d = np.take_along_axis(dcat, sel, axis=1)
            pos = np.take_along_axis(pcat, sel, axis=1)
        kk = min(k, len(sh.members))
        dk = d[:, :kk]
        tab_d[sh.qidx, sh.slot, :kk] = dk
        # -1 ids on inf-distance fillers: a clamped real id with inf
        # distance would inflate id-based recall (recall_from_ids
        # recomputes distances from ids)
        tab_i[sh.qidx, sh.slot, :kk] = np.where(
            np.isfinite(dk), sh.members[pos[:, :kk]], -1)
        if verbose:
            print(f"# shard {sh.b}: {len(sh.members)} pts, {len(sh.qidx)} "
                  f"queries ({stats['scan_s']:.1f}s scan)", flush=True)

    def _stream(self, queries: np.ndarray, probed: list, k: int,
                sub_nprobe: Optional[int], stats: dict, tab_d: np.ndarray,
                tab_i: np.ndarray, verbose: bool) -> None:
        """Read, upload and scan every shard ``b`` of ``probed``'s ``(b,
        qidx, slot)`` that a query row probes and that holds rows, block by
        block through the staging ring, and write the tables."""
        rec = profiling.RECORDER
        dev = self.device
        on_cuda = dev.type == "cuda"
        sizes = (self.store.sizes if self.store is not None
                 else [len(c) for c in self.clusters])
        probed = [p for p in probed if len(p[1]) and sizes[p[0]]]
        if not probed:
            return
        # the query rows of every probed shard, shard after shard, gathered
        # into one page-locked buffer and sent up in one copy
        order = np.concatenate([qidx for _, qidx, _ in probed])
        qrows = torch.empty((len(order), queries.shape[1]),
                            pin_memory=on_cuda)
        np.take(queries, order, axis=0, out=qrows.numpy(), mode="clip")
        q_all, qv = qrows.to(dev, non_blocking=True), qrows.numpy()
        stats["bytes_uploaded"] += qrows.nbytes
        at = 0
        grouped = self.sub_slices is not None or (
            sub_nprobe is not None and self.store is None)
        limit = self._scan_row_limit(max(len(q) for _, q, _ in probed),
                                     self.dtype.itemsize, grouped)
        longest = max(int(sizes[b]) for b, _, _ in probed)
        stage = self._staging(max(min(limit or longest, longest), 1))
        for i in range(2):      # a pass left unfinished may leave copies
            stage.wait_free(i)
        inflight: deque = deque()
        j = 0                   # blocks staged in this pass
        for b, qidx, slot in probed:
            t0 = time.perf_counter()
            if rec is not None:
                step = rec.begin("stream.gather", dev)
            q_block = q_all[at : at + len(qidx)]
            fill, members, grouped = self._reader(
                b, qv[at : at + len(qidx)], sub_nprobe)
            at += len(qidx)
            n = len(members)
            size = limit or n
            shard = _ShardScan(b, qidx, slot, members, -(-n // size))
            stats["shards_scanned"] += 1
            for lo in range(0, n, size):
                hi = min(lo + size, n)
                i = j % 2
                j += 1
                if lo:
                    t0 = time.perf_counter()
                    if rec is not None:
                        step = rec.begin("stream.gather", dev)
                parts = stage.fill(i, fill, lo, hi)
                if rec is not None:
                    rec.end(step, dev)
                    rec.count("stream.bytes_read",
                              (hi - lo) * self.dim * self.dtype.itemsize)
                    rec.count("stream.fill_parts", parts)
                t1 = time.perf_counter()
                stats["gather_s"] += t1 - t0
                if rec is not None:
                    step = rec.begin("stream.upload", dev)
                block = stage.upload(i, hi - lo)
                stats["bytes_uploaded"] += block.nbytes
                # the other host buffer is the next block's to fill
                waited = stage.wait_free(1 - i)
                stage.ready(i)
                t2 = time.perf_counter()
                stats["upload_s"] += t2 - t1
                if rec is not None:
                    rec.count("stream.blocks_staged", 1)
                    rec.count("stream.staging_waits", int(waited))
                    step = rec.next(step, "stream.scan", dev)
                if on_cuda:
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev0.record()
                d, pos, perm = self._scan(q_block, block, k, grouped)
                events = None
                if on_cuda:
                    ev1.record()
                    stage.scanned(i, ev1)
                d, pos = _to_host(d), _to_host(pos)
                if on_cuda:
                    done = torch.cuda.Event()
                    done.record()
                    events = (ev0, ev1, done)
                if rec is not None:
                    rec.end(step, dev)
                stats["blocks_scanned"] += 1
                inflight.append(_Inflight(shard, lo, d, pos, perm, events))
                # a block's results are taken once two more blocks have
                # been read: the host never waits for a scan just launched
                while len(inflight) > 2:
                    self._take(inflight.popleft(), k, stats, tab_d, tab_i,
                               verbose)
                stats["scan_s"] += time.perf_counter() - t1
        t0 = time.perf_counter()
        while inflight:
            self._take(inflight.popleft(), k, stats, tab_d, tab_i, verbose)
        stats["scan_s"] += time.perf_counter() - t0

    # -- full evaluation pass --------------------------------------------------
    def search(
        self,
        queries: np.ndarray,
        k: int,
        nprobes: int,
        voting_t: int = 60,
        rule: str = "min_dist",
        spann_eps: float = 0.6,
        probes: Optional[np.ndarray] = None,
        return_tables: bool = False,
        verbose: bool = False,
        shard_range: Optional[Tuple[int, int]] = None,
        sub_nprobe: Optional[int] = None,
    ):
        """One streamed pass over all probed shards.

        Returns ``(dists [m,k], ids [m,k], stats)``; with
        ``return_tables=True`` the per-probe-slot candidate tables
        ``(tab_d [m,nprobes,k], tab_i [m,nprobes,k])`` are returned instead
        of the merged top-k (slot order = probe rank, enabling
        recall-at-every-prefix from a single pass, the same trick as
        ServingEngine.recall_curve).

        ``stats``: wall seconds ``route_s``, ``gather_s`` (host reads of
        the shards' rows into the staging buffers), ``scan_s`` (the host's
        time in the uploads, the scans' launches and the taking of their
        results, of which ``upload_s`` is the copies' enqueue and the waits
        for a staging buffer), ``device_scan_ms`` (the scans alone by CUDA
        events, a grouped block's permuting gather included; 0 on the CPU),
        ``shards_scanned``, ``blocks_scanned`` (more than the shards when
        some were sliced) and ``bytes_uploaded``. Spans and counters: the
        module docstring.
        """
        rec = profiling.RECORDER
        if rec is not None:
            pass_span = rec.begin("stream.pass", self.device, root=True)
        queries = np.asarray(queries, np.float32)
        m = queries.shape[0]
        t_route = time.perf_counter()
        if probes is None:
            if rec is not None:
                step = rec.begin("stream.route", self.device)
            probes = self.probe_order(queries, nprobes, voting_t, rule,
                                      spann_eps)
            if rec is not None:
                rec.end(step, self.device)
        stats = {"route_s": time.perf_counter() - t_route, "gather_s": 0.0,
                 "scan_s": 0.0, "upload_s": 0.0, "device_scan_ms": 0.0,
                 "shards_scanned": 0, "blocks_scanned": 0,
                 "bytes_uploaded": 0}
        tab_d = np.full((m, nprobes, k), np.inf, np.float32)
        tab_i = np.full((m, nprobes, k), -1, np.int64)
        lo, hi = shard_range if shard_range else (0, self.num_shards)

        use_subs = sub_nprobe is not None and (
            self.sub_members is not None or self.sub_slices is not None)
        if sub_nprobe is not None and self.store is not None \
                and self.sub_slices is None:
            raise ValueError(
                "store has no sub-cluster sidecar: run "
                "build_subclusters_store() (sub-cluster-major relayout) "
                "before pruned search")

        probed = [(b, *np.nonzero(probes == b)) for b in range(lo, hi)]
        self._stream(queries, probed, k, sub_nprobe if use_subs else None,
                     stats, tab_d, tab_i, verbose)
        if rec is not None:
            rec.count("stream.bytes_uploaded", stats["bytes_uploaded"])
        if return_tables:
            if rec is not None:
                rec.end(pass_span, self.device)
            return tab_d, tab_i, stats
        if rec is not None:
            step = rec.begin("stream.merge", self.device)
        flat_d = tab_d.reshape(m, nprobes * k)
        flat_i = tab_i.reshape(m, nprobes * k)
        sel = np.argsort(flat_d, axis=1, kind="stable")[:, :k]
        out_d = np.take_along_axis(flat_d, sel, axis=1)
        out_i = np.take_along_axis(flat_i, sel, axis=1)
        if rec is not None:
            rec.end(step, self.device)
            rec.end(pass_span, self.device)
        return out_d, out_i, stats

    def recall_curve(
        self,
        queries: np.ndarray,
        k: int,
        kth_dist: np.ndarray,
        max_nprobes: Optional[int] = None,
        voting_t: int = 60,
        rule: str = "min_dist",
        spann_eps: float = 0.6,
        verbose: bool = False,
        sub_nprobe: Optional[int] = None,
    ) -> Tuple[np.ndarray, dict]:
        """Threshold recall@k at EVERY probe prefix 1..max_nprobes from ONE
        streamed pass (recall definition of recall.h:139-150, same tolerance
        as eval.recall.recall_from_candidate_distances)."""
        nprobes = max_nprobes or self.num_shards
        tab_d, _, stats = self.search(
            queries, k, nprobes, voting_t, rule, spann_eps,
            return_tables=True, verbose=verbose, sub_nprobe=sub_nprobe,
        )
        kth = np.asarray(kth_dist, np.float32)
        thresh = kth + 1e-5 + 1e-4 * np.abs(kth)
        hit = (tab_d <= thresh[:, None, None]).sum(axis=2)   # [m, nprobes]
        cum = np.minimum(np.cumsum(hit, axis=1), k).astype(np.float64)
        return (cum.sum(axis=0) / (k * len(queries))).astype(np.float64), stats
