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
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from gpann_tpu_torch.core.distances import (
    Metric, assign_closest, to_device, topk_neighbors)
from gpann_tpu_torch.core.partition import Clusters
from gpann_tpu_torch.search.bin_scan import BIN, fused_topk
from gpann_tpu_torch.search.ivf import _exact_rescore, _scan_k
from gpann_tpu_torch.search.serve import _probe_rank

_ROUTE_CHUNK = 65536    # queries per routing step
_ASSIGN_CHUNK = 262144  # rows per sub-cluster assignment step
# share of the device's free memory one scanned block may take
_FREE_SHARE = 0.5


def _masked_rescored_topk(q_block: torch.Tensor, blk: torch.Tensor, size: int,
                          k: int, metric: Metric):
    """Exact-scan shard top-k: rows ``>= size`` masked, fp32 scan, then the
    exact f32 rescore that the resident engine and ``fused_topk`` apply too.
    Returns ``(dists [m, k], positions [m, k])``; where the block has fewer
    than ``k`` live rows the tail is (+inf, 0)."""
    blk = blk.float()  # byte blocks widen on the device, once
    kk = _scan_k(k, blk.shape[0], True)
    dscan, pos = topk_neighbors(q_block, blk, kk, metric=metric, n_valid=size)
    # padded ids of topk_neighbors (== n) must not index the block
    pos = pos.long().clamp_(max=max(blk.shape[0] - 1, 0))
    d, pos = _exact_rescore(q_block, blk, dscan, pos, min(k, kk), metric)
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


class StreamedShardEngine:
    """Routed search over a host-resident (memmap) base, one shard at a time.

    Parameters mirror :class:`ServingEngine`; ``points`` may be a
    ``np.memmap``: only one shard's rows are ever materialized on the host,
    and only those rows plus the router live on the device.
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
        else:
            self.num_shards = len(clusters)
            self.clusters: List[np.ndarray] = [
                np.asarray(c, np.int64) for c in clusters
            ]
            self.dim = points.shape[1]
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

    # -- one shard scan --------------------------------------------------------
    def _scan_row_limit(self, mq: int, itemsize: int) -> Optional[int]:
        """Most rows of one device block, or None for no limit.

        ``max_scan_rows`` when the engine was given one. Otherwise, on CUDA,
        what fits ``_FREE_SHARE`` of the device's free memory at this
        moment: a row costs its raw bytes, its f32 copy when the base is
        bytes, and its share of the two [mq, 2 * rows / 128] summary arrays
        (f32 distances and int32 ids). Shards above the limit scan as
        consecutive row slices merged on the host."""
        if self.max_scan_rows is not None:
            return self.max_scan_rows
        if self.device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(self.device)
        per_row = self.dim * itemsize + mq * 2 * 8 / BIN
        if itemsize != 4:
            per_row += self.dim * 4
        return max(int(_FREE_SHARE * free / per_row) // BIN * BIN, BIN)

    def _scan_shard(
        self, q_block: torch.Tensor, shard_rows: np.ndarray, k: int,
        stats: dict,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k of each query row within one shard, slicing shards larger
        than the row limit into consecutive blocks whose per-block top-k
        merge on the host (positions stay shard-local)."""
        size = len(shard_rows)
        limit = self._scan_row_limit(q_block.shape[0],
                                     shard_rows.dtype.itemsize)
        if limit is None or size <= limit:
            return self._scan_block(q_block, shard_rows, k, stats)
        parts_d, parts_p = [], []
        for lo in range(0, size, limit):
            d, p = self._scan_block(q_block, shard_rows[lo : lo + limit], k,
                                    stats)
            parts_d.append(d)
            parts_p.append(p.astype(np.int64) + lo)
        dcat = np.concatenate(parts_d, axis=1)
        pcat = np.concatenate(parts_p, axis=1)
        sel = np.argsort(dcat, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(dcat, sel, axis=1),
                np.take_along_axis(pcat, sel, axis=1))

    def _scan_block(
        self, q_block: torch.Tensor, rows: np.ndarray, k: int, stats: dict,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k ``(dists [mq, k], block-local positions [mq, k])`` of each
        query row within one device block of ``len(rows)`` real rows."""
        size = len(rows)
        on_cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        # the source dtype goes up: byte bases widen on the device
        blk = to_device(rows, self.device)
        if on_cuda:
            torch.cuda.synchronize(self.device)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        stats["upload_s"] += time.perf_counter() - t0
        stats["bytes_uploaded"] += rows.nbytes
        # bin-top-2 caps candidates at 2*ceil(size/BIN); tiny shards cannot
        # fill k finite candidates and take the exact scan (the guard of
        # ServingEngine._binned)
        if self.scan_mode == "binned" and 2 * (size // BIN + 1) >= 4 * k:
            d, pos = fused_topk(q_block, blk, size, k, self.metric)
        else:
            d, pos = _masked_rescored_topk(q_block, blk, size, k, self.metric)
        if on_cuda:
            ev1.record()
        dn, pn = d.cpu().numpy(), pos.cpu().numpy()
        if on_cuda:
            stats["device_scan_ms"] += ev0.elapsed_time(ev1)
        stats["blocks_scanned"] += 1
        # inf-distance fillers may carry positions past the real rows:
        # clamp them so the callers' members[pos] stays in bounds
        return dn, np.where(np.isfinite(dn), pn, 0)

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
        the shards' rows), ``scan_s`` (upload + scan + read-back, of which
        ``upload_s`` is the host-to-device copy), ``device_scan_ms`` (the
        scans alone by CUDA events; 0 on the CPU), ``shards_scanned``,
        ``blocks_scanned`` (more than the shards when some were sliced) and
        ``bytes_uploaded``.
        """
        queries = np.asarray(queries, np.float32)
        m = queries.shape[0]
        t_route = time.perf_counter()
        if probes is None:
            probes = self.probe_order(queries, nprobes, voting_t, rule,
                                      spann_eps)
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

        for b in range(lo, hi):
            if self.store is not None:
                members = self.store.shard_ids(b)
            else:
                members = self.clusters[b]
            if len(members) == 0:
                continue
            qidx, slot = np.nonzero(probes == b)
            if len(qidx) == 0:
                continue
            t0 = time.perf_counter()
            if self.store is not None:
                srows = self.store.shard_rows(b)
                if use_subs and len(self.sub_centroids[b]) > sub_nprobe:
                    # pruning COMPOSED with the contiguous layout: the store
                    # is sub-cluster-major, so each chosen sub-cluster reads
                    # as one contiguous slice of the shard file; members are
                    # concatenated in the same order as the rows
                    chosen = _chosen_subclusters(
                        queries[qidx], self.sub_centroids[b], sub_nprobe,
                        self.metric)
                    off = self.sub_slices[b]
                    rows = np.concatenate(
                        [srows[off[c]: off[c + 1]] for c in chosen])
                    members = np.concatenate(
                        [np.asarray(members[off[c]: off[c + 1]])
                         for c in chosen]).astype(np.int64)
                else:
                    # shard-major layout: ONE contiguous read, the
                    # reference's streaming read of owned ranges
                    # (distributed_query_benchmark.h:48-84)
                    rows = np.array(srows)
            elif use_subs and len(self.sub_members[b]) > sub_nprobe:
                # in-shard pruning: gather and upload ONLY the union of each
                # probing query's sub_nprobe closest sub-clusters
                chosen = _chosen_subclusters(
                    queries[qidx], self.sub_centroids[b], sub_nprobe,
                    self.metric)
                members = np.concatenate(
                    [self.sub_members[b][c] for c in chosen])
                rows = np.asarray(self.points[members])
            else:
                # memmap fancy-index: reads only this shard's rows
                rows = np.asarray(self.points[members])
            stats["gather_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            mq = len(qidx)
            qb = queries[qidx]
            d, pos = self._scan_shard(
                torch.as_tensor(qb, device=self.device), rows, k, stats)
            stats["scan_s"] += time.perf_counter() - t0
            stats["shards_scanned"] += 1
            stats["bytes_uploaded"] += qb.nbytes
            kk = min(k, len(members))
            dk = d[:, :kk]
            tab_d[qidx, slot, :kk] = dk
            # -1 ids on inf-distance fillers: a clamped real id with inf
            # distance would inflate id-based recall (recall_from_ids
            # recomputes distances from ids)
            tab_i[qidx, slot, :kk] = np.where(
                np.isfinite(dk), members[pos[:, :kk]], -1
            )
            if verbose:
                print(f"# shard {b}: {len(members)} pts, {mq} queries "
                      f"({stats['scan_s']:.1f}s scan)", flush=True)
        if return_tables:
            return tab_d, tab_i, stats
        flat_d = tab_d.reshape(m, nprobes * k)
        flat_i = tab_i.reshape(m, nprobes * k)
        sel = np.argsort(flat_d, axis=1, kind="stable")[:, :k]
        return (
            np.take_along_axis(flat_d, sel, axis=1),
            np.take_along_axis(flat_i, sel, axis=1),
            stats,
        )

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
