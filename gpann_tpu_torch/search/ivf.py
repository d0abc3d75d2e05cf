"""Shard-major IVF index: the in-shard search engine (counterpart of
``gpann_tpu/search/ivf.py``; reference ``src/inverted_index.h``).

The base points are laid out as a padded ``[num_shards, capacity, d]`` tensor
on the index's device plus an id table; a bucket scan is one fp32
``[m, capacity]`` distance matmul, ``torch.topk`` and an exact f32 rescore
of the candidates (:func:`gpann_tpu_torch.search.exact.blocks_topk`, the
exact scan every engine shares). As in the JAX package, this is a plain
matrix product, not a hand-written kernel.

An exact scan returns the true in-shard top-k, i.e. the recall of HNSW at
``ef -> inf`` for every shard, so the hit-recording semantics
(``dist <= d_k(q)``, ``shard_searches.cpp:80-91``) carry over.

Three query paths, as in the JAX package; its ``lax.scan`` bodies become
loops over shards or over steps of query blocks:

- :meth:`IVFIndex.search_all_shards` — every query against every shard,
  per-(shard, query) top-k (``shard_searches.cpp:21-96``).
- :meth:`IVFIndex.search_probed` — dense path: a running top-k over all
  shards, each shard meeting only the queries that probe it
  (:func:`_scan_probed_dense`, also the local scan of the multi-rank
  engines of ``gpann_tpu_torch.dist``).
- :meth:`IVFIndex.search_probed_grouped` — grouped path: the (query, shard)
  probe pairs are sorted by shard on the host, padded into fixed query
  blocks, and only probed pairs are computed, many blocks per batched
  matmul.

Each scan step holds f32 distance tiles of at most ``TILE_BYTES``; queries
are split into row chunks, and query blocks into steps, to stay under it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpann_tpu_torch.core.distances import Metric, to_device
from gpann_tpu_torch.core.partition import Clusters
from gpann_tpu_torch.search.exact import (TILE_BYTES, blocks_per_step,
                                          blocks_topk, round_up, shard_bias)


def _row_chunk(cap: int) -> int:
    """Query rows per scan step so that a [rows, cap] f32 tile fits
    ``TILE_BYTES``."""
    return max(1, TILE_BYTES // (4 * cap))


def _merge_topk(best_d: torch.Tensor, best_i: torch.Tensor, d: torch.Tensor,
                i: torch.Tensor, k: int):
    """Running top-k merge; on equal distances the earlier entry wins (the
    order of ``lax.top_k``)."""
    cat_d = torch.cat([best_d, d], dim=1)
    cat_i = torch.cat([best_i, i], dim=1)
    sd, order = torch.sort(cat_d, dim=1, stable=True)
    return sd[:, :k], cat_i.gather(1, order[:, :k])


def _scan_probed_dense(queries: torch.Tensor, probes: torch.Tensor,
                       shard_points: torch.Tensor, shard_sizes: torch.Tensor,
                       shard_ids: torch.Tensor, k: int, metric: Metric,
                       shard_offset: int = 0, rescore: bool = True,
                       bias: Optional[torch.Tensor] = None):
    """Running top-k over a ``[s, cap, d]`` stack of shards: query q meets
    shard b only where ``shard_offset + b`` appears in ``probes[q]``; rows
    at or past a shard's size never count. Returns device tensors (dists
    [m, k], global ids [m, k] int32); (+inf, -1) where fewer than k rows
    were met. The counterpart of ``gpann_tpu/search/ivf.py::
    _scan_probed_dense`` and of the local scan of ``gpann_tpu/dist/mesh.py``
    (``shard_offset``: the global id of this stack's first shard). An
    index that holds the stack's ``shard_bias`` passes it as ``bias``;
    otherwise each visited shard's is computed.

    The JAX scan masks every query that does not probe a shard; here each
    shard meets only the queries that probe it (in row chunks under
    ``TILE_BYTES``), and shards that none probes or that are empty are
    skipped: a masked row adds only +inf candidates, which the merge drops,
    so the result is the same. The (shard, query) pairs are found at once,
    with two waits for the device a call rather than one a shard: where
    several processes share a device, each wait can last a time slice of
    the others."""
    m = queries.shape[0]
    dev = queries.device
    s, cap = shard_points.shape[:2]
    best_d = torch.full((m, k), torch.inf, device=dev)
    best_i = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    # hit[q, b]: query q probes local shard b (column s takes the rest)
    local = probes.to(dev).long() - shard_offset
    local = torch.where((local >= 0) & (local < s), local, s)
    hit = torch.zeros((m, s + 1), dtype=torch.bool, device=dev).scatter_(
        1, local, True)[:, :s] & (shard_sizes > 0)[None, :]
    pairs = torch.nonzero(hit.T)[:, 1]  # queries, shard by shard
    step = _row_chunk(cap)
    start = 0
    for b, count in enumerate(hit.sum(dim=0).tolist()):
        rows, start = pairs[start : start + count], start + count
        if count == 0:
            continue
        sel = slice(b, b + 1)
        b_bias = (shard_bias(shard_points[sel], shard_sizes[sel], metric)
                  if bias is None else bias[sel])
        for r0 in range(0, count, step):
            r = rows[r0 : r0 + step]
            d, i = blocks_topk(queries[r][None], shard_points[sel], b_bias,
                               shard_ids[sel], k, metric, rescore)
            best_d[r], best_i[r] = _merge_topk(best_d[r], best_i[r], d[0],
                                               i[0], k)
    if metric == "l2":
        best_d = best_d.clamp(min=0.0)  # +inf stays +inf
    return best_d, best_i


class IVFIndex:
    """Shard-major inverted file over a clustering of the base points,
    resident on ``device``.

    ``rescore=False`` ranks by the scan's distances alone. The JAX index's
    ``precision`` argument (the TPU's matmul pass count) has no counterpart:
    the scan is fp32 with TF32 off."""

    def __init__(
        self,
        points: np.ndarray,
        clusters: Clusters,
        metric: Metric = "l2",
        pad_multiple: int = 128,
        rescore: bool = True,
        *,
        device,
    ) -> None:
        self.metric: Metric = metric
        self.rescore = rescore
        self.device = torch.device(device)
        self.num_shards = len(clusters)
        self.dim = points.shape[1]
        sizes = np.asarray([len(c) for c in clusters], dtype=np.int32)
        cap = round_up(max(int(sizes.max()), 1), pad_multiple)
        self.capacity = cap
        blocks = torch.zeros((self.num_shards, cap, self.dim),
                             dtype=torch.float32, device=self.device)
        ids = np.full((self.num_shards, cap), -1, dtype=np.int32)
        for b, members in enumerate(clusters):
            members = np.asarray(members, dtype=np.int64)
            if len(members):
                blocks[b, : len(members)] = to_device(points[members],
                                                      self.device)
            ids[b, : len(members)] = members
        self.shard_points = blocks
        self.shard_sizes = torch.as_tensor(sizes).to(self.device)
        self._bias = shard_bias(blocks, self.shard_sizes, metric)  # [s, cap]
        self.shard_ids = torch.as_tensor(ids).to(self.device)
        self.sizes_np = sizes
        # overlap detection: dedup across probes is only needed when some
        # point belongs to more than one cluster
        all_ids = (
            np.concatenate([np.asarray(c) for c in clusters if len(c)])
            if any(len(c) for c in clusters)
            else np.empty(0, np.int32)
        )
        self.overlapping = len(np.unique(all_ids)) < len(all_ids)

    def _blocks_topk(self, qs: torch.Tensor, shards, k: int):
        """Top-k of query blocks ``qs`` [c, r, d], block j within shard
        ``shards[j]``: (dists [c, r, k], global ids [c, r, k]).

        ``shards`` is an int (one shard, read in place; c = 1) or an int64
        tensor [c] (those shards' rows are gathered)."""
        sel = slice(shards, shards + 1) if isinstance(shards, int) else shards
        return blocks_topk(qs, self.shard_points[sel], self._bias[sel],
                           self.shard_ids[sel], k, self.metric, self.rescore)

    def _finish(self, d: torch.Tensor, i: torch.Tensor):
        if self.metric == "l2":
            d = d.clamp(min=0.0)  # +inf stays +inf
        return d.cpu().numpy(), i.cpu().numpy()

    # -- evaluation path ----------------------------------------------------
    def search_all_shards(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-(shard, query) exact top-k: (dists [s, m, k], ids [s, m, k])."""
        qs = to_device(queries, self.device)
        m = qs.shape[0]
        out_d = torch.empty((self.num_shards, m, k), device=self.device)
        out_i = torch.empty((self.num_shards, m, k), dtype=torch.int32,
                            device=self.device)
        step = _row_chunk(self.capacity)
        for b in range(self.num_shards):
            for s in range(0, m, step):
                d, i = self._blocks_topk(qs[None, s : s + step], b, k)
                out_d[b, s : s + step], out_i[b, s : s + step] = d[0], i[0]
        return self._finish(out_d, out_i)

    # -- serving paths -------------------------------------------------------
    def search_probed(
        self, queries: np.ndarray, probes: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense path. ``probes`` [m, nprobes] shard ids (use -1 padding)."""
        d, i = _scan_probed_dense(
            to_device(queries, self.device),
            torch.as_tensor(np.asarray(probes, np.int32)), self.shard_points,
            self.shard_sizes, self.shard_ids, k, self.metric,
            rescore=self.rescore, bias=self._bias)
        return d.cpu().numpy(), i.cpu().numpy()

    def search_probed_grouped(
        self,
        queries: np.ndarray,
        probes: np.ndarray,
        k: int,
        query_block: int = 256,
        dedup: Optional[bool] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Grouped path: compute only probed (query, shard) pairs.

        As in the JAX package, the (query, shard) probe pairs are sorted by
        shard on the host and each shard's run is padded into blocks of
        ``query_block`` pair rows. The blocks are scanned as batched
        matmuls, as many per step as fit ``TILE_BYTES`` (so an index of many
        small shards costs a few steps, not one per shard), and the results
        are scattered back into a [m, nprobes*k] candidate table merged by
        one sort. Id dedup across probes (only possible with overlapping
        clusters) runs only when the index was built from an overlapping
        clustering.
        """
        queries = np.asarray(queries, dtype=np.float32)
        m, nprobes = probes.shape
        dedup = self.overlapping if dedup is None else dedup

        # flatten (query, shard) pairs, drop -1 pads, sort by shard
        flat_q = np.repeat(np.arange(m, dtype=np.int64), nprobes)
        flat_slot = np.tile(np.arange(nprobes, dtype=np.int64), m)
        flat_b = probes.reshape(-1).astype(np.int64)
        keep = flat_b >= 0
        flat_q, flat_slot, flat_b = flat_q[keep], flat_slot[keep], flat_b[keep]
        order = np.argsort(flat_b, kind="stable")
        flat_q, flat_slot, flat_b = flat_q[order], flat_slot[order], flat_b[order]
        if len(flat_q) == 0:
            return (
                np.full((m, k), np.inf, np.float32),
                np.full((m, k), -1, np.int32),
            )

        # pad each shard's run to a multiple of query_block (vectorized)
        qb = query_block
        counts = np.bincount(flat_b, minlength=self.num_shards)
        blocks = -(-counts // qb)
        starts = np.concatenate([[0], np.cumsum(blocks * qb)])[:-1]
        run_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        # position of each pair within the padded layout
        pos = starts[flat_b] + (np.arange(len(flat_b)) - run_starts[flat_b])
        nb = int(blocks.sum())
        pair_q = np.zeros(nb * qb, dtype=np.int64)  # padding rows: query 0
        pair_q[pos] = flat_q
        block_shard = np.repeat(np.arange(self.num_shards), blocks)

        qs = to_device(queries, self.device)
        rows = qs[torch.as_tensor(pair_q).to(self.device)].view(nb, qb, -1)
        block_shard = torch.as_tensor(block_shard).to(self.device)
        d = torch.empty((nb, qb, k), device=self.device)
        i = torch.empty((nb, qb, k), dtype=torch.int32, device=self.device)
        step = blocks_per_step(self.capacity, qb, self.dim)
        for s in range(0, nb, step):
            d[s : s + step], i[s : s + step] = self._blocks_topk(
                rows[s : s + step], block_shard[s : s + step], k)
        live = torch.as_tensor(pos).to(self.device)
        d, i = self._finish(d.view(-1, k)[live], i.view(-1, k)[live])

        # scatter into the per-query candidate table (one fancy index)
        out_d = np.full((m, nprobes, k), np.inf, dtype=np.float32)
        out_i = np.full((m, nprobes, k), -1, dtype=np.int32)
        out_d[flat_q, flat_slot] = d
        out_i[flat_q, flat_slot] = i
        out_d = out_d.reshape(m, nprobes * k)
        out_i = out_i.reshape(m, nprobes * k)
        if dedup:
            # mask duplicate ids (overlapping shards may return one point twice)
            sort = np.argsort(out_i, axis=1, kind="stable")
            sorted_i = np.take_along_axis(out_i, sort, axis=1)
            dup_sorted = np.zeros_like(sorted_i, dtype=bool)
            dup_sorted[:, 1:] = (sorted_i[:, 1:] == sorted_i[:, :-1]) & (
                sorted_i[:, 1:] >= 0
            )
            dup = np.zeros_like(dup_sorted)
            np.put_along_axis(dup, sort, dup_sorted, axis=1)
            # keep the closest occurrence: duplicates share distance; masking
            # all-but-one by sorted order is id-stable
            out_d = np.where(dup, np.inf, out_d)
        sel = np.argsort(out_d, axis=1, kind="stable")[:, :k]
        return (
            np.take_along_axis(out_d, sel, axis=1),
            np.take_along_axis(out_i, sel, axis=1),
        )


def hits_per_shard(
    shard_dists: np.ndarray, kth_dist: np.ndarray, eps: float = 1e-5,
    rel_eps: float = 1e-4,
) -> np.ndarray:
    """Hit counts per (shard, query): returned points with dist <= d_k(q)
    (reference hit recording, shard_searches.cpp:80-91). The relative term
    absorbs f32 summation-order noise between GT and search kernels."""
    thresh = kth_dist[None, :, None] * (1.0 + rel_eps) + eps
    return (shard_dists <= thresh).sum(axis=2).astype(np.int32)


def merge_shard_topk(
    shard_dists: np.ndarray,
    shard_ids: np.ndarray,
    probe_order: np.ndarray,
    nprobes: int,
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-shard top-k results along each query's probe order.

    ``shard_dists/ids`` are [s, m, k] from :meth:`search_all_shards`;
    ``probe_order`` is [m, s] shard ids by priority. Deduplicates point ids
    (overlapping shards may return the same point, mirroring the dedup in
    small_scale_queries.cpp:158-165). Returns ([m,k] dists, [m,k] ids).
    """
    s, m, kk = shard_dists.shape
    probed = probe_order[:, :nprobes]  # [m, nprobes]
    qidx = np.arange(m)[:, None]
    cand_d = shard_dists[probed, qidx, :].reshape(m, -1)
    cand_i = shard_ids[probed, qidx, :].reshape(m, -1)
    # dedup ids keeping the closest occurrence, fully vectorized: sort each
    # row by (id, dist) via two stable argsorts, mask adjacent duplicates,
    # scatter the mask back, then take the k smallest surviving distances
    o1 = np.argsort(cand_d, axis=1, kind="stable")
    i1 = np.take_along_axis(cand_i, o1, axis=1)
    o2 = np.argsort(i1, axis=1, kind="stable")
    ordix = np.take_along_axis(o1, o2, axis=1)
    sids = np.take_along_axis(cand_i, ordix, axis=1)
    dup_sorted = np.zeros_like(sids, dtype=bool)
    dup_sorted[:, 1:] = (sids[:, 1:] == sids[:, :-1]) & (sids[:, 1:] >= 0)
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, ordix, dup_sorted, axis=1)
    cand_d = np.where(dup | (cand_i < 0), np.inf, cand_d)
    order = np.argsort(cand_d, axis=1, kind="stable")[:, :k]
    out_d = np.take_along_axis(cand_d, order, axis=1).astype(np.float32)
    sel_i = np.take_along_axis(cand_i, order, axis=1)
    out_i = np.where(np.isfinite(out_d), sel_i, -1).astype(np.int32)
    out_d = np.where(np.isfinite(out_d), out_d, np.inf).astype(np.float32)
    return out_d, out_i
