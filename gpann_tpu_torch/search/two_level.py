"""Two-level sharded search: the ef-sweep-equivalent in-shard knob
(counterpart of ``gpann_tpu/search/two_level.py``).

The reference sweeps HNSW ``ef_search`` in {50..500} per shard
(``shard_searches.cpp:13``) to trade in-shard work against recall. An exact
scan has no such knob; the knob here is **IVF inside the shard**: each
shard is balanced-k-means'd into sub-clusters of ~``target_sub_size``
points; a query probing a shard scans only its ``sub_nprobe`` closest
sub-clusters. ``sub_nprobe`` sweeps coverage from ~1/n_sub of the shard to
the full (exact) shard — the same recall/work curve role as ``ef_search``.

The sub-clusters of ALL shards form one fine-grained
:class:`~gpann_tpu_torch.search.ivf.IVFIndex`; ``shard_of_sub`` maps
sub-cluster -> shard; per-query sub-probe lists are derived from (shard
probe order x sub-centroid ranking).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from gpann_tpu_torch.cluster.kmeans import balanced_kmeans
from gpann_tpu_torch.core.distances import Metric, pairwise_distances, to_device
from gpann_tpu_torch.core.partition import Clusters
from gpann_tpu_torch.search.ivf import IVFIndex


class TwoLevelIVF:
    """Shard -> sub-cluster hierarchy with a sub_nprobe search budget,
    resident on ``device`` (the sub-cluster k-means runs there too)."""

    def __init__(
        self,
        points: np.ndarray,
        clusters: Clusters,
        metric: Metric = "l2",
        target_sub_size: int = 4096,
        sub_eps: float = 0.3,
        seed: int = 555,
        rescore: bool = True,
        *,
        device,
    ) -> None:
        self.metric: Metric = metric
        self.device = torch.device(device)
        self.num_shards = len(clusters)
        sub_clusters: List[np.ndarray] = []
        shard_of_sub: List[int] = []
        sub_centroids: List[np.ndarray] = []
        for b, members in enumerate(clusters):
            members = np.asarray(members, np.int64)
            if len(members) == 0:
                continue
            n_sub = max(1, int(np.ceil(len(members) / target_sub_size)))
            if n_sub == 1:
                assign = np.zeros(len(members), np.int32)
            else:
                _, assign = balanced_kmeans(
                    points[members], k=n_sub, eps=sub_eps, metric=metric,
                    seed=seed + b, device=self.device,
                )
            for c in range(n_sub):
                sub = members[assign == c]
                if len(sub) == 0:
                    continue
                sub_clusters.append(sub.astype(np.int32))
                shard_of_sub.append(b)
                sub_centroids.append(points[sub].mean(axis=0))
        self.sub_clusters = sub_clusters
        self.shard_of_sub = np.asarray(shard_of_sub, np.int32)
        self.sub_centroids = np.stack(sub_centroids).astype(np.float32)
        if metric == "mips":
            norms = np.sqrt(np.maximum((self.sub_centroids ** 2).sum(1), 1e-12))
            self.sub_centroids = self.sub_centroids / norms[:, None]
        self.num_subs = len(sub_clusters)
        self.max_subs_per_shard = int(
            np.bincount(self.shard_of_sub, minlength=self.num_shards).max()
        )
        self._sub_centroids_dev = to_device(self.sub_centroids, self.device)
        # [num_shards + 1, max_subs] sub-cluster ids of each shard, -1 padded;
        # the last row (all -1) stands for the -1 probe pad
        counts = np.bincount(self.shard_of_sub, minlength=self.num_shards)
        first = np.concatenate([[0], np.cumsum(counts)])[:-1]
        order = np.argsort(self.shard_of_sub, kind="stable")
        slot = np.arange(self.num_subs) - first[self.shard_of_sub[order]]
        table = np.full((self.num_shards + 1, self.max_subs_per_shard), -1,
                        np.int64)
        table[self.shard_of_sub[order], slot] = order
        self._subs_of_shard = torch.as_tensor(table).to(self.device)
        self.ivf = IVFIndex(points, sub_clusters, metric=metric,
                            rescore=rescore, device=self.device)

    # -- probe derivation ------------------------------------------------------
    def sub_probes(
        self, queries: np.ndarray, shard_probes: np.ndarray, sub_nprobe: int
    ) -> np.ndarray:
        """[m, nprobes*sub_nprobe] sub-cluster ids: for each probed shard, the
        query's ``sub_nprobe`` closest sub-centroids of that shard (-1 pad).

        All probe slots at once on the device: each slot gathers the
        distances to its shard's sub-centroids from the per-shard table and
        sorts them (equal distances keep the lower sub-cluster id)."""
        m, nprobes = shard_probes.shape
        # rank all sub-centroids per query (small matmul: num_subs is small)
        dm = pairwise_distances(to_device(queries, self.device),
                                self._sub_centroids_dev, self.metric)
        probes = torch.as_tensor(np.asarray(shard_probes, np.int64)).to(
            self.device)
        probes = torch.where(probes < 0, self.num_shards, probes)
        cand = self._subs_of_shard[probes]                 # [m, nprobes, w]
        d = dm.gather(1, cand.clamp(min=0).view(m, -1)).view(cand.shape)
        d = d.masked_fill(cand < 0, torch.inf)
        take = min(sub_nprobe, self.num_subs, cand.shape[2])
        sd, order = torch.sort(d, dim=2, stable=True)
        sel = cand.gather(2, order[:, :, :take])
        sel = sel.masked_fill(~torch.isfinite(sd[:, :, :take]), -1)
        out = torch.full((m, nprobes, sub_nprobe), -1, dtype=torch.int64,
                         device=self.device)
        out[:, :, :take] = sel
        return out.view(m, -1).to(torch.int32).cpu().numpy()

    # -- serving ----------------------------------------------------------------
    def search(
        self,
        queries: np.ndarray,
        shard_probes: np.ndarray,
        k: int,
        sub_nprobe: int,
        grouped: bool = True,
        query_block: int = 256,
    ) -> Tuple[np.ndarray, np.ndarray]:
        sp = self.sub_probes(queries, shard_probes, sub_nprobe)
        if grouped:
            return self.ivf.search_probed_grouped(queries, sp, k, query_block)
        return self.ivf.search_probed(queries, sp, k)

    # -- evaluation: per-(shard, query) results at a given sub_nprobe -----------
    def search_all_shards(
        self, queries: np.ndarray, k: int, sub_nprobe: int,
        query_block: int = 256,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """[s, m, k] per-shard results where each query probes its
        ``sub_nprobe`` best sub-clusters per shard — the ef-sweep analog of
        the reference's all-(shard, query) measurement
        (shard_searches.cpp:21-96)."""
        m = queries.shape[0]
        out_d = np.full((self.num_shards, m, k), np.inf, np.float32)
        out_i = np.full((self.num_shards, m, k), -1, np.int32)
        for b in range(self.num_shards):
            probes = np.full((m, 1), b, np.int32)
            d, i = self.search(queries, probes, k, sub_nprobe,
                               grouped=True, query_block=query_block)
            out_d[b], out_i[b] = d, i
        return out_d, out_i
