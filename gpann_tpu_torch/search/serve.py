"""Resident serving engine: route + group + scan + merge (counterpart of
``gpann_tpu/search/serve.py``).

Each batch of queries goes through four steps on the engine's device:

1. **Route**: distances to the routing points, top-T vote fold (scatter-min /
   scatter-add) and probe ranking under one of the four probe rules of
   ``hnsw_router.h:55-104``. Rules that cut the probe list short point those
   slots at a dummy shard ``num_shards`` whose size is 0.
2. **Group**: the (query, shard) probe pairs are sorted by shard and packed
   into ``query_block``-row blocks with static worst-case shapes
   (``ceil(m*nprobes/qb) + num_shards + 1`` blocks).
3. **Scan**: ``scan_mode="binned"`` scans every block against its shard's
   window of one flat resident base in one bin-top-2 launch
   (:func:`gpann_tpu_torch.search.bin_scan.fused_topk_blocks`);
   ``"exact"`` scans the blocks against their gathered shard windows, many
   blocks per batched matmul, with an exact rescore
   (:func:`gpann_tpu_torch.search.exact.blocks_topk`, the exact scan of
   every engine; the rescore's distance formula lives there too).
4. **Merge**: per-probe top-k lists are scattered to a per-query table,
   deduplicated by id when shards overlap, and reduced to the final top-k.

With a recorder installed (:func:`gpann_tpu_torch.core.profiling.recording`)
each batch records a ``serve.batch`` span with one child a step
(``serve.route``, ``serve.group``, ``serve.scan``, ``serve.merge`` and, in
:meth:`ServingEngine.serve`, ``serve.readback``), and the binned scan counts
its block rows (``b1.rows_real``, ``b1.rows_scanned``). Without one, each
call site reads one module global and nothing else.

Either scan mode enqueues a whole batch without waiting on the device: no
step reads a device value back or copies a host value over (the exact
scan's step count comes from shapes), so the host first waits in
:meth:`ServingEngine.serve`'s read-back of the results.

PyTorch runs eagerly, so there is no compiled program per configuration.
Scatters that JAX drops when out of bounds (the dummy shard) go to one spare
column that is sliced off.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gpann_tpu_torch.core import profiling
from gpann_tpu_torch.core.distances import Metric, sq_norms
from gpann_tpu_torch.core.partition import Clusters
from gpann_tpu_torch.search.bin_scan import (BIN, fused_topk,
                                             fused_topk_blocks, scan_order)
from gpann_tpu_torch.search.exact import (blocks_per_step, blocks_topk,
                                          exact_distances, round_up,
                                          shard_bias)

_VOTING_IMPLS = ("exact", "approx", "rescore", "binned")
_RULES = ("min_dist", "pyramid", "spann", "frequency")


def _probe_rank(queries, router_points, router_labels, router_sq, *, s: int,
                voting_t: int, rule: str, spann_eps: float, nprobes: int,
                metric: Metric, voting_impl: str,
                router_n_valid: Optional[int] = None) -> torch.Tensor:
    """Probe list [m, nprobes] int32 under the reference's vote semantics.

    (min_dist, frequency) are folded over only the top ``voting_t`` routing
    points (``hnsw_router.h:106-119``). Slots a rule cuts short point at the
    dummy shard ``s``.
    """
    if rule not in _RULES:
        raise ValueError(f"unknown rule {rule!r}")
    if voting_impl not in _VOTING_IMPLS:
        raise ValueError(f"unknown voting_impl {voting_impl!r}")
    m = queries.shape[0]
    dev = queries.device
    n_valid = router_points.shape[0] if router_n_valid is None else router_n_valid
    t = min(voting_t, n_valid)
    if voting_impl == "binned":
        # the bin-top-2 scan as the routing matmul; fewer than t finite
        # candidates leave a +inf tail, whose votes go to the dummy shard
        ndist, nidx = fused_topk(queries, router_points, n_valid, t,
                                 metric=metric)
        nshard = torch.where(torch.isfinite(ndist), router_labels[nidx.long()],
                             s)
    else:
        rdots = queries @ router_points.T
        if metric == "mips":
            rdm = 1.0 - rdots
        else:
            rdm = sq_norms(queries)[:, None] + router_sq[None, :] - 2.0 * rdots
        if voting_impl == "rescore":
            # candidate set from the matmul, vote order from exact distances
            c = min(2 * t + 16, router_points.shape[0])
            _, cidx = torch.topk(rdm, c, dim=1, largest=False)
            cand = router_points[cidx]                      # [m, c, d]
            exact = exact_distances(queries, cand, metric)
            ndist, sel = torch.topk(exact, t, dim=1, largest=False)
            nshard = router_labels[cidx.gather(1, sel)]
        else:
            # "approx" is the TPU's partial-reduction top-k; exact here
            ndist, nidx = torch.topk(rdm, t, dim=1, largest=False)
            nshard = router_labels[nidx]
    nshard = nshard.long()
    # one spare column takes the dummy shard's votes
    min_d = torch.full((m, s + 1), torch.inf, device=dev).scatter_reduce_(
        1, nshard, ndist, reduce="amin")[:, :s]
    # unseen shards keep +inf; sort keys use a finite big number (a Python
    # scalar: a tensor made from it would be a blocking host-to-device copy)
    dkey = torch.where(torch.isfinite(min_d), min_d, 3e38)
    if rule == "frequency":
        # only the single most-voted shard goes first (ties -> lowest index);
        # the rest are ordered by min_dist (hnsw_router.h:87-103)
        freq = torch.zeros((m, s + 1), dtype=torch.int32, device=dev)
        freq.scatter_add_(1, nshard, torch.ones_like(nshard, dtype=torch.int32))
        top = freq[:, :s].argmax(dim=1, keepdim=True)
        # scatter of a scalar: an indexed write of one copies it to the
        # device first, which blocks the host
        key = dkey.scatter(1, top, -torch.inf)
        order = torch.argsort(key, dim=1, stable=True)
        seen = torch.ones((m, s), dtype=torch.bool, device=dev)
    else:
        order = torch.argsort(dkey, dim=1, stable=True)
        sorted_d = min_d.gather(1, order)
        if rule == "pyramid":
            seen = torch.isfinite(sorted_d)
        elif rule == "spann":
            closest = sorted_d[:, :1]
            seen = torch.isfinite(sorted_d) & (
                sorted_d <= (1.0 + spann_eps) * closest)
        else:  # min_dist probes every requested shard
            seen = torch.ones_like(sorted_d, dtype=torch.bool)
    return torch.where(seen, order, s)[:, :nprobes].to(torch.int32)


class Grouping(NamedTuple):
    """Probe pairs packed into ``qb``-row blocks (static worst-case count)."""

    pos: torch.Tensor          # [m*nprobes] row of each sorted pair in the blocks
    q_sorted: torch.Tensor     # [m*nprobes] query of each sorted pair
    slot_sorted: torch.Tensor  # [m*nprobes] probe slot of each sorted pair
    pair_q: torch.Tensor       # [total] query of each block row (m = padding)
    block_shard: torch.Tensor  # [nb] shard of each block (s = dummy)


def _group(probes: torch.Tensor, s: int, qb: int) -> Grouping:
    m, nprobes = probes.shape
    dev = probes.device
    mn = m * nprobes
    flat_b = probes.reshape(-1).long()
    sort = torch.argsort(flat_b, stable=True)
    b_sorted = flat_b[sort]
    q_sorted = sort // nprobes
    slot_sorted = sort % nprobes
    # each shard's first row in the sorted list, and its count, from the
    # list itself: bincount would read the list's min and max to the host
    edges = torch.searchsorted(b_sorted, torch.arange(s + 2, device=dev))
    counts = edges.diff()
    first = edges[:-1]
    padded = (counts + qb - 1) // qb * qb
    cum_padded = torch.cumsum(padded, 0)
    starts = cum_padded - padded
    rank = torch.arange(mn, device=dev) - first[b_sorted]
    pos = starts[b_sorted] + rank
    total = -(-mn // qb) * qb + (s + 1) * qb  # static worst case
    nb = total // qb
    pair_q = torch.full((total,), m, dtype=torch.int64, device=dev)
    pair_q[pos] = q_sorted
    block_start = torch.arange(nb, device=dev) * qb
    block_shard = torch.searchsorted(cum_padded, block_start, right=True)
    return Grouping(pos, q_sorted, slot_sorted, pair_q,
                    block_shard.clamp(max=s))


class ServingEngine:
    """Resident shard windows + routing points on one device; ``serve()``
    runs route + group + scan + merge per batch."""

    def __init__(
        self,
        points: np.ndarray,
        clusters: Clusters,
        routing_points: np.ndarray,
        routing_labels: np.ndarray,
        metric: Metric = "l2",
        pad_multiple: int = 512,
        scan_mode: str = "exact",
        voting_impl: str = "exact",
        scan_phase2: str = "exact",
        scan_nc: int = 0,
        *,
        device,
    ) -> None:
        """``scan_mode``: "exact" = matmul + top-k over each shard window;
        "binned" = the bin-top-2 scan (CUDA kernel on a CUDA device).

        ``voting_impl``: "exact" / "approx" (both ``torch.topk``), "rescore"
        (matmul candidates + exact f32 vote order) or "binned" (the bin-top-2
        scan as the routing matmul).

        ``scan_phase2`` / ``scan_nc``: candidate-bin selection and count of
        the binned scan (see :func:`fused_topk_blocks`).

        ``device`` is required (as for every module of the package; the
        CLIs pass ``cuda``): the engine's arrays live there and every batch
        runs there. Nothing moves to another device on its own.
        """
        s = len(clusters)
        sizes = np.asarray([len(c) for c in clusters], np.int32)
        all_ids = (np.concatenate([np.asarray(c) for c in clusters if len(c)])
                   if sizes.sum() else np.empty(0, np.int32))
        cap = round_up(max(int(sizes.max()), 1), pad_multiple)
        if scan_mode == "binned":
            cap = round_up(cap, BIN)  # the scan covers whole bins
        dim = points.shape[1]
        # stored flat [s*cap, d]: the scan reads shard windows straight out
        # of it (window b = rows [b*cap, b*cap + size_b))
        blocks = np.zeros((s * cap, dim), np.float32)
        ids = np.full(s * cap, -1, np.int32)
        for b, members in enumerate(clusters):
            members = np.asarray(members, np.int64)
            members = members[scan_order(members)]
            blocks[b * cap : b * cap + len(members)] = points[members]
            ids[b * cap : b * cap + len(members)] = members
        rp = np.asarray(routing_points, np.float32)
        arrays = {
            "shard_points": blocks,
            "shard_sizes_ext": np.concatenate([sizes, [0]]).astype(np.int32),
            "shard_ids": ids,
            "router_points": rp,
            "router_labels": np.asarray(routing_labels, np.int32),
            # exact squared norms (f64 on the host, stored f32)
            "router_sq": (rp.astype(np.float64) ** 2).sum(1).astype(np.float32),
        }
        config = {
            "num_shards": s, "capacity": cap, "dim": dim, "dim_pad": dim,
            "max_size": int(sizes.max()),
            # overlapping clusterings can return one point from several
            # probed shards; the merge then dedups ids
            "overlapping": len(np.unique(all_ids)) < len(all_ids),
            "router_n_valid": len(rp), "metric": metric,
            "scan_mode": scan_mode, "voting_impl": voting_impl,
            "scan_phase2": scan_phase2, "scan_nc": scan_nc,
        }
        self._load(arrays, config, device)

    @classmethod
    def from_state(cls, arrays: dict, config: dict, *,
                   device) -> "ServingEngine":
        """An engine on ``device`` from another engine's state.

        ``arrays`` maps the JAX engine's attribute names (``shard_points``,
        ``shard_sizes_ext``, ``shard_ids``, ``router_points``,
        ``router_labels``, ``router_sq``) to numpy arrays; ``config`` carries
        ``num_shards``, ``capacity``, ``dim``, ``dim_pad``, ``max_size``,
        ``overlapping``, ``router_n_valid``, ``metric``, ``scan_mode``,
        ``voting_impl``, ``scan_phase2`` and ``scan_nc``. TPU padding in that
        state (dims padded to ``dim_pad``, routing rows padded past
        ``router_n_valid``) is zeros and is dropped here.
        """
        self = cls.__new__(cls)
        self._load(arrays, config, device)
        return self

    def _load(self, arrays: dict, config: dict, device) -> None:
        self.device = torch.device(device)
        self.metric: Metric = config["metric"]
        self.scan_mode = config["scan_mode"]
        self.voting_impl = config["voting_impl"]
        self.scan_phase2 = config["scan_phase2"]
        self.scan_nc = int(config["scan_nc"])
        self.num_shards = int(config["num_shards"])
        self.capacity = int(config["capacity"])
        self.dim = int(config["dim"])
        self.max_size = int(config["max_size"])
        self.overlapping = bool(config["overlapping"])
        self.router_n_valid = int(config["router_n_valid"])
        if self.scan_mode not in ("exact", "binned"):
            raise ValueError(f"unknown scan_mode {self.scan_mode!r}")
        if self.scan_mode == "binned" and self.capacity % BIN:
            raise ValueError(f"capacity {self.capacity} is not a multiple of {BIN}")
        if self.voting_impl not in _VOTING_IMPLS:
            raise ValueError(f"unknown voting_impl {self.voting_impl!r}")
        nr = self.router_n_valid

        def put(a, dtype):  # copies: the engine owns its arrays
            return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=self.device)

        sp = np.asarray(arrays["shard_points"])
        self.shard_points = put(sp[:, : self.dim], torch.float32)
        self.shard_sizes_ext = put(arrays["shard_sizes_ext"], torch.int32)
        self.shard_ids = put(arrays["shard_ids"], torch.int32)
        self.router_points = put(np.asarray(arrays["router_points"])[:nr],
                                 torch.float32)
        self.router_labels = put(np.asarray(arrays["router_labels"])[:nr],
                                 torch.int64)
        self.router_sq = put(np.asarray(arrays["router_sq"])[:nr], torch.float32)

    # -- the pipeline ----------------------------------------------------------
    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, dtype=torch.float32, device=self.device)

    def _route(self, queries, nprobes, voting_t, rule, spann_eps):
        return _probe_rank(
            queries, self.router_points, self.router_labels, self.router_sq,
            s=self.num_shards, voting_t=voting_t, rule=rule,
            spann_eps=spann_eps, nprobes=nprobes, metric=self.metric,
            voting_impl=self.voting_impl, router_n_valid=self.router_n_valid)

    def _binned(self, k: int) -> bool:
        # top-2 per bin caps the candidate pool: tiny shards cannot fill k
        # candidates from their bins, so they take the exact scan
        return (self.scan_mode == "binned"
                and 2 * (self.max_size // BIN + 1) >= 4 * k)

    def _scan_blocks(self, queries: torch.Tensor, g: Grouping, qb: int):
        """Inputs of the scan for one grouped batch: (query rows [total, d],
        window row offsets [nb], live sizes [nb]; 0 for blocks of the dummy
        shard and blocks of padding rows only)."""
        m = queries.shape[0]
        s = self.num_shards
        queries_ext = torch.cat([queries, queries.new_zeros((1, self.dim))])
        qrows = queries_ext[g.pair_q]
        row_off = g.block_shard.clamp(max=s - 1) * self.capacity
        has_real = (g.pair_q.view(-1, qb) < m).any(dim=1)
        sizes = torch.where(has_real, self.shard_sizes_ext[g.block_shard], 0)
        return qrows, row_off, sizes.to(torch.int32)

    def _scan(self, queries, g: Grouping, k: int, qb: int):
        m = queries.shape[0]
        s, cap = self.num_shards, self.capacity
        qrows, row_off, sizes = self._scan_blocks(queries, g, qb)
        if self._binned(k):
            rec = profiling.RECORDER
            if rec is not None:
                scanned = sizes > 0
                rec.count("b1.rows_real", ((g.pair_q.view(-1, qb) < m)
                                           & scanned[:, None]).sum())
                rec.count("b1.rows_scanned", scanned.sum() * qb)
            bd, lpos = fused_topk_blocks(
                qrows, self.shard_points, row_off, sizes, k, self.metric,
                qb=qb, cap=cap, num_candidate_bins=self.scan_nc,
                phase2=self.scan_phase2)
            rows = row_off.repeat_interleave(qb)[:, None] + lpos.long()
            bi = self.shard_ids[rows]
        else:
            # blocks in steps under TILE_BYTES; a size-0 block's bias is all
            # +inf, so its lists are +inf and masked below
            qrows = qrows.view(-1, qb, self.dim)
            shard = g.block_shard.clamp(max=s - 1)
            windows = self.shard_points.view(s, cap, self.dim)
            ids = self.shard_ids.view(s, cap)
            nb = shard.shape[0]
            bd = torch.empty((nb, qb, k), device=self.device)
            bi = torch.empty((nb, qb, k), dtype=torch.int32, device=self.device)
            step = blocks_per_step(cap, qb, self.dim)
            for b0 in range(0, nb, step):
                sel = slice(b0, b0 + step)
                blk = windows[shard[sel]]
                bd[sel], bi[sel] = blocks_topk(
                    qrows[sel], blk, shard_bias(blk, sizes[sel], self.metric),
                    ids[shard[sel]], k, self.metric, rescore=True)
            bd, bi = bd.view(-1, k), bi.view(-1, k)
        # inf-distance fillers carry positions that can alias real ids
        return bd, torch.where(torch.isfinite(bd), bi, -1)

    def _pipeline(self, queries, k: int, nprobes: int, voting_t: int,
                  rule: str, qb: int, spann_eps: float, kth=None,
                  to_host: bool = False):
        m = queries.shape[0]
        rec = profiling.RECORDER
        if rec is not None:
            batch = rec.begin("serve.batch", self.device, root=True)
            step = rec.begin("serve.route", self.device)
        probes = self._route(queries, nprobes, voting_t, rule, spann_eps)
        if rec is not None:
            step = rec.next(step, "serve.group", self.device)
        g = _group(probes, self.num_shards, qb)
        if rec is not None:
            step = rec.next(step, "serve.scan", self.device)
        bd, bi = self._scan(queries, g, k, qb)
        if rec is not None:
            step = rec.next(step, "serve.merge", self.device)

        # ---- merge ----
        out_d = torch.full((m + 1, nprobes, k), torch.inf, device=self.device)
        out_i = torch.full((m + 1, nprobes, k), -1, dtype=torch.int32,
                           device=self.device)
        out_d[g.q_sorted, g.slot_sorted] = bd[g.pos]
        out_i[g.q_sorted, g.slot_sorted] = bi[g.pos]
        cat_d = out_d[:m].reshape(m, nprobes * k)
        cat_i = out_i[:m].reshape(m, nprobes * k)
        if self.overlapping:
            # mask duplicate ids (keep the first copy): sort by id, mark
            # equal neighbours, scatter the mask back
            order_i = torch.argsort(cat_i, dim=1, stable=True)
            sorted_i = cat_i.gather(1, order_i)
            dup_sorted = torch.cat(
                [torch.zeros((m, 1), dtype=torch.bool, device=self.device),
                 (sorted_i[:, 1:] == sorted_i[:, :-1]) & (sorted_i[:, 1:] >= 0)],
                dim=1)
            dup = torch.zeros_like(dup_sorted).scatter_(1, order_i, dup_sorted)
            cat_d = torch.where(dup, torch.inf, cat_d)
        if kth is not None:
            # recall@k at every probe prefix: slots are in probe order, so the
            # prefix hit counts are a cumsum over slots; threshold recall as
            # eval.recall.recall_from_candidate_distances, capped at k hits
            thresh = kth + 1e-5 + 1e-4 * kth.abs()
            hit = (cat_d <= thresh[:, None]).view(m, nprobes, k)
            cum = torch.cumsum(hit.sum(dim=2), dim=1)
            capped = torch.clamp(cum, max=k).to(torch.float32)
            out = capped.sum(dim=0) / (k * m)
        else:
            fd, fpos = torch.topk(cat_d, k, dim=1, largest=False)
            out = fd, cat_i.gather(1, fpos)
            if to_host:
                if rec is not None:
                    step = rec.next(step, "serve.readback", self.device)
                out = out[0].cpu().numpy(), out[1].cpu().numpy()
        if rec is not None:
            rec.end(step, self.device)
            rec.end(batch, self.device)
        return out

    # -- public entry points ---------------------------------------------------
    def serve_device(self, queries, k: int, nprobes: int, voting_t: int = 60,
                     rule: str = "min_dist", query_block: int = 1024,
                     spann_eps: float = 0.6) -> Tuple[torch.Tensor, torch.Tensor]:
        """Like :meth:`serve` but returns tensors on the engine's device."""
        return self._pipeline(self._queries(queries), k, nprobes, voting_t,
                              rule, query_block, spann_eps)

    def serve_scan(self, batches, k: int, nprobes: int, voting_t: int = 60,
                   rule: str = "min_dist", query_block: int = 1024,
                   spann_eps: float = 0.6) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serve a stack of query batches [r, m, d] one after another.
        Returns device tensors ``([r, m, k] dists, [r, m, k] ids)``."""
        outs = [self.serve_device(q, k, nprobes, voting_t, rule, query_block,
                                  spann_eps) for q in self._queries(batches)]
        return (torch.stack([d for d, _ in outs]),
                torch.stack([i for _, i in outs]))

    def serve(self, queries, k: int, nprobes: int, voting_t: int = 60,
              rule: str = "min_dist", query_block: int = 1024,
              spann_eps: float = 0.6) -> Tuple[np.ndarray, np.ndarray]:
        """End-to-end routed search; returns numpy ``(dists [m, k],
        ids [m, k] int32)``, ids -1 where fewer than k candidates exist."""
        return self._pipeline(self._queries(queries), k, nprobes, voting_t,
                              rule, query_block, spann_eps, to_host=True)

    def recall_curve(self, queries, k: int, kth_dist, voting_t: int = 60,
                     rule: str = "min_dist", query_block: int = 1024,
                     spann_eps: float = 0.6) -> np.ndarray:
        """recall@k at every probe prefix 1..num_shards from one pass, with
        the threshold-recall definition of recall.h:139-150."""
        kth = torch.as_tensor(np.asarray(kth_dist, np.float32),
                              device=self.device)
        return self._pipeline(self._queries(queries), k, self.num_shards,
                              voting_t, rule, query_block, spann_eps,
                              kth=kth).cpu().numpy()

    def scan_inputs(self, queries, nprobes: int, voting_t: int = 60,
                    rule: str = "min_dist", query_block: int = 1024,
                    spann_eps: float = 0.6):
        """Route and group one batch and return what the binned scan gets:
        ``(query rows [total, d], window row offsets [nb], live sizes [nb])``,
        and with them the count [nb] of each block's rows that hold a real
        (query, probe) pair, the rest being padding — for measuring the scan
        alone at serving shapes."""
        queries = self._queries(queries)
        probes = self._route(queries, nprobes, voting_t, rule, spann_eps)
        g = _group(probes, self.num_shards, query_block)
        live_q = (g.pair_q.view(-1, query_block) < queries.shape[0]).sum(dim=1)
        return (*self._scan_blocks(queries, g, query_block), live_q)

    def probe_order(self, queries, nprobes: int, voting_t: int = 60,
                    rule: str = "min_dist", spann_eps: float = 0.6) -> np.ndarray:
        """The probe list [m, nprobes] the pipeline scans (dummy shard
        ``num_shards`` where a rule cuts the list short)."""
        return self._route(self._queries(queries), nprobes, voting_t, rule,
                           spann_eps).cpu().numpy()
