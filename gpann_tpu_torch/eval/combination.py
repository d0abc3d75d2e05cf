"""Route x search combination: the offline QPS/recall simulator.

Reference parity: ``src/route_search_combination.{h,cpp}`` (C15) — the
reference's primary deliverable. For each (routing config, search config)
pair it:

1. attributes per-shard work: ``local_work[b] += time_in_shard[b][q]`` over
   the shards each query probes, and counts unique hits
   (``route_search_combination.cpp:9-63``);
2. applies the replica cost model: repeatedly grant an extra replica host to
   the max-latency shard, up to ``requested_shards + 20`` hosts;
   ``QPS = num_queries / (max shard latency + routing_time / num_hosts)``
   (``route_search_combination.cpp:149-183``);
3. emits one CSV row per (pair, nprobes, replica count) and Pareto-filters on
   (recall, QPS) (``route_search_combination.cpp:193-226``).

This is pure host analytics (NumPy), ported with the identical 19-column CSV
schema (``route_search_combination.cpp:127-129``).

Numpy only: a copy of ``gpann_tpu/eval/combination.py``, so that both
packages write byte-identical ``.routes``, ``.searches`` and CSV files.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

CSV_HEADER = (
    "partitioning,shard query,routing query,routing index,ef_search_shard,"
    "voting points,routing time,nprobes,recall,QPS,QPS per host,"
    "QPS without routing,QPS per host without routing,hosts,num shards,"
    "requested num shards,routing index size,min cluster size,num centroids"
)


@dataclass
class RoutingConfig:
    """One trained-router configuration and its per-query probe orders.

    Field parity with reference ``RoutingConfig`` (routes.h:10-33).
    """

    index_trainer: str = ""       # e.g. "KMeansTree", "Flat"
    routing_algorithm: str = ""   # e.g. "min_dist", "pyramid", "spann", "frequency"
    hnsw_num_voting_neighbors: int = 0
    hnsw_ef_search: int = 0       # kept for schema parity (no HNSW walk here)
    routing_time: float = 0.0     # seconds for the whole query set
    routing_index_options: dict = field(default_factory=dict)
    routing_distance_calcs: int = 0
    index_size_bytes: int = 0
    try_increasing_num_shards: bool = True
    buckets_to_probe: Optional[np.ndarray] = None  # [nq, <=s] (-1 padded)

    def probe_list(self, q: int, nprobes: int) -> np.ndarray:
        row = self.buckets_to_probe[q]
        row = row[row >= 0]
        return row[:nprobes]


@dataclass
class ShardSearch:
    """One in-shard search configuration's measurements.

    Parity with reference ``ShardSearch`` (shard_searches.h:9-31):
    per (shard, query) the ids of returned points within the GT k-distance
    ("hits") and the amortized per-query time.
    """

    ef_search: int = 0            # candidate budget (ef-equivalent knob)
    time_query_in_shard: Optional[np.ndarray] = None  # [s, nq] seconds
    hits: Optional[List[List[np.ndarray]]] = None     # [s][nq] -> hit point ids


def attribute_recall_and_query_time(
    route: RoutingConfig,
    search: ShardSearch,
    num_queries: int,
    num_shards: int,
    nprobes: int,
    k: int,
    unique_hits: Optional[bool] = None,
) -> tuple[float, np.ndarray]:
    """Unique-hit recall + per-shard accumulated work for a fixed nprobes
    (reference AttributeRecallAndQueryTimeIncreasingNumProbes,
    route_search_combination.cpp:9-63).

    With a non-overlapping partition, hit ids are disjoint across shards, so
    recall is a vectorized sum of per-(shard, query) hit counts; the
    set-based dedup only runs for overlapping clusterings (auto-detected
    once per ShardSearch, cached on the object).
    """
    if unique_hits is None:
        unique_hits = _hits_are_unique(search)
    probes = route.buckets_to_probe[:, :nprobes]
    qidx = np.repeat(np.arange(num_queries), probes.shape[1])
    flat_b = probes.reshape(-1)
    valid = flat_b >= 0
    qv, bv = qidx[valid], flat_b[valid]
    local_work = np.zeros(num_shards, np.float64)
    np.add.at(local_work, bv, search.time_query_in_shard[bv, qv])
    if unique_hits:
        counts = _hit_counts(search)  # cached [s, nq]
        per_q = np.zeros(num_queries, np.int64)
        np.add.at(per_q, qv, counts[bv, qv])
        total_hits = int(np.minimum(per_q, k).sum())
    else:
        # overlap: unique-(query, id) counting via one sorted first-probe
        # dedup (no per-query Python sets — those dominate the combine step
        # at 100k queries x overlapping configs)
        recalls, _ = attribute_recall_curves(
            route, search, num_queries, num_shards, k, max_probes=nprobes,
            need_work=False,
        )
        total_hits = int(round(recalls[nprobes - 1] * k * num_queries))
    recall = total_hits / (k * num_queries)
    return recall, local_work


def attribute_recall_curves(
    route: RoutingConfig,
    search: ShardSearch,
    num_queries: int,
    num_shards: int,
    k: int,
    max_probes: Optional[int] = None,
    need_work: bool = True,
) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Recall and per-shard work for EVERY nprobes prefix in one pass.

    Returns ``(recalls [p], cum_work [p, num_shards] or None)`` where row
    ``j`` corresponds to ``nprobes = j+1``. Unique-hit semantics are exact
    for overlapping clusterings: each (query, id) pair contributes at the
    FIRST probe slot whose shard holds it (one lexsort over all gathered
    hits), then the per-slot new-hit counts cumsum into the curve — the
    vectorized equivalent of route_search_combination.cpp:9-63's per-query
    set union, s times cheaper than evaluating each prefix separately.
    """
    from gpann_tpu_torch.core.partition import csr_gather

    p = max_probes or min(route.buckets_to_probe.shape[1], num_shards)
    probes = route.buckets_to_probe[:, :p]
    nq = num_queries
    qidx = np.repeat(np.arange(nq), probes.shape[1])
    slot = np.tile(np.arange(probes.shape[1]), nq)
    flat_b = probes.reshape(-1)
    valid = flat_b >= 0
    qv, bv, sv = qidx[valid], flat_b[valid], slot[valid]

    indptr, hit_ids = _hits_csr(search, num_queries)
    rows = bv.astype(np.int64) * nq + qv
    owners, ids = csr_gather(indptr, hit_ids, rows)
    qq, ss = qv[owners], sv[owners]
    # first probe slot per (query, id): lexsort by (q, id) then slot
    order = np.lexsort((ss, ids, qq))
    qs, is_, ss_ = qq[order], ids[order], ss[order]
    first = np.ones(len(order), bool)
    first[1:] = (qs[1:] != qs[:-1]) | (is_[1:] != is_[:-1])
    new_counts = np.zeros((nq, p), np.int64)
    np.add.at(new_counts, (qs[first], ss_[first]), 1)
    cum = np.minimum(np.cumsum(new_counts, axis=1), k)
    recalls = cum.sum(axis=0) / (k * nq)

    cum_work = None
    if need_work:
        work = np.zeros((p, num_shards), np.float64)
        np.add.at(work, (sv, bv), search.time_query_in_shard[bv, qv])
        cum_work = np.cumsum(work, axis=0)
    return recalls, cum_work


def _hits_csr(search: ShardSearch, num_queries: int):
    """Cached CSR over row id b*nq+q -> hit ids (one flat array)."""
    if not hasattr(search, "_hits_csr"):
        s = len(search.hits)
        deg = np.fromiter(
            (len(search.hits[b][q]) for b in range(s)
             for q in range(num_queries)),
            np.int64, s * num_queries,
        )
        indptr = np.zeros(s * num_queries + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        flat = (np.concatenate(
            [np.asarray(search.hits[b][q], np.int64) for b in range(s)
             for q in range(num_queries)]
        ) if deg.sum() else np.empty(0, np.int64))
        search._hits_csr = (indptr, flat)
    return search._hits_csr


def _hit_counts(search: ShardSearch) -> np.ndarray:
    if not hasattr(search, "_hit_counts"):
        s = len(search.hits)
        nq = len(search.hits[0]) if s else 0
        counts = np.zeros((s, nq), np.int32)
        for b in range(s):
            for q in range(nq):
                counts[b, q] = len(search.hits[b][q])
        search._hit_counts = counts
    return search._hit_counts


def _hits_are_unique(search: ShardSearch) -> bool:
    """True if no hit id appears in more than one shard for any query."""
    if not hasattr(search, "_unique_hits"):
        nq = len(search.hits[0]) if search.hits else 0
        unique = True
        for q in range(nq):
            all_ids = np.concatenate(
                [search.hits[b][q] for b in range(len(search.hits))]
            )
            if len(np.unique(all_ids)) != len(all_ids):
                unique = False
                break
        search._unique_hits = unique
    return search._unique_hits


def replica_cost_model(
    local_work: np.ndarray,
    routing_time: float,
    num_queries: int,
    requested_shards: int,
    max_extra_hosts: int = 20,
) -> List[dict]:
    """Replica-based load-balancing model
    (route_search_combination.cpp:149-183). Returns one record per host
    count: add a replica to the max-latency shard each step."""
    num_shards = len(local_work)
    replicas = np.ones(num_shards, np.int64)
    out = []
    for extra in range(max_extra_hosts + 1):
        eff = local_work / replicas
        max_latency = float(eff.max()) if num_shards else 0.0
        num_hosts = int(replicas.sum())
        qps_no_routing = num_queries / max_latency if max_latency > 0 else np.inf
        denom = max_latency + routing_time / max(num_hosts, 1)
        qps = num_queries / denom if denom > 0 else np.inf
        out.append(
            dict(
                hosts=num_hosts,
                qps=qps,
                qps_per_host=qps / num_hosts,
                qps_no_routing=qps_no_routing,
                qps_no_routing_per_host=qps_no_routing / num_hosts,
            )
        )
        if num_hosts >= requested_shards + max_extra_hosts:
            break
        replicas[int(np.argmax(eff))] += 1
    return out


def combine_routes_and_searches(
    routes: Sequence[RoutingConfig],
    searches: Sequence[ShardSearch],
    num_queries: int,
    num_shards: int,
    requested_shards: int,
    k: int,
    partition_method: str = "GP",
    min_cluster_size: int = 0,
    num_centroids: int = 0,
    shard_query_name: str = "FusedScan",
) -> List[str]:
    """All (route x search x nprobes x replicas) CSV rows
    (PrintCombinationsOfRoutesAndSearches, route_search_combination.cpp:121-226)."""
    rows = []
    for route in routes:
        for search in searches:
            # one curve pass per (route, search): recall + cumulative work
            # for every nprobes prefix (s x cheaper than per-prefix calls)
            recalls, cum_work = attribute_recall_curves(
                route, search, num_queries, num_shards, k
            )
            p = len(recalls)
            for nprobes in range(1, num_shards + 1):
                j = min(nprobes, p) - 1
                recall, local_work = float(recalls[j]), cum_work[j]
                for rec in replica_cost_model(
                    local_work, route.routing_time, num_queries, requested_shards
                ):
                    rows.append(
                        f"{partition_method},{shard_query_name},"
                        f"{route.routing_algorithm},{route.index_trainer},"
                        f"{search.ef_search},{route.hnsw_num_voting_neighbors},"
                        f"{route.routing_time},{nprobes},{recall},"
                        f"{rec['qps']},{rec['qps_per_host']},"
                        f"{rec['qps_no_routing']},{rec['qps_no_routing_per_host']},"
                        f"{rec['hosts']},{num_shards},{requested_shards},"
                        f"{route.index_size_bytes},{min_cluster_size},"
                        f"{num_centroids}"
                    )
    return rows


def pareto_filter(rows: Sequence[str], recall_col: int = 8, qps_col: int = 9) -> List[str]:
    """Keep rows on the (recall, QPS) Pareto front
    (route_search_combination.cpp:193-225)."""
    parsed = []
    for row in rows:
        f = row.split(",")
        parsed.append((float(f[recall_col]), float(f[qps_col]), row))
    parsed.sort(key=lambda t: (-t[0], -t[1]))
    out = []
    best_qps = -np.inf
    for recall, qps, row in parsed:
        if qps > best_qps:
            out.append(row)
            best_qps = qps
    return out[::-1]


# ---------------------------------------------------------------------------
# Text (de)serialization of routes and searches — stage checkpointing parity
# (routes.cpp:317-381, shard_searches.cpp:108-183)
# ---------------------------------------------------------------------------


def serialize_routes(routes: Sequence[RoutingConfig], path: str) -> None:
    with open(path, "w") as f:
        f.write(f"{len(routes)}\n")
        for r in routes:
            f.write(
                f"{r.index_trainer} {r.routing_algorithm} "
                f"{r.hnsw_num_voting_neighbors} {r.hnsw_ef_search} "
                f"{r.routing_time} {r.index_size_bytes} "
                f"{int(r.try_increasing_num_shards)} "
                f"{int(r.routing_index_options.get('budget', 0))} "
                f"{r.routing_distance_calcs}\n"
            )
            f.write(f"{len(r.buckets_to_probe)}\n")
            for row in r.buckets_to_probe:
                row = row[row >= 0]
                f.write(" ".join(map(str, row.tolist())) + "\n")


def deserialize_routes(path: str) -> List[RoutingConfig]:
    routes = []
    with open(path) as f:
        n = int(f.readline())
        for _ in range(n):
            head = f.readline().split()
            r = RoutingConfig(
                index_trainer=head[0],
                routing_algorithm=head[1],
                hnsw_num_voting_neighbors=int(head[2]),
                hnsw_ef_search=int(head[3]),
                routing_time=float(head[4]),
                index_size_bytes=int(head[5]),
                try_increasing_num_shards=bool(int(head[6])),
            )
            if len(head) > 7:  # budget + distance calcs (older files lack them)
                r.routing_index_options = {"budget": int(head[7])}
                r.routing_distance_calcs = int(head[8])
            nq = int(f.readline())
            rows = []
            width = 0
            for _ in range(nq):
                line = f.readline().strip()
                vals = (np.fromstring(line, dtype=np.int32, sep=" ")
                        if line else np.empty(0, np.int32))
                width = max(width, len(vals))
                rows.append(vals)
            probe = np.full((nq, max(width, 1)), -1, np.int32)
            for i, vals in enumerate(rows):
                probe[i, : len(vals)] = vals
            r.buckets_to_probe = probe
            routes.append(r)
    return routes


def serialize_searches(searches: Sequence[ShardSearch], path: str) -> None:
    with open(path, "w") as f:
        f.write(f"{len(searches)}\n")
        for s in searches:
            num_shards, nq = s.time_query_in_shard.shape
            f.write(f"{s.ef_search} {num_shards} {nq}\n")
            for b in range(num_shards):
                f.write(" ".join(f"{t:.9g}" for t in s.time_query_in_shard[b]) + "\n")
            for b in range(num_shards):
                for q in range(nq):
                    f.write(" ".join(map(str, np.asarray(s.hits[b][q]).tolist())) + "\n")


def deserialize_searches(path: str) -> List[ShardSearch]:
    searches = []
    with open(path) as f:
        n = int(f.readline())
        for _ in range(n):
            ef, num_shards, nq = map(int, f.readline().split())
            times = np.stack(
                [np.fromstring(f.readline(), dtype=np.float64, sep=" ")
                 for _ in range(num_shards)]
            )
            def _hit_line():
                line = f.readline().strip()
                return (np.fromstring(line, dtype=np.int64, sep=" ")
                        if line else np.empty(0, np.int64))

            hits = [[_hit_line() for _ in range(nq)] for _ in range(num_shards)]
            searches.append(
                ShardSearch(ef_search=ef, time_query_in_shard=times, hits=hits)
            )
    return searches
