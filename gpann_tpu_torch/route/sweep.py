"""Routing-config sweep driver (counterpart of ``gpann_tpu/route/sweep.py``).

Reference parity: ``IterateRoutingConfigs`` (routes.cpp:130-311): for each
router size budget, train the k-means-tree router, run tree routing +
frequency-voting sweeps, extract its points into the flat (HNSW-role) router
and run all four probe rules x voting-neighbor sweeps, plus the Random
routing baseline (routes.cpp:269-285).

Grids mirror the reference: voting neighbors {20..500} (routes.cpp:36,229);
the budget grid is a parameter (reference uses {20k..10M}, routes.cpp:130,
with the main driver picking n/requested_shards,
run_query_attribution.cpp:68-69).

Routers train and answer on ``device``; every timed call is followed by a
device synchronisation (:func:`~gpann_tpu_torch.core.timer.time_fn`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from gpann_tpu_torch.core.distances import Metric
from gpann_tpu_torch.core.partition import Clusters
from gpann_tpu_torch.core.timer import time_fn
from gpann_tpu_torch.eval.combination import RoutingConfig
from gpann_tpu_torch.route.kmeans_tree import (
    KMeansTreeRouter,
    KMeansTreeRouterOptions,
)

VOTING_NEIGHBORS = (20, 40, 80, 120, 200, 250, 300, 400, 500)  # routes.cpp:36,229
HNSW_RULES = ("min_dist", "pyramid", "spann", "frequency")
# the reference's active router-size grid (routes.cpp:130, #else branch)
BUDGET_GRID = (
    20_000, 100_000, 200_000, 500_000,
    1_000_000, 2_000_000, 5_000_000, 10_000_000,
)


def default_budgets(n: int) -> List[int]:
    """The reference grid, dropped where a budget exceeds the dataset size
    (a router bigger than the data degenerates to brute force over it)."""
    out = [b for b in BUDGET_GRID if b <= n]
    return out or [max(1, n // 2)]


def iterate_flat_router_configs(
    flat,
    queries: np.ndarray,
    index_trainer: str,
    voting_neighbors: Sequence[int] = VOTING_NEIGHBORS,
    timing_reps: int = 3,
    extra_options: Optional[dict] = None,
) -> List[RoutingConfig]:
    """All 4 probe rules x voting-neighbor sweep over one flat (HNSW-role)
    router on its own device — the reference's ``IterateHNSWRouterConfigs``
    (routes.cpp:33-118), reused for the Pyramid/OurPyramid saved side indices
    (routes.cpp:287-311) via ``index_trainer`` = "Pyramid"/"OurPyramid+KNN"."""
    out: List[RoutingConfig] = []
    # f32 points + int32 labels, as the JAX router stores them
    index_bytes = (flat.points.element_size() * flat.points.nelement()
                   + flat.labels_np.nbytes)
    for rule in HNSW_RULES:
        for v in voting_neighbors:
            if v > len(flat):
                continue
            t, probes = time_fn(flat.query, queries, v, rule,
                                reps=timing_reps, device=flat.device)
            out.append(
                RoutingConfig(
                    index_trainer=index_trainer,
                    routing_algorithm=rule,
                    hnsw_num_voting_neighbors=v,
                    routing_time=t,
                    index_size_bytes=index_bytes,
                    routing_index_options=dict(extra_options or {}),
                    routing_distance_calcs=len(flat),
                    try_increasing_num_shards=rule not in ("pyramid",
                                                           "spann"),
                    buckets_to_probe=np.asarray(probes, np.int32),
                )
            )
    return out


def iterate_routing_configs(
    points: np.ndarray,
    queries: np.ndarray,
    clusters: Clusters,
    budgets: Sequence[int],
    metric: Metric = "l2",
    seed: int = 555,
    num_centroids: int = 64,
    min_cluster_size: int = 350,
    voting_neighbors: Sequence[int] = VOTING_NEIGHBORS,
    include_random: bool = True,
    timing_reps: int = 3,
    pyramid_index=None,
    our_pyramid_index=None,
    *,
    device,
) -> List[RoutingConfig]:
    """``pyramid_index`` / ``our_pyramid_index``: optional
    :class:`~gpann_tpu_torch.route.flat.FlatRouter` side indices saved by the
    Pyramid/OurPyramid partitioners — swept through the same 4-rule x voting
    grid with ``index_trainer`` "Pyramid"/"OurPyramid+KNN"
    (routes.cpp:287-311)."""
    device = torch.device(device)
    num_shards = len(clusters)
    out: List[RoutingConfig] = []

    for budget in budgets:
        opts = KMeansTreeRouterOptions(
            num_centroids=num_centroids,
            min_cluster_size=min_cluster_size,
            budget=int(budget),
        )
        router = KMeansTreeRouter(metric=metric, device=device).train(
            points, clusters, opts, seed=seed)
        rp, labels = router.extract_points()
        index_bytes = rp.nbytes + labels.nbytes
        flat = router.flat

        # tree-routing analog: budget-capped subtree descent (the reference
        # Query's search_budget walk, kmeans_tree_router.cpp:93-130); the
        # true mean distance-comp count is recorded (the reference records
        # the nominal search_budget, routes.cpp:210)
        _, _, calcs = router.budgeted_votes(queries, opts.search_budget)
        t, probes = time_fn(router.query_budgeted, queries,
                            opts.search_budget, reps=timing_reps,
                            device=device)
        out.append(
            RoutingConfig(
                index_trainer="KMeansTree",
                routing_algorithm="min_dist",
                hnsw_num_voting_neighbors=0,
                routing_time=t,
                index_size_bytes=index_bytes,
                routing_index_options={"budget": int(budget),
                                       "search_budget": opts.search_budget},
                routing_distance_calcs=int(round(calcs)),
                buckets_to_probe=np.asarray(probes, np.int32),
            )
        )
        # frequency voting sweep (routes.cpp:218-243), same budgeted walk
        for v in voting_neighbors:
            if v > len(flat):
                continue
            t, probes = time_fn(router.frequency_query_budgeted, queries, v,
                                opts.search_budget, reps=timing_reps,
                                device=device)
            out.append(
                RoutingConfig(
                    index_trainer="KMeansTree",
                    routing_algorithm="frequency",
                    hnsw_num_voting_neighbors=v,
                    routing_time=t,
                    index_size_bytes=index_bytes,
                    routing_index_options={"budget": int(budget),
                                           "search_budget": opts.search_budget},
                    routing_distance_calcs=int(round(calcs)),
                    buckets_to_probe=np.asarray(probes, np.int32),
                )
            )
        # flat (HNSW-role) router: 4 rules x voting sweep (routes.cpp:33-118)
        out.extend(iterate_flat_router_configs(
            flat, queries, "Flat", voting_neighbors=voting_neighbors,
            timing_reps=timing_reps, extra_options={"budget": int(budget)},
        ))

    if include_random:  # routes.cpp:269-285
        rng = np.random.default_rng(seed)
        probes = np.stack(
            [rng.permutation(num_shards) for _ in range(len(queries))]
        ).astype(np.int32)
        out.append(
            RoutingConfig(
                index_trainer="None",
                routing_algorithm="Random",
                routing_time=0.0,
                buckets_to_probe=probes,
            )
        )

    # saved Pyramid/OurPyramid side indices (routes.cpp:287-311)
    if pyramid_index is not None:
        out.extend(iterate_flat_router_configs(
            pyramid_index, queries, "Pyramid",
            voting_neighbors=voting_neighbors, timing_reps=timing_reps,
        ))
    if our_pyramid_index is not None:
        out.extend(iterate_flat_router_configs(
            our_pyramid_index, queries, "OurPyramid+KNN",
            voting_neighbors=voting_neighbors, timing_reps=timing_reps,
        ))
    return out
