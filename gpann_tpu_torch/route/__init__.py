"""Routing layer: k-means-tree router + flat routing-point router
(counterpart of ``gpann_tpu/route``)."""

from gpann_tpu_torch.route.flat import (
    FlatRouter,
    centroid_router,
    rank_frequency,
    rank_min_dist,
    rank_pyramid,
    rank_spann,
)
from gpann_tpu_torch.route.kmeans_tree import KMeansTreeRouter, KMeansTreeRouterOptions

__all__ = [k for k in dir() if not k.startswith("_")]
