"""Clustering layer: Lloyd, balanced and streaming k-means (counterpart of
``gpann_tpu/cluster``)."""

from gpann_tpu_torch.cluster.kmeans import (
    balanced_kmeans,
    kmeans,
    objective_value,
    random_sample,
    rebalance_greedy,
)
from gpann_tpu_torch.cluster.streaming import (
    capacity_stream_assign,
    streaming_capacity_partition,
    streaming_kmeans,
)

__all__ = [k for k in dir() if not k.startswith("_")]
