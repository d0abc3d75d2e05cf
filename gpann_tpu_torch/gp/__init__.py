"""Graph-partitioning layer: the balanced multilevel partitioner, the flat
and overlapping partitioning methods and GP at scale (counterpart of
``gpann_tpu/gp``)."""

from gpann_tpu_torch.gp import api
from gpann_tpu_torch.gp.lp import partition_graph
from gpann_tpu_torch.gp.overlap import (
    apply_extra_assignments,
    centroid_overlap_streamed,
    foreign_cluster_candidates,
    make_overlapping_with_centroids,
    overlapping_graph_partitioning,
    overlapping_kmeans_partitioning_spann,
)
from gpann_tpu_torch.gp.partitioning import (
    balanced_kmeans_partitioning,
    flat_kmeans_partitioning,
    graph_partitioning,
    hierarchical_kmeans,
    kmeans_partitioning,
    our_pyramid_partitioning,
    partition_dense_graph,
    pyramid_partitioning,
    random_partition,
    rebalancing_kmeans_partitioning,
    recursive_kmeans_partitioning,
)
from gpann_tpu_torch.gp.scale import gp_aggregates, subsample_gp_partition

__all__ = [k for k in dir() if not k.startswith("_")]
