"""Core layer: vector I/O, fp32 distance helpers, partitions."""

from gpann_tpu_torch.core.distances import (
    Metric,
    assign_closest,
    chunked_topk_neighbors,
    l2_normalize,
    pairwise_distances,
    pos_distance_offset,
    sq_norms,
    streaming_topk_neighbors,
    topk_neighbors,
)
from gpann_tpu_torch.core.metis_io import (
    read_clusters,
    read_metis_graph,
    read_metis_partition,
    write_clusters,
    write_metis_graph,
    write_metis_partition,
)
from gpann_tpu_torch.core.partition import (
    Clusters,
    Cover,
    Partition,
    clusters_to_cover,
    clusters_to_partition,
    cover_to_clusters,
    partition_to_clusters,
    remap_partition_ids,
)
from gpann_tpu_torch.core.pointset import (
    read_ground_truth,
    read_header,
    read_points,
    write_ground_truth,
    write_points,
)

__all__ = [k for k in dir() if not k.startswith("_")]
