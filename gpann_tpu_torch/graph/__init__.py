"""kNN-graph layer: exact oracle + approximate leader-sketching builder
(counterpart of ``gpann_tpu/graph``)."""

from gpann_tpu_torch.graph.knn import (
    ApproximateKNNGraphBuilder,
    build_exact_knn_graph,
    graph_recall,
    symmetrize_to_csr,
)

__all__ = [k for k in dir() if not k.startswith("_")]
