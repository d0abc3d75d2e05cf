"""Evaluation layer: ground truth, recall and oracle recall."""

from gpann_tpu_torch.eval.recall import (
    compute_ground_truth,
    gt_shard_counts,
    kth_neighbor_distance,
    max_first_shard_routing_recall,
    oracle_recall,
    recall_from_candidate_distances,
    recall_from_hit_counts,
    recall_from_ids,
    verify_ground_truth,
)

__all__ = [k for k in dir() if not k.startswith("_")]
