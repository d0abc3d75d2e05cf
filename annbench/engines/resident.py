"""The resident engine, ``gpann_tpu_torch.search.serve.ServingEngine``: every
shard on the card; a batch is routed, grouped into ``query_block``-row
blocks, scanned by kernel B1 and merged, and its ids and distances read back
by the public ``serve``."""

import numpy as np


def build(base, shard_of, routing_points, routing_labels, cfg, device):
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.search.serve import ServingEngine

    return ServingEngine(
        base, partition_to_clusters(shard_of.astype(np.int32),
                                    cfg["num_shards"]),
        routing_points, routing_labels,
        metric=cfg["metric"], **cfg["engine"], device=device)


def serve(engine, cfg, queries):
    return engine.serve(queries, cfg["k"], cfg["nprobes"],
                        voting_t=cfg["voting_t"], rule=cfg["rule"],
                        query_block=cfg["query_block"])


def grouping(engine, cfg, queries):
    """The public ``ServingEngine.scan_inputs`` counts of one batch."""
    _, row_off, sizes, live_q = engine.scan_inputs(
        queries, cfg["nprobes"], voting_t=cfg["voting_t"],
        rule=cfg["rule"], query_block=cfg["query_block"])
    return (live_q.cpu().numpy(), sizes.cpu().numpy(),
            row_off.cpu().numpy())


def close(engine):
    """Nothing to remove: the engine wrote nothing outside the process."""
