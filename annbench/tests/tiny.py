"""A cell at a size the CPU holds: the hard mixture at 60,000 x 32, four
shards, with a small index built here in numpy (shards by the nearest of
four base points, every 25th point a routing point), served by the resident
engine or, with ``serving="streamed"``, by the streamed one."""

import copy

import numpy as np

from annbench import datagen
from annbench.spec import Cell, load_cell

N, D, SHARDS, CHECK_Q = 60_000, 32, 4, 64
LIMITS = {"routed_miss": 0.01, "dist_err": 1e-3, "invalid_lists": 0}
# the streamed engine's keywords (``StreamedShardEngine``)
STREAMED_ENGINE = {"scan_mode": "binned", "voting_impl": "approx"}


def tiny_cell(workload: str = "hard8m-b4096", batch: int = 64,
              serving: str = "resident") -> Cell:
    cell = load_cell(workload)
    cfg = copy.deepcopy(cell.config)
    cfg.update(num_points=N, dim=D, num_shards=SHARDS, check_queries=CHECK_Q,
               check_slice=CHECK_Q, nprobes=2)
    if serving == "streamed":
        cfg.update(serving=serving, engine=dict(STREAMED_ENGINE))
    traffic = dict(cell.traffic, batch=batch, pool_batches_per_s=20,
                   warmup_seconds=0.1, warmup_batches=4, judged_queries=256)
    return cell._replace(config=cfg, traffic=traffic, limits=dict(LIMITS))


def tiny_artifact(cfg: dict) -> dict:
    base, q = datagen.base_and_check_queries(
        cfg["data"], cfg["num_points"], cfg["dim"], cfg["check_queries"],
        cfg["base_seed"])
    rng = np.random.default_rng(7)
    centres = base[rng.choice(len(base), SHARDS, replace=False)]
    d2 = ((base[:, None, :] - centres[None]) ** 2).sum(-1)
    assign = d2.argmin(1).astype(np.uint8)
    gt = ((q[:, None, :].astype(np.float64) - base[None].astype(np.float64))
          ** 2).sum(-1)
    gt_ids = np.argsort(gt, axis=1, kind="stable")[:, :10]
    sub = np.arange(0, len(base), 25)
    return {"assign": assign, "gt_ids": gt_ids.astype(np.int32),
            "gt_dists": np.take_along_axis(gt, gt_ids, 1).astype(np.float32),
            "routing_points": base[sub], "routing_labels":
            assign[sub].astype(np.int32)}
