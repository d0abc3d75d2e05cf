"""OracleRecall CLI of the PyTorch port — recall-vs-nprobes curves per
routing config + oracle (counterpart of ``gpann_tpu/cli/oracle_recall.py``;
reference ``oracle_recall.cpp``, C21).

For each routing config in a ``*.routes`` file, compute cumulative recall
per probe count with dedup across probes (``oracle_recall.cpp:10-38``); pick
the config with the best first-shard recall; then emit the GT-frequency
oracle probe order's curve (``:97-119``). CSV schema:
``partitioning,num probes,recall,type`` (``oracle_recall.cpp:92``).

Usage:
    python -m gpann_tpu_torch.cli.oracle_recall \
        <ground_truth.bin> <routes_file> <k> <clusters_file> <part_method> <out.csv>

Host numpy only (no ``--device``). The point -> shards membership is built
once as CSR arrays rather than as a per-point list, so a cover of millions of
points is read once for all routes; the CSV is the JAX CLI's.
"""

from __future__ import annotations

import sys

import numpy as np

from gpann_tpu_torch.core import read_clusters, read_ground_truth
from gpann_tpu_torch.core.partition import clusters_to_cover_csr, csr_gather
from gpann_tpu_torch.eval.combination import deserialize_routes


def recall_for_increasing_probes(probe_orders, cover, gt_ids, k, num_shards):
    """Cumulative recall per probe with cross-probe dedup
    (oracle_recall.cpp:10-38), vectorized: each GT neighbor contributes at
    the FIRST probe whose shard contains it; the curve is a cumsum of a
    bincount over those first-probe indices.

    ``cover`` is the point -> shards membership in CSR form ``(indptr,
    indices)``, as :func:`clusters_to_cover_csr` builds it (the JAX function
    takes the per-point list)."""
    nq = len(gt_ids)
    gt = np.asarray(gt_ids)[:, :k]
    P = np.full((nq, num_shards), -1, np.int32)
    for q, po in enumerate(probe_orders):
        po = np.asarray(po, np.int64)[:num_shards]
        P[q, : len(po)] = po
    # membership over only the points that appear in the GT (compact ids),
    # built with one ragged CSR gather (no per-point Python loop)
    uniq, inv = np.unique(gt, return_inverse=True)
    memb = np.zeros((len(uniq), num_shards), bool)
    indptr, indices = cover
    owners, shards = csr_gather(indptr, indices, uniq)
    memb[owners, shards] = True
    Mq = memb[inv.reshape(nq, k)]  # [nq, k, s]
    Psafe = np.where(P < 0, 0, P).astype(np.int64)
    idx = np.broadcast_to(Psafe[:, None, :], (nq, k, num_shards))
    found = np.take_along_axis(Mq, idx, axis=2) & (P >= 0)[:, None, :]
    any_found = found.any(axis=2)
    first_p = np.where(any_found, found.argmax(axis=2), num_shards)
    counts = np.bincount(
        first_p.reshape(-1), minlength=num_shards + 1
    )[:num_shards]
    return (np.cumsum(counts) / (k * nq)).tolist()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 6:
        print(__doc__)
        return 2
    gt_file, routes_file, k_str, part_file, part_method, out_file = argv[:6]
    k = int(k_str)

    gt_ids, _ = read_ground_truth(gt_file)
    clusters = read_clusters(part_file)
    num_shards = len(clusters)
    n = int(max(c.max() for c in clusters if len(c))) + 1
    cover = clusters_to_cover_csr(clusters, n)

    routes = deserialize_routes(routes_file)
    curves = []
    for r in routes:
        probe_orders = [r.buckets_to_probe[q] for q in range(len(gt_ids))]
        curves.append(
            recall_for_increasing_probes(probe_orders, cover, gt_ids, k, num_shards)
        )
    best = int(np.argmax([c[0] for c in curves])) if curves else -1
    lines = ["partitioning,num probes,recall,type"]
    if best >= 0:
        print(f"best config {best} first shard recall {curves[best][0]:.4f}")
        for j, rec in enumerate(curves[best]):
            lines.append(f"{part_method},{j},{rec},brute-force-shard-search")

    # GT-frequency oracle probe order (oracle_recall.cpp:97-119): how many of
    # a query's first k GT neighbors each shard holds
    nq = len(gt_ids)
    freq = np.zeros((nq, num_shards), np.int32)
    owners, shards = csr_gather(*cover, np.asarray(gt_ids)[:, :k].reshape(-1))
    np.add.at(freq, (owners // k, shards), 1)
    oracle_orders = np.argsort(-freq, axis=1, kind="stable")
    oracle_curve = recall_for_increasing_probes(
        list(oracle_orders), cover, gt_ids, k, num_shards
    )
    print(f"oracle recall. first shard {oracle_curve[0]:.4f}")
    for j, rec in enumerate(oracle_curve):
        lines.append(f"{part_method},{j},{rec},oracle")

    with open(out_file, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
