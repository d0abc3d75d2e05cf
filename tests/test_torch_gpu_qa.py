"""The query-attribution slice on a CUDA device against the same functions on
the CPU.

Every test needs a GPU (marker ``gpu``) and skips without one. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_gpu_qa.py -q

The CPU results are held against the JAX package by
``tests/test_torch_{ivf_sweeps,overlap,query_attribution}.py``; here the
device must not change them beyond near ties (f32 sums in another order may
move a few near-tied balanced k-means, admission and routing choices;
Lloyd runs in f64 and does not move): exact-scan distances
agree at rtol = atol = 1e-4, in-shard hit counts within 2%, the QA CLI's
recall exactly where routing plays no part and on average within 0.01
elsewhere, and every cover holds its capacity bound.
"""

import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda:0")


def blobs(n, kb=8, d=16, seed=555, spread=0.5, scale=4.0, nq=64):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((kb, d)).astype(np.float32) * scale
    lbl = rng.integers(0, kb, size=n)
    pts = (centers[lbl] + spread * rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, kb, size=nq)]
         + spread * rng.standard_normal((nq, d))).astype(np.float32)
    return pts, q


def slabs(pts, k):
    from gpann_tpu_torch.core.partition import partition_to_clusters

    order = np.argsort(pts[:, 0], kind="stable")
    part = np.empty(len(pts), np.int32)
    part[order] = np.arange(len(pts)) * k // len(pts)
    return partition_to_clusters(part, k)


@pytest.mark.gpu
def test_time_fn_waits_for_the_device(cuda):
    from gpann_tpu_torch.core.timer import time_fn

    x = torch.randn(4096, 4096, device=cuda)

    def work():
        y = x
        for _ in range(20):
            y = y @ x
        return y

    t, _ = time_fn(work, reps=2, device=cuda)
    assert torch.cuda.current_stream(cuda).query()  # nothing left queued
    assert t > 1e-3  # 20 GEMMs of 4096^3, not 20 launches


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_ivf_index_same_on_cuda(cuda, metric):
    from gpann_tpu_torch.search.ivf import IVFIndex

    pts, q = blobs(20_000)
    clusters = slabs(pts, 6)
    clusters[2] = np.concatenate([clusters[2], clusters[3][:500]])  # overlap
    cpu = IVFIndex(pts, clusters, metric=metric, device="cpu")
    gpu = IVFIndex(pts, clusters, metric=metric, device=cuda)
    np.testing.assert_allclose(gpu.search_all_shards(q, 10)[0],
                               cpu.search_all_shards(q, 10)[0], **TOL)
    probes = np.stack([np.random.default_rng(s).permutation(6)[:3]
                       for s in range(len(q))]).astype(np.int32)
    np.testing.assert_allclose(gpu.search_probed(q, probes, 10)[0],
                               cpu.search_probed(q, probes, 10)[0], **TOL)
    np.testing.assert_allclose(gpu.search_probed_grouped(q, probes, 10)[0],
                               cpu.search_probed_grouped(q, probes, 10)[0], **TOL)


@pytest.mark.gpu
def test_shard_sweep_recall_same_on_cuda(cuda):
    from gpann_tpu_torch.eval.recall import compute_ground_truth, kth_neighbor_distance
    from gpann_tpu_torch.search.shard_sweep import run_in_shard_searches

    pts, q = blobs(20_000)
    clusters = slabs(pts, 4)
    _, gd = compute_ground_truth(pts, q, 10, device="cpu")
    kth = kth_neighbor_distance(gd, 10)
    kw = dict(sub_nprobe_sweep=(1, 4, 99), timing_reps=1, target_sub_size=512)
    want = run_in_shard_searches(pts, q, clusters, kth, 10, device="cpu", **kw)
    got = run_in_shard_searches(pts, q, clusters, kth, 10, device=cuda, **kw)
    assert [s.ef_search for s in got] == [s.ef_search for s in want]

    def hits(s):
        return sum(len(h) for shard in s.hits for h in shard)

    for g, w in zip(got, want):
        assert abs(hits(g) - hits(w)) <= 0.02 * w.time_query_in_shard.size * 10
    assert hits(got[-1]) == hits(want[-1])  # exact coverage: exact hits


@pytest.mark.gpu
def test_overlap_same_on_cuda(cuda):
    from gpann_tpu_torch.gp import api
    from gpann_tpu_torch.gp.overlap import (
        centroid_overlap_streamed,
        foreign_cluster_candidates,
        overlapping_graph_partitioning,
    )
    from gpann_tpu_torch.graph.knn import ApproximateKNNGraphBuilder

    pts, _ = blobs(6000, d=12)
    n, k = len(pts), 8
    cap = int(1.05 * n / k)
    graph = ApproximateKNNGraphBuilder(device="cpu").build(pts, 10)
    cpu = overlapping_graph_partitioning(pts, k, graph=graph, device="cpu")
    gpu = overlapping_graph_partitioning(pts, k, graph=graph, device=cuda)
    for cover in (cpu, gpu):
        assert max(len(c) for c in cover) <= cap
        assert n < sum(len(c) for c in cover) <= 1.2 * n
    assign = np.arange(n) % k
    reps = pts[::25]
    lbl = assign[::25]
    wd, _ = foreign_cluster_candidates(pts, assign, reps, lbl, k, device="cpu")
    gd, _ = foreign_cluster_candidates(pts, assign, reps, lbl, k, device=cuda)
    np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-3)
    cap2 = int(1.05 * 1.2 * n / k)
    ep, ec = centroid_overlap_streamed(pts, assign, reps, lbl, k, cap2,
                                       int(0.2 * n), device=cuda)
    sizes = np.bincount(assign, minlength=k) + np.bincount(ec, minlength=k)
    assert sizes.max() <= cap2 and 0 < len(ep) <= int(0.2 * n)
    for method in ("OGP", "OKM", "OBKM"):
        cover = api.partition(pts, k, method, overlap=0.2, device=cuda)
        assert max(len(c) for c in cover) <= cap, method
        assert len(np.unique(np.concatenate(cover))) == n


@pytest.mark.gpu
def test_query_attribution_cli_on_cuda(cuda, tmp_path):
    """The QA CLI on the card launches kernel B2 for its ground truth, finds
    the CPU run's in-shard hits (each shard is one exact sub-cluster), and
    reaches its recall: exactly where routing plays no part (the Random
    route, whose probe orders come from the seed, and every row at nprobes
    = all shards), on average within 0.01 elsewhere. The routers rank their
    routing points by f32 distances, which may break near ties differently
    on the card (C6) and move a few of the 40 queries' probe orders."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.cli import query_attribution
    from gpann_tpu_torch.core.metis_io import write_clusters
    from gpann_tpu_torch.core.pointset import write_points

    pts, q = blobs(12_000, kb=6, d=12, nq=40)
    write_points(str(tmp_path / "base.fbin"), pts)
    write_points(str(tmp_path / "q.fbin"), q)
    write_clusters(str(tmp_path / "part"), slabs(pts, 4))

    def run(device, tag):
        return query_attribution.main(
            [str(tmp_path / "base.fbin"), str(tmp_path / "q.fbin"),
             str(tmp_path / f"gt_{tag}.bin"), "10", str(tmp_path / "part"), "4",
             str(tmp_path / tag), "Slabs", "l2", "2000", "--device", device])

    assert run("cpu", "cpu") == 0
    kernels.reset_launches()
    assert run("cuda", "gpu") == 0
    assert kernels.LAUNCHES["binmin_scan"] == 1

    from gpann_tpu_torch.eval.combination import deserialize_searches

    got, want = (deserialize_searches(str(tmp_path / f"{tag}.searches"))
                 for tag in ("gpu", "cpu"))
    assert [s.ef_search for s in got] == [s.ef_search for s in want]
    for g, w in zip(got, want):
        for gb, wb in zip(g.hits, w.hits):
            for gq, wq in zip(gb, wb):
                np.testing.assert_array_equal(np.sort(gq), np.sort(wq))

    def recalls(tag):
        rows = (tmp_path / f"{tag}.csv").read_text().strip().split("\n")[1:]
        cols = [r.split(",") for r in rows]
        return (np.asarray([float(c[8]) for c in cols]),
                np.asarray([c[2] == "Random" for c in cols]),
                np.asarray([int(c[7]) == 4 for c in cols]))

    (got, rnd, full), (want, _, _) = recalls("gpu"), recalls("cpu")
    assert got.shape == want.shape and rnd.any() and full.any()
    np.testing.assert_array_equal(got[rnd | full], want[rnd | full])
    assert np.abs(got - want).mean() <= 0.01
    assert got.max() == 1.0
