"""The build path on a CUDA device against the same functions on the CPU.

Every test needs a GPU (marker ``gpu``) and skips without one. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_gpu_build.py -q

The CPU results are held against the JAX package by the other
``tests/test_torch_*.py`` files; here the device must not change them: ties
go to the first index on both devices, LP part ids and k-means assignments
are identical, distances agree at rtol = atol = 1e-4.
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


def blobs(n, kb=8, d=16, seed=555, spread=0.5, scale=4.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((kb, d)).astype(np.float32) * scale
    lbl = rng.integers(0, kb, size=n)
    return (centers[lbl] + spread * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.gpu
def test_argmax_argmin_take_the_first_index(cuda):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 3, (4096, 37)).astype(np.float32)  # many ties
    for dev in ("cpu", cuda):
        t = torch.from_numpy(x).to(dev)
        np.testing.assert_array_equal(t.argmax(dim=1).cpu().numpy(),
                                      x.argmax(axis=1))
        np.testing.assert_array_equal(t.argmin(dim=1).cpu().numpy(),
                                      x.argmin(axis=1))


@pytest.mark.gpu
def test_byte_data_knn_graph_same_on_cuda(cuda):
    """Byte points have exact integer distances, so equal ones are common;
    ``topk_smallest`` orders them by position on both devices, the merge's
    sort keeps full ties in input order on both, and the approximate kNN
    graph of 12k u8 points (a sketching recursion) is the CPU's edge for
    edge (C12)."""
    from gpann_tpu_torch.core.distances import topk_smallest
    from gpann_tpu_torch.eval.synth import VirtualPoints
    from gpann_tpu_torch.graph.knn import ApproximateKNNGraphBuilder, _lexsort

    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 6, (8, 300, 2000)).astype(np.float32))
    for k in (1, 10):
        cv, ci = topk_smallest(x, k)
        gv, gi = topk_smallest(x.to(cuda), k)
        assert torch.equal(gi.cpu(), ci) and torch.equal(gv.cpu(), cv)
    keys = tuple(x[0, :3].reshape(3, -1))      # the merge's sort: 3 keys
    assert torch.equal(_lexsort(tuple(k.to(cuda) for k in keys)).cpu(),
                       _lexsort(keys))
    pts = np.asarray(VirtualPoints("hard2", 12_000, 16, 555, dtype="u8")[:],
                     np.float32)
    want = ApproximateKNNGraphBuilder(seed=555, device="cpu").build(pts, 10)
    got = ApproximateKNNGraphBuilder(seed=555, device=cuda).build(pts, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_partition_graph_same_on_cuda(cuda):
    from gpann_tpu_torch.gp.lp import partition_graph
    from gpann_tpu_torch.graph.knn import build_exact_knn_graph, symmetrize_to_csr

    pts = blobs(5000)
    indptr, indices, w = symmetrize_to_csr(
        build_exact_knn_graph(pts, 8, device="cpu"))
    want = partition_graph(indptr, indices, w, 8, device="cpu")
    got = partition_graph(indptr, indices, w, 8, device=cuda)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_kmeans_and_capacity_assignment_same_on_cuda(cuda):
    """Lloyd on well-separated blobs assigns identically; the capacity
    assignment admits by distance order, which f32 sums in another order
    may swap for near-equal distances, so it agrees on >= 99.9% of points
    and keeps the bound."""
    from gpann_tpu_torch.cluster.kmeans import balanced_kmeans, kmeans
    from gpann_tpu_torch.cluster.streaming import capacity_stream_assign

    pts = blobs(20_000)
    wc, wa = kmeans(pts, k=8, device="cpu")
    gc, ga = kmeans(pts, k=8, device=cuda)
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_allclose(gc, wc, **TOL)
    reps = pts[np.random.default_rng(2).choice(len(pts), 500, replace=False)]
    labels = np.arange(500) % 9
    want = capacity_stream_assign(pts, reps, labels, 9, chunk_rows=4096,
                                  device="cpu")
    got = capacity_stream_assign(pts, reps, labels, 9, chunk_rows=4096,
                                 device=cuda)
    assert (got == want).mean() >= 0.999, (got != want).sum()
    assert np.bincount(got).max() <= int(1.05 * np.ceil(len(pts) / 9))
    _, ga = balanced_kmeans(pts, 8, device=cuda)
    assert np.bincount(ga).max() <= int(1.05 * np.ceil(len(pts) / 8))


@pytest.mark.gpu
def test_knn_graph_and_gt_same_on_cuda(cuda):
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.eval.recall import compute_ground_truth
    from gpann_tpu_torch.graph.knn import ApproximateKNNGraphBuilder, graph_recall

    pts = blobs(12_000, kb=10, d=10)
    want = ApproximateKNNGraphBuilder(device="cpu").build(pts, 6)
    got = ApproximateKNNGraphBuilder(device=cuda).build(pts, 6)
    assert graph_recall(got, want) >= 0.99
    q = pts[::100] + 0.01
    wi, wd = compute_ground_truth(pts, q, 10, device="cpu")
    kernels.reset_launches()
    gi, gd = compute_ground_truth(pts, q, 10, device=cuda)
    assert kernels.LAUNCHES["binmin_scan"] == 1
    np.testing.assert_allclose(gd, wd, **TOL)


@pytest.mark.gpu
def test_tree_router_same_on_cuda(cuda):
    """The router's k-means meets near ties (more centroids than blobs); it
    runs in f64 with sums in a fixed order, so the card repeats itself
    exactly, in the default (not the deterministic) mode, and gives the
    CPU's router."""
    from gpann_tpu_torch.route import KMeansTreeRouter, KMeansTreeRouterOptions

    pts = blobs(8000)
    clusters = [np.arange(s, 8000, 4) for s in range(4)]
    opts = KMeansTreeRouterOptions(num_centroids=8, min_cluster_size=40,
                                   budget=300, search_budget=120)
    assert not torch.are_deterministic_algorithms_enabled()
    want = KMeansTreeRouter(device="cpu").train(pts, clusters, opts)
    got = KMeansTreeRouter(device=cuda).train(pts, clusters, opts)
    again = KMeansTreeRouter(device=cuda).train(pts, clusters, opts)
    np.testing.assert_array_equal(again.points, got.points)
    assert len(got.points) == len(want.points)
    np.testing.assert_allclose(got.points, want.points, **TOL)
    q = pts[:64] + 0.05
    np.testing.assert_array_equal(got.query_budgeted(q), want.query_budgeted(q))


@pytest.mark.gpu
def test_segment_sum_repeats_on_cuda(cuda):
    """k-means' segment sums add in a fixed order on the card (no atomics):
    two calls are bit-equal, and the f64 sums agree with the CPU's."""
    from gpann_tpu_torch.cluster.kmeans import _segment_sum

    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.standard_normal((200_000, 16)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 9, len(vals)))
    for dtype in (torch.float64, torch.float32):
        a = _segment_sum(vals.to(cuda), idx.to(cuda), 9, dtype)
        b = _segment_sum(vals.to(cuda), idx.to(cuda), 9, dtype)
        assert torch.equal(a, b)
    np.testing.assert_allclose(
        _segment_sum(vals.to(cuda), idx.to(cuda), 9).cpu().numpy(),
        _segment_sum(vals, idx, 9).numpy(), rtol=1e-12, atol=1e-9)


@pytest.mark.gpu
def test_balanced_kmeans_repeats_on_cuda(cuda):
    """Balanced k-means (the two-level index's sub-clusters) gives the same
    centroids and assignment in two runs on the card."""
    from gpann_tpu_torch.cluster.kmeans import balanced_kmeans

    pts = blobs(20_000, kb=5)
    gc, ga = balanced_kmeans(pts, 12, device=cuda)
    hc, ha = balanced_kmeans(pts, 12, device=cuda)
    np.testing.assert_array_equal(ha, ga)
    np.testing.assert_array_equal(hc, gc)


@pytest.mark.gpu
def test_cli_on_cuda(cuda, tmp_path):
    """KMeans on well-separated blobs writes the CPU run's file; GP (whose
    kNN graph may differ in near-tied edges) holds the balance bound."""
    from gpann_tpu_torch.cli import partition as cli
    from gpann_tpu_torch.core.metis_io import read_clusters
    from gpann_tpu_torch.core.pointset import write_points

    path = str(tmp_path / "pts.fbin")
    write_points(path, blobs(3000, kb=6, d=8))
    assert cli.main([path, str(tmp_path / "cpu"), "6", "KMeans",
                     "--device", "cpu"]) == 0
    assert cli.main([path, str(tmp_path / "gpu"), "6", "KMeans"]) == 0
    assert ((tmp_path / "gpu.k=6.KMeans").read_bytes()
            == (tmp_path / "cpu.k=6.KMeans").read_bytes())
    assert cli.main([path, str(tmp_path / "gpu"), "6", "GP"]) == 0
    sizes = [len(c) for c in read_clusters(str(tmp_path / "gpu.k=6.GP"))]
    assert sum(sizes) == 3000 and max(sizes) <= int(1.05 * np.ceil(3000 / 6))
