"""Parity of the port's overlapping partitioning (``gp/overlap.py`` and the
O* methods of ``gp/api.py`` and ``cli/partition.py``) with the JAX package.

Blob data is drawn with numpy from seed 555 and handed to both packages.
Covers are compared as sets of members per cluster: the extra members are
appended in admission order, and f32 sums in another order may swap two
near-equal distances there. Given the same kNN graph (``graph=``), OGP
returns the JAX cover; so do the centroid method, the streamed overlap and
the OKM / ORKM methods.
Methods whose base partition depends on the approximate kNN graph or on
distance-priority admission (OGP without a graph, OGPS, OBKM, GP with
overlap) may move near-tied points between the packages (f32 sums in
another order); for them every cluster must hold the capacity bound
``int((1+eps)*n/k)``, every point must be covered and the extra assignments
must stay within ``overlap*n``. Candidate distances agree at rtol = 1e-5,
atol = 1e-4: they are not rescored, and the expanded form
``|p|^2 + |r|^2 - 2 p.r`` cancels terms of up to ~300 here.
"""

import time

import numpy as np
import pytest
import torch

from gpann_tpu import native as jn
from gpann_tpu.cli import partition as jcli
from gpann_tpu.gp import api as japi
from gpann_tpu.gp import overlap as jov
from gpann_tpu.gp.scale import gp_aggregates
from gpann_tpu.graph.knn import ApproximateKNNGraphBuilder
from gpann_tpu_torch.cli import partition as tcli
from gpann_tpu_torch.core.metis_io import read_clusters
from gpann_tpu_torch.core.partition import partition_to_clusters
from gpann_tpu_torch.core.pointset import write_points
from gpann_tpu_torch.gp import api as tapi
from gpann_tpu_torch.gp import overlap as tov

TOL = dict(rtol=1e-5, atol=1e-4)
N, K, EPS, OVERLAP = 2000, 8, 0.05, 0.2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host, and torch's default of one thread per core
    oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library (see test_torch_graph_gp.py)."""
    for _ in range(2):
        if jn.available():
            return jn
        time.sleep(2.0)
        jn._lib, jn._tried = None, False
    pytest.fail("the JAX package's native library did not load")


def blobs(n, kb=8, d=10, seed=555, spread=0.4, scale=4.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((kb, d)).astype(np.float32) * scale
    lbl = rng.integers(0, kb, size=n)
    return (centers[lbl] + spread * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def pts():
    return blobs(N)


def same_cover(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.sort(g), np.sort(w))


def check_cover(clusters, n, k, eps=EPS, overlap=OVERLAP):
    """Capacity bound, every point covered, extra assignments bounded."""
    cap = int((1.0 + eps) * n / k)
    sizes = np.asarray([len(c) for c in clusters])
    assert sizes.max() <= cap, (sizes, cap)
    allp = np.concatenate(clusters)
    assert len(np.unique(allp)) == n and allp.min() >= 0 and allp.max() < n
    assert n <= sizes.sum() <= n + int(overlap * n)
    for c in clusters:
        assert len(np.unique(c)) == len(c)  # no point twice in one cluster


def test_ogp_with_graph_matches(pts, jax_native):
    graph = ApproximateKNNGraphBuilder(seed=555).build(pts, 10)
    want = jov.overlapping_graph_partitioning(pts, K, graph=graph)
    got = tov.overlapping_graph_partitioning(pts, K, graph=graph, device="cpu")
    same_cover(got, want)
    check_cover(got, N, K)
    assert sum(len(c) for c in got) > N  # extra assignments were admitted


def test_centroid_method_matches(pts):
    part = np.argsort(pts[:, 0], kind="stable") * K // N  # slabs along x0
    clusters = partition_to_clusters(part.astype(np.int32), K)
    cap = int(1.05 * N / K) + 40
    want = jov.make_overlapping_with_centroids(pts, clusters, cap, 300)
    got = tov.make_overlapping_with_centroids(pts, clusters, cap, 300,
                                              device="cpu")
    same_cover(got, want)
    assert max(len(c) for c in got) <= cap
    assert sum(len(c) for c in got) == N + 300


@pytest.fixture(scope="module")
def reps(pts):
    assign = np.random.default_rng(1).integers(0, K, N).astype(np.int32)
    assign[np.argsort(pts[:, 1])[:600]] = 3  # one large cluster
    r, lbl = gp_aggregates(pts, assign, K, 16 * K, seed=555)
    return assign, np.asarray(r), np.asarray(lbl)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_foreign_cluster_candidates_match(pts, reps, metric):
    assign, r, lbl = reps
    wd, wc = jov.foreign_cluster_candidates(pts, assign, r, lbl, K,
                                            metric=metric, block=512)
    gd, gc = tov.foreign_cluster_candidates(pts, assign, r, lbl, K,
                                            metric=metric, block=512,
                                            device="cpu")
    assert gd.shape == (N, 5) and gc.dtype == np.int32
    np.testing.assert_allclose(gd, wd, **TOL)
    # clusters through their exact (f64) closest-representative distance:
    # near-tied ranks may swap two clusters
    p64, r64 = pts.astype(np.float64), r.astype(np.float64)
    if metric == "mips":
        dm = 1.0 - p64 @ r64.T
    else:
        dm = ((p64[:, None, :] - r64[None]) ** 2).sum(-1)
    best = np.full((N, K), np.inf)
    for c in range(K):
        best[:, c] = dm[:, lbl == c].min(axis=1)
    np.testing.assert_allclose(np.take_along_axis(best, gc, 1), wd, **TOL)
    assert (np.mean(gc == wc)) >= 0.999
    assert (gc != assign[:, None]).all()  # never the point's own cluster
    assert all(len(set(row)) == 5 for row in gc.tolist())


def test_centroid_overlap_streamed_matches(pts, reps):
    assign, r, lbl = reps
    cap2 = int(1.05 * 1.2 * N / K)
    kw = dict(keep=3, block=700, admit_chunk=1500)
    wp, wc = jov.centroid_overlap_streamed(pts, assign, r, lbl, K, cap2,
                                           int(OVERLAP * N), **kw)
    gp_, gc = tov.centroid_overlap_streamed(pts, assign, r, lbl, K, cap2,
                                            int(OVERLAP * N), device="cpu",
                                            **kw)
    pairs = lambda p, c: sorted(zip(p.tolist(), c.tolist()))  # noqa: E731
    assert pairs(gp_, gc) == pairs(wp, wc)
    clusters = partition_to_clusters(assign, K)
    got = tov.apply_extra_assignments(clusters, gp_, gc)
    same_cover(got, jov.apply_extra_assignments(clusters, wp, wc))
    sizes = np.asarray([len(c) for c in got])
    # the large base cluster is over cap2 already and takes no extras
    assert (sizes[sizes > cap2] == np.bincount(assign, minlength=K)[sizes > cap2]).all()
    assert (sizes[np.bincount(assign, minlength=K) <= cap2] <= cap2).all()
    assert N < sizes.sum() <= N + int(OVERLAP * N)


@pytest.mark.parametrize("method", ["OKM", "ORKM"])
def test_overlapping_methods_match(pts, method):
    want = japi.partition(pts, K, method, overlap=OVERLAP)
    got = tapi.partition(pts, K, method, overlap=OVERLAP, device="cpu")
    same_cover(got, want)
    check_cover(got, N, K)


@pytest.mark.parametrize("method,overlap", [("OGP", 0.2), ("OGPS", 0.2),
                                            ("OBKM", 0.2), ("GP", 0.1)])
def test_overlapping_methods_hold_the_bound(pts, jax_native, method, overlap):
    got = tapi.partition(pts, K, method, overlap=overlap, device="cpu")
    check_cover(got, N, K, overlap=overlap)
    want = japi.partition(pts, K, method, overlap=overlap)
    # near ties may move a few assignments; the cover's size stays close
    total = lambda cl: sum(len(c) for c in cl)  # noqa: E731
    assert abs(total(got) - total(want)) <= 0.02 * N


def test_partition_cli_writes_the_jax_cover(tmp_path):
    path = str(tmp_path / "pts.fbin")
    write_points(path, blobs(1500, kb=6, d=8))
    assert jcli.main([path, str(tmp_path / "jax"), "6", "OKM"]) == 0
    assert tcli.main([path, str(tmp_path / "port"), "6", "OKM",
                      "--device", "cpu"]) == 0
    want = (tmp_path / "jax.k=6.OKM.o=0.2").read_bytes()
    assert (tmp_path / "port.k=6.OKM.o=0.2").read_bytes() == want
    check_cover(read_clusters(str(tmp_path / "port.k=6.OKM.o=0.2")), 1500, 6)
