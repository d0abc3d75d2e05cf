"""Parity of the port's clustering (``cluster/kmeans.py``,
``cluster/streaming.py``) with the JAX package.

Blob data is drawn with numpy and handed to both packages; both draw their
initial centroids and samples from the same ``np.random.default_rng`` seeds.
Assignments and parts must be identical, centroids agree at rtol = atol =
1e-4 (the port's Lloyd sums in f64), objectives at 1e-4 relative; balanced
k-means, whose batched moves can tip differently, is held to its balance
bound and to the JAX objective within 1e-3 relative.
"""

import importlib

import numpy as np
import pytest
import torch

# the packages re-export ``kmeans`` the function under the module's name
jk = importlib.import_module("gpann_tpu.cluster.kmeans")
js = importlib.import_module("gpann_tpu.cluster.streaming")
tk = importlib.import_module("gpann_tpu_torch.cluster.kmeans")
ts = importlib.import_module("gpann_tpu_torch.cluster.streaming")

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host, and torch's default of one thread per core
    oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def blobs(n=6000, kb=8, d=16, seed=555, spread=0.5, scale=4.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((kb, d)).astype(np.float32) * scale
    lbl = rng.integers(0, kb, size=n)
    return (centers[lbl] + spread * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def pts():
    return blobs()


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_kmeans_same_init_matches(pts, metric):
    init = pts[np.random.default_rng(1).choice(len(pts), 8, replace=False)]
    wc, wa = jk.kmeans(pts, centroids=init, metric=metric, rounds=10)
    gc, ga = tk.kmeans(pts, centroids=init, metric=metric, rounds=10,
                       device="cpu")
    assert ga.dtype == np.int32
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_allclose(gc, wc, **TOL)


def test_kmeans_seeded_and_weighted_matches(pts):
    w = np.random.default_rng(2).integers(0, 3, len(pts)).astype(np.float32)
    for weights in (None, w):
        wc, wa = jk.kmeans(pts, k=12, seed=7, weights=weights)
        gc, ga = tk.kmeans(pts, k=12, seed=7, weights=weights, device="cpu")
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_allclose(gc, wc, **TOL)
    np.testing.assert_array_equal(tk.random_sample(pts, 5, seed=3),
                                  jk.random_sample(pts, 5, seed=3))


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_objective_value_matches(pts, metric):
    cents, assign = jk.kmeans(pts, k=8, metric=metric)
    want = jk.objective_value(pts, cents, assign, metric)
    got = tk.objective_value(pts, cents, assign, metric, device="cpu")
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("metric,train_sample", [("l2", None), ("mips", None),
                                                  ("l2", 2000)])
def test_balanced_kmeans_bound_and_objective(metric, train_sample):
    pts = blobs(n=5003, kb=5, spread=1.0)  # uneven blobs: balance must bite
    k, eps = 8, 0.05
    wc, wa = jk.balanced_kmeans(pts, k, eps=eps, metric=metric,
                                train_sample=train_sample)
    gc, ga = tk.balanced_kmeans(pts, k, eps=eps, metric=metric,
                                train_sample=train_sample, device="cpu")
    cap = int((1 + eps) * np.ceil(len(pts) / k))
    assert np.bincount(ga, minlength=k).max() <= cap
    assert len(ga) == len(pts) and ga.min() >= 0
    want = jk.objective_value(pts, wc, wa, metric)
    got = tk.objective_value(pts, gc, ga, metric, device="cpu")
    assert got == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_final_centroids_sum_as_np_add_at(pts, metric):
    """The port's per-dimension ``np.bincount`` sums give the JAX package's
    ``np.add.at`` centroids bit for bit."""
    assign = np.random.default_rng(3).integers(0, 9, len(pts))
    assign[assign == 4] = 5  # an empty cluster
    gc, gs = tk._final_centroids(pts, assign, 9, metric)
    wc, ws = jk._final_centroids(pts, assign, 9, metric)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gs, ws)


def test_segment_sum_adds_in_index_order(pts):
    """On the CPU the segment sum adds in index order, as ``np.add.at`` does:
    bit-equal in f64 and in f32, rows and scalars alike."""
    assign = np.random.default_rng(4).integers(0, 7, len(pts))
    idx = torch.from_numpy(assign)
    for dtype, np_dtype in ((torch.float64, np.float64),
                            (torch.float32, np.float32)):
        for vals in (pts, pts[:, 0].copy()):
            want = np.zeros((7,) + vals.shape[1:], np_dtype)
            np.add.at(want, assign, vals.astype(np_dtype))
            got = tk._segment_sum(torch.from_numpy(vals), idx, 7, dtype)
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.numpy(), want)


def test_capacity_assignment_and_rebalance_match(pts):
    cents, assign = jk.kmeans(pts, k=10, seed=4)
    cap = int(1.02 * np.ceil(len(pts) / 10))
    want = jk._capacity_priority_assign(pts, cents, cap, "l2", block=1000)
    got = tk._capacity_priority_assign(pts, cents, cap, "l2", block=1000,
                                       device="cpu")
    np.testing.assert_array_equal(got, want)
    want = jk.rebalance_greedy(pts, cents, assign, cap, "l2")
    got = tk.rebalance_greedy(pts, cents, assign, cap, "l2", device="cpu")
    np.testing.assert_array_equal(got, want)


def test_streaming_kmeans_matches(pts):
    wc, wa = js.streaming_kmeans(pts, 8, rounds=5, chunk_rows=1700)
    gc, ga = ts.streaming_kmeans(pts, 8, rounds=5, chunk_rows=1700,
                                 device="cpu")
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_allclose(gc, wc, **TOL)


@pytest.mark.parametrize("eps", [0.05, 0.0])
def test_capacity_stream_assign_matches(pts, eps):
    """Same representatives -> identical parts, through the chunked first
    pass and the retry rounds (eps=0 leaves no slack, so many retry)."""
    rng = np.random.default_rng(5)
    reps = pts[rng.choice(len(pts), 300, replace=False)]
    labels = rng.integers(0, 7, len(reps))
    labels[:7] = np.arange(7)
    want = js.capacity_stream_assign(pts, reps, labels, 7, eps=eps,
                                     chunk_rows=2048)
    got = ts.capacity_stream_assign(pts, reps, labels, 7, eps=eps,
                                    chunk_rows=2048, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got).max() <= int((1 + eps) * np.ceil(len(pts) / 7))


@pytest.mark.parametrize("train_sample", [None, 2500])
def test_streaming_capacity_partition_matches(pts, train_sample):
    want = js.streaming_capacity_partition(pts, 6, rounds=5, chunk_rows=2500,
                                           train_sample=train_sample)
    got = ts.streaming_capacity_partition(pts, 6, rounds=5, chunk_rows=2500,
                                          train_sample=train_sample,
                                          device="cpu")
    np.testing.assert_array_equal(got, want)


def test_admit_priority_matches():
    rng = np.random.default_rng(6)
    target = rng.integers(0, 5, 500)
    d = rng.random(500).astype(np.float32)
    room_j = np.full(5, 80, np.int64)
    room_t = room_j.copy()
    want = js.admit_priority(target, d, room_j)
    got = ts.admit_priority(target, d, room_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(room_t, room_j)
