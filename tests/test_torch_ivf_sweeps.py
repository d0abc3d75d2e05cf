"""Parity of the port's in-shard search and sweep layer with the JAX package:
``search/ivf.py`` (``IVFIndex``, ``hits_per_shard``, ``merge_shard_topk``),
``search/two_level.py``, ``search/shard_sweep.py``, ``route/sweep.py``,
``core/timer.py`` and ``core/profiling.py``.

The fixture is ``tests/test_combination.py``'s (2000 x 12 points in 4 blobs,
16 queries, seed 555, a balanced 4-way clustering), drawn with numpy and
handed to both packages. Distances agree at rtol = atol = 1e-5; ids are
compared through their exact distances (ties may resolve differently);
sub-clusters, hit sets, probe orders and the routing configs' fields are
identical.
"""

import numpy as np
import pytest
import torch

from gpann_tpu.cluster import balanced_kmeans
from gpann_tpu.core.partition import partition_to_clusters
from gpann_tpu.eval import compute_ground_truth, kth_neighbor_distance
from gpann_tpu.route import flat as jflat
from gpann_tpu.route import sweep as jsweep
from gpann_tpu.search import ivf as jivf
from gpann_tpu.search import shard_sweep as jss
from gpann_tpu.search import two_level as jtl
from gpann_tpu_torch.core import profiling as tprof
from gpann_tpu_torch.core import timer as ttimer
from gpann_tpu_torch.route import flat as tflat
from gpann_tpu_torch.route import sweep as tsweep
from gpann_tpu_torch.search import ivf as tivf
from gpann_tpu_torch.search import shard_sweep as tss
from gpann_tpu_torch.search import two_level as ttl

TOL = dict(rtol=1e-5, atol=1e-5)


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
def setup():
    rng = np.random.default_rng(555)
    kb, d, n, nq = 4, 12, 2000, 16
    centers = rng.standard_normal((kb, d)).astype(np.float32) * 4
    lbl = rng.integers(0, kb, size=n)
    pts = (centers[lbl] + 0.4 * rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, kb, size=nq)]
         + 0.4 * rng.standard_normal((nq, d))).astype(np.float32)
    gt_ids, gt_dists = compute_ground_truth(pts, q, 10)
    _, assign = balanced_kmeans(pts, k=4, eps=0.3, seed=1)
    clusters = partition_to_clusters(assign, 4)
    return pts, q, gt_ids, gt_dists, clusters


def overlapped(clusters, n, seed=3):
    """The clustering plus 150 extra memberships: every cluster takes some
    points of the next one, so ids repeat across shards."""
    rng = np.random.default_rng(seed)
    out = []
    for b, c in enumerate(clusters):
        nxt = clusters[(b + 1) % len(clusters)]
        extra = rng.choice(nxt, size=150, replace=False)
        out.append(np.concatenate([c, extra]).astype(np.int32))
    return out


def exact(pts, q, ids, metric):
    """Exact f32 distances of ``pts[ids]`` to each query row ([m, k] ids)."""
    safe = np.where(ids < 0, 0, ids)
    if metric == "mips":
        return 1.0 - np.einsum("md,mkd->mk", q, pts[safe])
    return ((q[:, None, :] - pts[safe]) ** 2).sum(-1)


def check_ids(pts, q, dists, ids, metric):
    """Every finite entry's id lies at its reported distance."""
    fin = np.isfinite(dists)
    assert (ids[fin] >= 0).all()
    np.testing.assert_allclose(exact(pts, q, ids, metric)[fin], dists[fin],
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=[("l2", False), ("mips", False),
                                        ("l2", True)],
                ids=["l2", "mips", "l2-overlap"])
def indices(request, setup):
    pts, q, _, _, clusters = setup
    metric, overlap = request.param
    cl = overlapped(clusters, len(pts)) if overlap else clusters
    return (pts, q, metric, jivf.IVFIndex(pts, cl, metric=metric),
            tivf.IVFIndex(pts, cl, metric=metric, device="cpu"))


def test_ivf_layout_matches(indices):
    pts, q, metric, ji, ti = indices
    assert (ti.num_shards, ti.capacity, ti.overlapping) == (
        ji.num_shards, ji.capacity, ji.overlapping)
    np.testing.assert_array_equal(ti.shard_points.numpy(),
                                  np.asarray(ji.shard_points))
    np.testing.assert_array_equal(ti.shard_ids.numpy(), np.asarray(ji.shard_ids))
    np.testing.assert_array_equal(ti.sizes_np, ji.sizes_np)


def test_search_all_shards_matches(indices):
    pts, q, metric, ji, ti = indices
    wd, wi = ji.search_all_shards(q, 10)
    gd, gi = ti.search_all_shards(q, 10)
    assert gd.shape == wd.shape and gi.dtype == np.int32
    np.testing.assert_allclose(gd, wd, **TOL)
    for b in range(ti.num_shards):
        check_ids(pts, q, gd[b], gi[b], metric)


def test_search_probed_matches(indices):
    pts, q, metric, ji, ti = indices
    rng = np.random.default_rng(4)
    probes = np.stack([rng.permutation(4)[:2] for _ in range(len(q))])
    probes[::3, 1] = -1  # -1 padding
    probes = probes.astype(np.int32)
    wd, _ = ji.search_probed(q, probes, 10)
    gd, gi = ti.search_probed(q, probes, 10)
    np.testing.assert_allclose(gd, np.asarray(wd), **TOL)
    check_ids(pts, q, gd, gi, metric)
    wd, wi = ji.search_probed_grouped(q, probes, 10, query_block=8)
    gd, gi = ti.search_probed_grouped(q, probes, 10, query_block=8)
    np.testing.assert_allclose(gd, wd, **TOL)
    check_ids(pts, q, gd, gi, metric)
    # the grouped path dedups ids on an overlapping index
    fin = np.isfinite(gd)
    for row, live in zip(gi, fin):
        assert len(np.unique(row[live])) == live.sum()


def test_grouped_without_probes_is_empty(indices):
    _, q, _, ji, ti = indices
    probes = np.full((len(q), 2), -1, np.int32)
    gd, gi = ti.search_probed_grouped(q, probes, 10)
    wd, wi = ji.search_probed_grouped(q, probes, 10)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gi, wi)


def test_hits_and_merge_match(setup):
    pts, q, _, gt_dists, clusters = setup
    kth = kth_neighbor_distance(gt_dists, 10)
    d, i = jivf.IVFIndex(pts, overlapped(clusters, len(pts))).search_all_shards(q, 10)
    np.testing.assert_array_equal(tivf.hits_per_shard(d, kth),
                                  jivf.hits_per_shard(d, kth))
    order = np.stack([np.random.default_rng(s).permutation(4)
                      for s in range(len(q))]).astype(np.int32)
    for nprobes in (1, 2, 4):
        gd, gi = tivf.merge_shard_topk(d, i, order, nprobes, 10)
        wd, wi = jivf.merge_shard_topk(d, i, order, nprobes, 10)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gi, wi)


@pytest.fixture(scope="module")
def two_level(setup):
    pts, q, _, _, clusters = setup
    return (jtl.TwoLevelIVF(pts, clusters, target_sub_size=256, seed=2),
            ttl.TwoLevelIVF(pts, clusters, target_sub_size=256, seed=2,
                            device="cpu"))


def test_two_level_sub_clusters_match(two_level):
    j, t = two_level
    assert t.num_subs == j.num_subs > t.num_shards
    assert t.max_subs_per_shard == j.max_subs_per_shard
    np.testing.assert_array_equal(t.shard_of_sub, j.shard_of_sub)
    for a, b in zip(t.sub_clusters, j.sub_clusters):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(t.sub_centroids, j.sub_centroids, **TOL)


@pytest.mark.parametrize("sub_nprobe", [1, 3, 100])
def test_two_level_search_matches(setup, two_level, sub_nprobe):
    pts, q, _, _, _ = setup
    j, t = two_level
    probes = np.tile(np.array([2, 0], np.int32), (len(q), 1))
    np.testing.assert_array_equal(t.sub_probes(q, probes, sub_nprobe),
                                  j.sub_probes(q, probes, sub_nprobe))
    for grouped in (True, False):
        wd, _ = j.search(q, probes, 10, sub_nprobe, grouped=grouped)
        gd, gi = t.search(q, probes, 10, sub_nprobe, grouped=grouped)
        np.testing.assert_allclose(gd, np.asarray(wd), **TOL)
        check_ids(pts, q, gd, gi, "l2")
    wd, _ = j.search_all_shards(q, 10, sub_nprobe)
    gd, _ = t.search_all_shards(q, 10, sub_nprobe)
    np.testing.assert_allclose(gd, wd, **TOL)


def test_shard_sweep_hits_match(setup):
    pts, q, _, gt_dists, clusters = setup
    kth = kth_neighbor_distance(gt_dists, 10)
    # seed 2: the sub-cluster k-means of both packages meet no near tie
    # (with seed 555 one Lloyd round flips 2 of 477 points on f32 sum order)
    kw = dict(sub_nprobe_sweep=(1, 2, 8, 99), timing_reps=1,
              target_sub_size=256, seed=2)
    want = jss.run_in_shard_searches(pts, q, clusters, kth, 10, **kw)
    got = tss.run_in_shard_searches(pts, q, clusters, kth, 10, device="cpu",
                                    **kw)
    assert [s.ef_search for s in got] == [s.ef_search for s in want]
    for gs, ws in zip(got, want):
        assert gs.time_query_in_shard.shape == (4, len(q))
        assert (gs.time_query_in_shard > 0).all()
        for b in range(4):
            for qi in range(len(q)):
                np.testing.assert_array_equal(np.sort(gs.hits[b][qi]),
                                              np.sort(ws.hits[b][qi]))


ROUTE_FIELDS = ("index_trainer", "routing_algorithm",
                "hnsw_num_voting_neighbors", "hnsw_ef_search",
                "routing_index_options", "routing_distance_calcs",
                "index_size_bytes", "try_increasing_num_shards")


def same_routes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ROUTE_FIELDS:
            assert getattr(g, f) == getattr(w, f), f
        assert g.routing_time > 0 or g.routing_algorithm == "Random"
        np.testing.assert_array_equal(g.buckets_to_probe, w.buckets_to_probe)


def test_routing_sweep_matches(setup):
    pts, q, _, _, clusters = setup
    kw = dict(budgets=[300, 800], voting_neighbors=(20, 40, 80),
              timing_reps=1)
    want = jsweep.iterate_routing_configs(pts, q, clusters, **kw)
    got = tsweep.iterate_routing_configs(pts, q, clusters, device="cpu", **kw)
    assert {r.routing_algorithm for r in got} == {
        "min_dist", "frequency", "pyramid", "spann", "Random"}
    same_routes(got, want)


def test_routing_sweep_side_indices_match(setup, tmp_path):
    """The Pyramid/OurPyramid side indices (routes.cpp:287-311), loaded
    from the JAX package's ``.npz`` file."""
    pts, q, _, _, clusters = setup
    jflat.centroid_router(pts, clusters).save(str(tmp_path / "side"))
    path = str(tmp_path / "side.npz")
    kw = dict(budgets=[300], voting_neighbors=(4,), timing_reps=1,
              include_random=False)
    want = jsweep.iterate_routing_configs(
        pts, q, clusters, pyramid_index=jflat.FlatRouter.load(path),
        our_pyramid_index=jflat.FlatRouter.load(path), **kw)
    side = tflat.FlatRouter.load(path, device="cpu")
    got = tsweep.iterate_routing_configs(
        pts, q, clusters, pyramid_index=side, our_pyramid_index=side,
        device="cpu", **kw)
    assert {"Pyramid", "OurPyramid+KNN"} <= {r.index_trainer for r in got}
    same_routes(got, want)


@pytest.mark.parametrize("n", [10, 20_000, 150_000, 8_000_000, 50_000_000])
def test_default_budgets_match(n):
    assert tsweep.default_budgets(n) == jsweep.default_budgets(n)


def test_time_fn_median_and_result():
    calls = []
    t, out = ttimer.time_fn(lambda x: calls.append(x) or x * 2, 21, reps=3,
                            warmup=2, device="cpu")
    assert out == 42 and len(calls) == 5 and t >= 0.0


def test_time_fn_reraises():
    """An error of the timed function propagates (the JAX ``_block``
    swallows every exception; the port's barrier does not)."""
    def boom():
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        ttimer.time_fn(boom, device="cpu")
    with pytest.raises(ValueError, match="boom"):
        ttimer.time_fn(boom, warmup=0, reps=1, device="cpu")


def test_timer_states():
    t = ttimer.Timer()
    with pytest.raises(RuntimeError):
        t.stop()
    t.start()
    with pytest.raises(RuntimeError):
        t.start()
    a = t.restart()
    b = t.stop()
    assert t.elapsed == pytest.approx(a + b) and a >= 0 and b >= 0


def test_profiling_counters_match():
    st = tprof.StageTimer()
    for name in ("b", "a", "b"):
        with st.stage(name):
            pass
    assert st.counts == {"a": 1, "b": 2}
    lines = st.report().split("\n")
    assert [line.split(":")[0] for line in lines] == ["a", "b"]
    assert lines[1].endswith("over 2 calls")
