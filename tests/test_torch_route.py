"""Parity of the port's routers (``route/flat.py``, ``route/kmeans_tree.py``)
with the JAX package, and the build slice as a whole.

Routers trained by both packages from the same seeds extract the same
number of points, which agree at rtol = atol = 1e-4; a JAX-trained router
carried across with ``KMeansTreeRouter.from_arrays`` answers every query
kind with identical probe orders. The slice test builds ground truth, a GP
partition and a router with each package on the CPU, serves nprobes=1 with
each package's engine, and holds the two recalls within 0.02.
"""

import numpy as np
import pytest
import torch

from gpann_tpu.eval import compute_ground_truth as j_gt
from gpann_tpu.eval import kth_neighbor_distance, recall_from_ids
from gpann_tpu.gp import api as japi
from gpann_tpu.route import flat as jflat
from gpann_tpu.route import kmeans_tree as jtree
from gpann_tpu.search.serve import ServingEngine as JaxEngine
from gpann_tpu_torch.eval import recall as tr
from gpann_tpu_torch.gp import api as tapi
from gpann_tpu_torch.route import flat as tflat
from gpann_tpu_torch.route import kmeans_tree as ttree
from gpann_tpu_torch.search.serve import ServingEngine

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


def blobs(n, kb=8, d=16, seed=555, spread=0.5, scale=4.0, nq=64):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((kb, d)).astype(np.float32) * scale
    lbl = rng.integers(0, kb, size=n)
    pts = (centers[lbl] + spread * rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, kb, size=nq)]
         + spread * rng.standard_normal((nq, d))).astype(np.float32)
    return pts, q


@pytest.fixture(scope="module")
def trained():
    """Both packages' k-means-tree routers over the same 6-shard clustering."""
    pts, q = blobs(6000)
    part = np.random.default_rng(1).integers(0, 6, len(pts))
    part[np.argsort(pts[:, 0])[:2000]] = 5  # one large shard: deeper tree
    clusters = [np.nonzero(part == s)[0] for s in range(6)]
    opts = jtree.KMeansTreeRouterOptions(num_centroids=8, min_cluster_size=40,
                                         budget=300, search_budget=120)
    jr = jtree.KMeansTreeRouter().train(pts, clusters, opts, seed=7)
    tr_ = ttree.KMeansTreeRouter(device="cpu").train(
        pts, clusters, ttree.KMeansTreeRouterOptions(**vars(opts)), seed=7)
    return pts, q, clusters, jr, tr_


def test_fold_votes_and_rank_rules_match():
    rng = np.random.default_rng(2)
    d = rng.random((40, 12)).astype(np.float32)
    s = rng.integers(0, 7, (40, 12)).astype(np.int32)
    gm, gf = tflat._fold_votes(torch.from_numpy(d), torch.from_numpy(s), 7)
    wm, wf = jflat._fold_votes(d, s, 7)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    md, fr = np.asarray(wm), np.asarray(wf)
    for name in ("rank_min_dist", "rank_pyramid"):
        np.testing.assert_array_equal(getattr(tflat, name)(md),
                                      getattr(jflat, name)(md))
    np.testing.assert_array_equal(tflat.rank_spann(md, 0.3),
                                  jflat.rank_spann(md, 0.3))
    np.testing.assert_array_equal(tflat.rank_frequency(fr, md),
                                  jflat.rank_frequency(fr, md))


@pytest.mark.parametrize("rule", ["min_dist", "pyramid", "spann", "frequency"])
def test_flat_router_query_matches(trained, rule):
    pts, q, clusters, jr, _ = trained
    rp, rl = jr.extract_points()
    want = jflat.FlatRouter(rp, rl, 6).query(q, 20, rule=rule)
    got = tflat.FlatRouter(rp, rl, 6, device="cpu").query(q, 20, rule=rule)
    np.testing.assert_array_equal(got, want)


def test_flat_router_files_cross_load(trained, tmp_path):
    pts, q, clusters, jr, _ = trained
    rp, rl = jr.extract_points()
    jflat.FlatRouter(rp, rl, 6).save(str(tmp_path / "j"))
    tflat.FlatRouter(rp, rl, 6, device="cpu").save(str(tmp_path / "t"))
    port = tflat.FlatRouter.load(str(tmp_path / "j"), device="cpu")
    ref = jflat.FlatRouter.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(port.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(port.labels_np, ref.labels_np)
    assert (port.num_shards, port.metric) == (ref.num_shards, ref.metric)
    np.testing.assert_array_equal(port.query(q, 20), ref.query(q, 20))
    for key in ("points", "labels", "num_shards", "metric"):
        a = np.load(str(tmp_path / "j.npz"))[key]
        b = np.load(str(tmp_path / "t.npz"))[key]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_centroid_router_matches(trained):
    pts, q, clusters, _, _ = trained
    want = jflat.centroid_router(pts, clusters)
    got = tflat.centroid_router(pts, clusters, device="cpu")
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), **TOL)
    np.testing.assert_array_equal(got.query(q, 6), want.query(q, 6))


def test_tree_router_train_matches(trained):
    _, _, _, jr, tr_ = trained
    assert len(tr_.points) == len(jr.points) > 6 * 8
    np.testing.assert_allclose(tr_.points, jr.points, **TOL)
    np.testing.assert_array_equal(tr_.labels, jr.labels)
    np.testing.assert_array_equal(tr_.group_of, jr.group_of)
    np.testing.assert_array_equal(tr_.top_index, jr.top_index)


@pytest.mark.parametrize("budget", [60, 120, 100_000])
def test_tree_router_from_arrays_answers_identically(trained, budget):
    pts, q, _, jr, _ = trained
    port = ttree.KMeansTreeRouter.from_arrays(
        jr.points, jr.labels, jr.group_of, jr.top_index, jr.num_shards,
        search_budget=jr.search_budget, device="cpu")
    np.testing.assert_array_equal(port.query(q), jr.query(q))
    np.testing.assert_array_equal(port.frequency_query(q, 30),
                                  jr.frequency_query(q, 30))
    np.testing.assert_array_equal(port.query_budgeted(q, budget),
                                  jr.query_budgeted(q, budget))
    np.testing.assert_array_equal(port.frequency_query_budgeted(q, 30, budget),
                                  jr.frequency_query_budgeted(q, 30, budget))
    gm, gf, gc = port.budgeted_votes(q, budget)
    wm, wf, wc = jr.budgeted_votes(q, budget)
    np.testing.assert_allclose(gm, wm, **TOL)
    np.testing.assert_array_equal(gf, wf)
    assert gc == wc


def test_build_slice_recall_matches():
    """GT -> GP -> k-means-tree router -> serve at nprobes=1, each package on
    its own build of 20k x 16 points in 4 shards; recall@10 within 0.02."""
    pts, q = blobs(20_000, kb=10, spread=0.8, nq=128)
    opts = dict(num_centroids=16, budget=600)
    gt_j, gtd_j = j_gt(pts, q, 10)
    gp_j = japi.partition(pts, 4, "GP")
    router_j = jtree.KMeansTreeRouter().train(
        pts, gp_j, jtree.KMeansTreeRouterOptions(**opts))
    eng_j = JaxEngine(pts, gp_j, *router_j.extract_points(), pad_multiple=128)
    _, ids_j = eng_j.serve(q, 10, 1, voting_t=16, query_block=64)
    rec_j = recall_from_ids(pts, q, ids_j, kth_neighbor_distance(gtd_j, 10), 10)

    gt_t, gtd_t = tr.compute_ground_truth(pts, q, 10, device="cpu")
    gp_t = tapi.partition(pts, 4, "GP", device="cpu")
    router_t = ttree.KMeansTreeRouter(device="cpu").train(
        pts, gp_t, ttree.KMeansTreeRouterOptions(**opts))
    eng_t = ServingEngine(pts, gp_t, *router_t.extract_points(),
                          pad_multiple=128, device="cpu")
    _, ids_t = eng_t.serve(q, 10, 1, voting_t=16, query_block=64)
    rec_t = tr.recall_from_ids(pts, q, ids_t, tr.kth_neighbor_distance(gtd_t, 10),
                               10)

    np.testing.assert_allclose(gtd_t, gtd_j, **TOL)
    assert max(len(c) for c in gp_t) <= int(1.05 * np.ceil(20_000 / 4))
    assert abs(rec_t - rec_j) <= 0.02, (rec_t, rec_j)
    assert rec_t > 0.5
