"""The port's ``cli.bench`` (counterpart of ``bench.py`` and
``exp_scripts/hard_serve_bench.py``) against the JAX package, and the slice as
a whole (generate -> fused assign + relayout -> ground truth -> router ->
streamed curve) through each package's own modules.

Toy sizes (the ``--n/--d/--nq/--shards`` overrides exist for these tests),
``--device cpu``. Tolerances, per test: the bench's recall curve within 1e-6
of the JAX engine's on the same artifacts (plus the 5-place rounding of its
JSON line); the whole slice's streamed curves within 0.02. The scale bench
and the analysis CLIs are held in ``tests/test_torch_scale_cli.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from gpann_tpu_torch.cli import bench as tbench

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "recall_at_10",
              "nprobes", "num_shards", "brute_force_qps", "per_dispatch_qps",
              "batch", "total_seconds", "config", "voting_impl",
              "scan_phase2", "scan_nc", "voting_t", "query_block",
              "routing_points", "card", "curve"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host, and torch's default of one thread per core
    oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


TOY = ["--n", "20000", "--d", "16", "--nq", "64", "--shards", "4",
       "--device", "cpu"]


@pytest.fixture(scope="module")
def blobs_cache(tmp_path_factory):
    """A cache directory holding the toy blobs config's data and artifacts
    (one cold build for the tests that only need a run to start from)."""
    cache = tmp_path_factory.mktemp("bench_cache")
    out = tbench.run(tbench.parse_args(TOY + ["--cache-dir", str(cache)]))
    assert out["nprobes"] >= 1
    return cache


def run_bench(argv, capsys):
    assert tbench.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1  # ONE JSON line on standard output
    return json.loads(lines[0])


@pytest.mark.parametrize("config", ["blobs", "hard"])
def test_bench_prints_one_json_line(tmp_path, blobs_cache, capsys, config):
    """Cold at a toy size: data, ground truth, GP partition and router are
    built through the port and cached; a second run reuses them."""
    tmp_path = blobs_cache if config == "blobs" else tmp_path
    argv = TOY + ["--config", config, "--cache-dir", str(tmp_path)]
    out = run_bench(argv, capsys)
    assert BENCH_KEYS <= set(out)
    assert out["config"] == config and out["unit"] == "qps"
    assert out["voting_t"] == {"blobs": 32, "hard": 60}[config]
    assert out["query_block"] == 128 and out["batch"] == 64
    assert out["num_shards"] == 4 and len(out["curve"]) == 4
    assert out["card"] == "cpu" and out["approx_is_exact_topk"] is True
    assert (out["voting_impl"], out["scan_phase2"], out["scan_nc"]) == (
        "approx", "approx", 0)
    assert out["metric"].startswith("qps_per_chip@recall0.95_synthetic-")
    # the bin-top-2 scan keeps two candidates a bin, so all probes is not 1.0
    assert out["curve"] == sorted(out["curve"]) and out["curve"][-1] >= 0.99
    assert out["curve"][out["nprobes"] - 1] >= 0.95
    assert out["nprobes"] == 1 or out["curve"][out["nprobes"] - 2] < 0.95
    assert out["recall_at_10"] >= 0.95
    assert out["brute_recall_at_10"] >= 0.999 and out["kernel_parity"] >= 0.95
    assert out["value"] > 0 and out["brute_force_qps"] > 0
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / out["brute_force_qps"], abs=2e-3)  # rounded fields
    files = sorted(os.listdir(tmp_path))
    again = run_bench(argv + ["--voting", "rescore", "--phase2", "exact",
                              "--nc", "32"], capsys)
    assert sorted(os.listdir(tmp_path)) == files  # nothing rebuilt
    assert (again["voting_impl"], again["scan_phase2"], again["scan_nc"]) == (
        "rescore", "exact", 32)
    assert again["routing_points"] == out["routing_points"]
    np.testing.assert_allclose(again["curve"], out["curve"], atol=0.01)


def test_bench_curve_matches_jax_engine_on_shared_artifacts(tmp_path, capsys):
    """The artifacts are made with the JAX package (ground truth, balanced
    k-means partition, sampled routing points) and put in the cache; the
    port's bench must reach the JAX engine's recall curve (Pallas in
    interpret mode) within 1e-6 and choose the same ``nprobes``."""
    from gpann_tpu.cluster.kmeans import balanced_kmeans
    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.eval import compute_ground_truth, kth_neighbor_distance
    from gpann_tpu.eval.synth import dataset_cached, generate_queries
    from gpann_tpu.search.serve import ServingEngine as JaxEngine

    n, d, nq, s = 20000, 16, 64, 4
    pts, _ = dataset_cached("hard", n, d, 555, cache_dir=str(tmp_path))
    q = generate_queries("hard", nq, d, 555)
    gt_ids, gt_dists = compute_ground_truth(pts, q, 10)
    _, assign = balanced_kmeans(np.asarray(pts), k=s, eps=0.05, seed=555)
    sub = np.sort(np.random.default_rng(1).choice(n, 1500, replace=False))
    np.savez(tmp_path / f"hardserve_555_{n}_{d}_{nq}_{s}.npz",
             gt_ids=gt_ids, gt_dists=gt_dists, assign=assign,
             routing_points=np.asarray(pts[sub]), routing_labels=assign[sub])
    jeng = JaxEngine(np.asarray(pts), partition_to_clusters(assign, s),
                     np.asarray(pts[sub]), assign[sub], scan_mode="binned",
                     voting_impl="exact", scan_phase2="exact", interpret=True)
    want = jeng.recall_curve(q, 10, kth_neighbor_distance(gt_dists, 10),
                             voting_t=60, query_block=128)
    out = run_bench(TOY + ["--config", "hard", "--voting", "exact",
                           "--phase2", "exact", "--cache-dir", str(tmp_path)],
                    capsys)
    # the JSON line carries the curve rounded to 5 places
    np.testing.assert_allclose(out["curve"], want, atol=5e-6 + 1e-6)
    ok = np.nonzero(np.asarray(want) >= 0.95)[0]
    assert out["nprobes"] == int(ok[0] + 1)
    assert out["routing_points"] == 1500


def test_bench_raises_when_the_scan_raises(blobs_cache, monkeypatch):
    """No fallback to another scan: a failing kernel ends the run."""
    from gpann_tpu_torch.search import bin_scan

    def broken(*args, **kwargs):
        raise RuntimeError("bintop2 launch failed: CUDA error 700")

    monkeypatch.setattr(bin_scan, "fused_topk", broken)
    with pytest.raises(RuntimeError, match="bintop2 launch failed"):
        tbench.main(TOY + ["--cache-dir", str(blobs_cache)])


def test_bench_raises_on_low_parity(blobs_cache, monkeypatch):
    monkeypatch.setattr(tbench, "PARITY_MIN", 1.01)
    with pytest.raises(RuntimeError, match="parity"):
        tbench.main(TOY + ["--cache-dir", str(blobs_cache)])


def test_bench_defaults_to_the_card(blobs_cache):
    if torch.cuda.is_available():
        pytest.skip("has a CUDA GPU")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tbench.main(["--cache-dir", str(blobs_cache), "--n", "1000"])


def test_bench_hands_its_state_to_the_caller(blobs_cache):
    state = {}
    out = tbench.run(tbench.parse_args(TOY + ["--cache-dir",
                                              str(blobs_cache)]), state)
    assert sorted(state) == ["engine", "kth", "points", "queries"]
    d, ids = state["engine"].serve(state["queries"], 10, out["nprobes"],
                                   voting_t=out["voting_t"])
    assert d.shape == (64, 10) and state["points"].shape == (20000, 16)


# -- the slice as a whole ------------------------------------------------------

def test_whole_slice_streamed_curve_matches_jax(tmp_path):
    """generate -> capacity_assign_to_store -> ground truth -> router ->
    streamed curve, each package through its own modules on the same
    seeded inputs; the two recall curves agree within 0.02."""
    from gpann_tpu.cluster.kmeans import kmeans as jkmeans
    import gpann_tpu.core.distances as jdist
    import gpann_tpu.core.partition as jpart
    import gpann_tpu.eval.synth as jsynth
    import gpann_tpu.route as jroute
    import gpann_tpu.search.relayout as jrel
    import gpann_tpu.search.streamed as jstr
    from gpann_tpu_torch.cluster.kmeans import kmeans as tkmeans
    import gpann_tpu_torch.core.distances as tdist
    import gpann_tpu_torch.core.partition as tpart
    import gpann_tpu_torch.eval.synth as tsynth
    import gpann_tpu_torch.route as troute
    import gpann_tpu_torch.search.relayout as trel
    import gpann_tpu_torch.search.streamed as tstr

    n, d, nq, s, k = 12000, 16, 48, 6, 10
    curves = {}
    for name, (synth, kmeans, dist, part, route, rel, streamed, dev) in {
        "jax": (jsynth, jkmeans, jdist, jpart, jroute, jrel, jstr, {}),
        "torch": (tsynth, tkmeans, tdist, tpart, troute, trel, tstr,
                  {"device": "cpu"}),
    }.items():
        base = synth.VirtualPoints("hard2", n, d, 9, dtype="u8",
                                   chunk_rows=4096)
        q = synth.generate_queries("hard2", nq, d, 9, dtype="u8")
        cents, _ = kmeans(np.asarray(base[:4000], np.float32), k=s, seed=9,
                          **dev)
        out = str(tmp_path / name)
        assert rel.capacity_assign_to_store(base, cents, np.arange(s), s, out,
                                            eps=0.05, chunk_rows=2048, **dev)
        store = rel.ShardMajorStore(out)
        gt_d, _ = dist.streaming_topk_neighbors(q, store.concat_view(), k,
                                                base_chunk=5000, **dev)
        sub_pts, sub_lbl = store.sample(3000, seed=10)
        router = route.KMeansTreeRouter(**dev).train(
            sub_pts, part.partition_to_clusters(sub_lbl, s),
            route.KMeansTreeRouterOptions(num_centroids=8, budget=400), seed=9)
        rp, rl = router.extract_points()
        engine = streamed.StreamedShardEngine(
            None, None, rp, rl, scan_mode="binned", store=store,
            **({"interpret": True} if name == "jax" else dev))
        curves[name], stats = engine.recall_curve(q, k, gt_d[:, -1],
                                                  voting_t=20)
        assert stats["shards_scanned"] == s
        assert store.sizes.max() <= int(1.05 * np.ceil(n / s))
    np.testing.assert_allclose(curves["torch"], curves["jax"], atol=0.02)
    assert curves["torch"][-1] >= 0.99
    assert (np.diff(curves["torch"]) >= 0).all()
