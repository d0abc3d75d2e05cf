"""The MIPS configuration as a whole (``exp_scripts/mips_overlap_8m.py``): the
port against the JAX package on the CPU.

Both packages run the script's pipeline at a small size on the same seeded
inputs: the ``hard`` mixture, ground truth under MIPS, a subsample-GP
partition, a k-means-tree router, a centroid-ranked overlap (cheapest-first
admission under a capacity), and two serving engines, ``gp`` on the
partition and ``gp_overlap`` on the cover, each with the binned scan and
with the exact one. The JAX engines run their Pallas kernel in interpret
mode; the port runs on CPU tensors, which take the plain PyTorch scan.

Held: ground-truth ids, the partition and the extra assignments identical;
the gp arm's binned curve and both arms' exact curves within 1e-6 of the
JAX package's; the port's overlap arm, binned, at or above the JAX
package's. The port lays each cover shard out in id order, where the JAX
package keeps the cover's order (members, then the extra points cheapest
first): the extras then share the binned scan's 128-row bins and the JAX
package's overlap arm loses recall to its row order. And the script's
checks: curves non-decreasing, each routed curve at or below its oracle
curve, the overlap arm at or above the gp arm, the binned scan within 0.005
of the exact scan at every prefix.
"""

import numpy as np
import pytest
import torch

N, D, NQ, SHARDS, K = 40_000, 16, 128, 4, 10
SEED = 555
EPS = 0.05
SUBSAMPLE, AGGREGATES = 20_000, 512
ROUTER_CENTROIDS, ROUTER_BUDGET = 32, 4000
OVERLAP, KEEP = 0.2, 3
VOTING_T, RULE, QB = 60, "min_dist", 128
CURVE_ATOL = 1e-6
ORACLE_SLACK = 1e-3     # a routed curve may not pass its oracle curve
ARM_SLACK = 0.002       # overlap arm >= gp arm - this, at every prefix
BINNED_SLACK = 0.005    # binned curve >= exact curve - this, at every prefix
# kernel vs plain on the card: the chip run's tolerance (chip_smoke.py), with
# atol 1e-6 of the largest |q|^2 + |x|^2 (~8 ulp of the terms both carry)
RTOL, ATOL = 1e-4, 1e-3


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
def data():
    from gpann_tpu.eval.synth import generate, generate_queries

    return generate("hard", N, D, SEED), generate_queries("hard", NQ, D, SEED)


def _router_sample(n: int) -> np.ndarray:
    rng = np.random.default_rng(SEED + 1)
    return np.sort(rng.choice(n, size=min(2_000_000, n // 2), replace=False))


def _arms(engine_cls, pts, q, kth, clusters, cover, rp, rl, **kw) -> dict:
    """Each arm's recall curve with the binned and with the exact scan."""
    out = {}
    for name, cl in (("gp", clusters), ("gp_overlap", cover)):
        for scan_mode in ("binned", "exact"):
            engine = engine_cls(pts, cl, rp, rl, metric="mips",
                                scan_mode=scan_mode, voting_impl="exact", **kw)
            out[name, scan_mode] = np.asarray(engine.recall_curve(
                q, K, kth, voting_t=VOTING_T, rule=RULE, query_block=QB))
    return out


@pytest.fixture(scope="module")
def jax_run(data):
    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.eval.recall import compute_ground_truth, kth_neighbor_distance
    from gpann_tpu.gp.overlap import (apply_extra_assignments,
                                      centroid_overlap_streamed)
    from gpann_tpu.gp.scale import subsample_gp_partition
    from gpann_tpu.route import KMeansTreeRouter, KMeansTreeRouterOptions
    from gpann_tpu.search.serve import ServingEngine

    pts, q = data
    gt_ids, gt_dists = compute_ground_truth(pts, q, K, metric="mips")
    assign, (aggs, agg_lbl, _, _) = subsample_gp_partition(
        pts, k=SHARDS, eps=EPS, seed=SEED, metric="mips",
        num_subsample=SUBSAMPLE, num_aggregate=AGGREGATES,
        return_artifacts=True)
    clusters = partition_to_clusters(assign, SHARDS)
    sub = _router_sample(N)
    rp, rl = KMeansTreeRouter(metric="mips").train(
        pts[sub], partition_to_clusters(assign[sub], SHARDS),
        KMeansTreeRouterOptions(num_centroids=ROUTER_CENTROIDS,
                                budget=ROUTER_BUDGET), seed=SEED
    ).extract_points()
    cap2 = int((1.0 + EPS) * (1.0 + OVERLAP) * N / SHARDS)
    ep, ec = centroid_overlap_streamed(
        pts, assign, np.asarray(aggs), np.asarray(agg_lbl), SHARDS, cap2,
        int(OVERLAP * N), keep=KEEP, metric="mips")
    cover = apply_extra_assignments(clusters, ep, ec)
    kth = kth_neighbor_distance(gt_dists, K)
    curves = _arms(ServingEngine, pts, q, kth, clusters, cover,
                   np.asarray(rp), np.asarray(rl), interpret=True)
    return dict(gt_ids=np.asarray(gt_ids), assign=np.asarray(assign),
                extra=(np.asarray(ep), np.asarray(ec)), rp=np.asarray(rp),
                rl=np.asarray(rl), curves=curves)


@pytest.fixture(scope="module")
def port_run(data):
    from gpann_tpu_torch.core.partition import (clusters_to_cover,
                                                partition_to_clusters)
    from gpann_tpu_torch.eval.recall import (compute_ground_truth,
                                             kth_neighbor_distance,
                                             oracle_recall)
    from gpann_tpu_torch.gp.overlap import (apply_extra_assignments,
                                            centroid_overlap_streamed)
    from gpann_tpu_torch.gp.scale import subsample_gp_partition
    from gpann_tpu_torch.route import KMeansTreeRouter, KMeansTreeRouterOptions
    from gpann_tpu_torch.search.serve import ServingEngine

    pts, q = data
    cpu = dict(device="cpu")
    gt_ids, gt_dists = compute_ground_truth(pts, q, K, metric="mips", **cpu)
    assign, (aggs, agg_lbl, _, _) = subsample_gp_partition(
        pts, k=SHARDS, eps=EPS, seed=SEED, metric="mips",
        num_subsample=SUBSAMPLE, num_aggregate=AGGREGATES,
        return_artifacts=True, **cpu)
    clusters = partition_to_clusters(assign, SHARDS)
    sub = _router_sample(N)
    rp, rl = KMeansTreeRouter(metric="mips", **cpu).train(
        pts[sub], partition_to_clusters(assign[sub], SHARDS),
        KMeansTreeRouterOptions(num_centroids=ROUTER_CENTROIDS,
                                budget=ROUTER_BUDGET), seed=SEED
    ).extract_points()
    cap2 = int((1.0 + EPS) * (1.0 + OVERLAP) * N / SHARDS)
    ep, ec = centroid_overlap_streamed(
        pts, assign, aggs, agg_lbl, SHARDS, cap2, int(OVERLAP * N),
        keep=KEEP, metric="mips", **cpu)
    cover = apply_extra_assignments(clusters, ep, ec)
    kth = kth_neighbor_distance(gt_dists, K)
    curves = _arms(ServingEngine, pts, q, kth, clusters, cover, rp, rl, **cpu)
    oracle = {
        "gp": oracle_recall(gt_ids, partition=assign, num_shards=SHARDS),
        "gp_overlap": oracle_recall(gt_ids, cover=clusters_to_cover(cover, n=N),
                                    num_shards=SHARDS)}
    return dict(gt_ids=gt_ids, assign=assign, extra=(ep, ec), rp=rp, rl=rl,
                cover=cover, cap2=cap2, curves=curves, oracle=oracle)


def test_build_identical_to_jax(jax_run, port_run):
    """Ground truth, partition, router and extra assignments: the same in
    both packages; the partition balanced, the cover within its capacity."""
    np.testing.assert_array_equal(port_run["gt_ids"], jax_run["gt_ids"])
    np.testing.assert_array_equal(port_run["assign"], jax_run["assign"])
    sizes = np.bincount(port_run["assign"], minlength=SHARDS)
    assert sizes.max() <= (1 + EPS) * np.ceil(N / SHARDS)
    np.testing.assert_array_equal(port_run["rl"], jax_run["rl"])
    np.testing.assert_allclose(port_run["rp"], jax_run["rp"], rtol=1e-4,
                               atol=1e-4)
    # the same (point, cluster) admissions; two admitted at a near tie of
    # their f32 distances may trade places in the list
    got, want = (np.stack(run["extra"]).astype(np.int64)
                 for run in (port_run, jax_run))
    np.testing.assert_array_equal(got[:, np.lexsort(got)],
                                  want[:, np.lexsort(want)])
    assert len(port_run["extra"][0]) == int(OVERLAP * N)
    assert max(len(c) for c in port_run["cover"]) <= port_run["cap2"]


@pytest.mark.parametrize("arm,scan_mode", [
    ("gp", "binned"), ("gp", "exact"), ("gp_overlap", "exact")])
def test_curves_match_jax(jax_run, port_run, arm, scan_mode):
    """Where both packages lay out the same rows, the same curves."""
    got = port_run["curves"][arm, scan_mode]
    assert got.shape == (SHARDS,)
    np.testing.assert_allclose(got, jax_run["curves"][arm, scan_mode],
                               atol=CURVE_ATOL)


def test_overlap_arm_binned_at_least_jax(jax_run, port_run):
    """The overlap arm, binned: the port's id-ordered cover shards lose no
    recall the JAX package's cover order keeps."""
    got = port_run["curves"]["gp_overlap", "binned"]
    want = jax_run["curves"]["gp_overlap", "binned"]
    assert (got >= want - CURVE_ATOL).all(), (got, want)


@pytest.mark.parametrize("arm", ["gp", "gp_overlap"])
def test_script_checks(port_run, arm):
    """The checks the chip run makes: (a) the binned curve is
    non-decreasing, (b) the exact curve reaches 1 with every shard probed,
    (c) the routed curves stay at or below the oracle's, (e) the binned
    scan within ``BINNED_SLACK`` of the exact one at every prefix."""
    binned = port_run["curves"][arm, "binned"]
    exact = port_run["curves"][arm, "exact"]
    assert (np.diff(binned) >= 0).all(), binned
    assert exact[-1] >= 0.9999, exact
    for curve in (binned, exact):
        assert (curve <= port_run["oracle"][arm] + ORACLE_SLACK).all(), (
            curve, port_run["oracle"][arm])
    assert (np.abs(binned - exact) <= BINNED_SLACK).all(), (binned, exact)


def test_overlap_arm_at_least_gp_arm(port_run):
    """(d): both arms follow one router's probe order and each cover shard
    holds its partition shard."""
    gp = port_run["curves"]["gp", "binned"]
    ov = port_run["curves"]["gp_overlap", "binned"]
    assert (ov >= gp - ARM_SLACK).all(), (ov, gp)
    for part, shard in zip(np.arange(SHARDS), port_run["cover"]):
        assert np.isin(np.nonzero(port_run["assign"] == part)[0], shard).all()


def test_cover_rows_laid_out_in_id_order(port_run, data):
    """The engine writes each cover shard's rows in ascending id order;
    ``shard_ids`` names every row, so the merge sees the cover's ids."""
    from gpann_tpu_torch.search.serve import ServingEngine

    pts, _ = data
    cover = port_run["cover"]
    assert any((np.diff(c) < 0).any() for c in cover)  # the cover's order
    engine = ServingEngine(pts, cover, port_run["rp"], port_run["rl"],
                           metric="mips", scan_mode="binned", device="cpu")
    assert engine.overlapping
    ids = engine.shard_ids.view(SHARDS, engine.capacity).numpy()
    rows = engine.shard_points.view(SHARDS, engine.capacity, D).numpy()
    for b, c in enumerate(cover):
        np.testing.assert_array_equal(ids[b, : len(c)], np.sort(c))
        assert (ids[b, len(c):] == -1).all()
        np.testing.assert_array_equal(rows[b, : len(c)], pts[np.sort(c)])


# -- the CUDA kernel at MIPS on the hard mixture (skips without a GPU) ----------

@pytest.mark.gpu
def test_kernels_mips_on_hard_data_on_gpu():
    """B2 and B1 under MIPS on ``hard``-generator data (200k x 96, 512
    queries), against their plain versions: minima within ``RTOL`` and an
    atol of 1e-6 of the largest |q|^2 + |x|^2 (at least ``ATOL``), the same
    +inf pattern, and every finite entry's id standing for its minimum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.eval.synth import generate, generate_queries
    from gpann_tpu_torch.search import bin_scan as bs

    dev = torch.device("cuda:0")
    n, d, nq, qb = 200_000, 96, 512, 128
    base = torch.from_numpy(generate("hard", n, d, SEED)).to(dev)
    qs = torch.from_numpy(generate_queries("hard", nq, d, SEED)).to(dev)
    atol = max(ATOL, 1e-6 * float((qs * qs).sum(1).max()
                                  + (base * base).sum(1).max()))

    def check(got, want, queries, row_base):
        (gm, gi), (wm, _) = got, want
        fin = torch.isfinite(wm)
        assert torch.equal(fin, torch.isfinite(gm))
        torch.testing.assert_close(gm[fin], wm[fin], rtol=RTOL, atol=atol)
        rows = base[(gi.long() + row_base[:, None]).clamp(0, n - 1)]
        dist = 1.0 - torch.einsum("md,mcd->mc", queries, rows)
        torch.testing.assert_close(dist[fin], gm[fin], rtol=RTOL, atol=atol)

    before = dict(kernels.LAUNCHES)
    got = bs.binmin_scan(qs, base, n - 77, "mips")
    want = bs.binmin_scan_plain(qs, base, n - 77, "mips")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["binmin_scan"] == before["binmin_scan"] + 1
    check(got, want, qs, torch.zeros(nq, dtype=torch.int64, device=dev))

    # four blocks: windows of different sizes, one empty, out of order
    cap = 40_960
    row_off = torch.tensor([2 * cap, 0, cap, 3 * cap], dtype=torch.int64,
                           device=dev)
    sizes = torch.tensor([cap, 0, 7_001, 33_333], dtype=torch.int32,
                         device=dev)
    qblocks = qs[: 4 * qb].contiguous()
    args = (qblocks, base, row_off, sizes, qb, cap, "mips")
    got = bs.bintop2_blocks(*args)
    want = bs.bintop2_blocks_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bintop2_blocks"] == before["bintop2_blocks"] + 1
    assert torch.isinf(got[0][qb : 2 * qb]).all()
    check(got, want, qblocks, row_off.repeat_interleave(qb))
