"""Parity of the port's serving engine with the JAX ``ServingEngine``.

Both engines compute on identical arrays: the JAX engine is built first and
its state is carried across with ``ServingEngine.from_state``. The JAX side
runs the Pallas kernels in interpret mode; the port runs on CPU tensors,
which take the plain PyTorch scan. Distances are compared at rtol = atol =
1e-4 (f32 sums in different orders), recall values exactly.
"""

import numpy as np
import pytest
import torch

from gpann_tpu.cluster import balanced_kmeans
from gpann_tpu.core.partition import partition_to_clusters
from gpann_tpu.eval import compute_ground_truth, kth_neighbor_distance, recall_from_ids
from gpann_tpu.route import centroid_router
from gpann_tpu.search.serve import ServingEngine as JaxEngine
from gpann_tpu_torch.core import profiling
from gpann_tpu_torch.search import exact
from gpann_tpu_torch.search.serve import ServingEngine, _group, _probe_rank

TOL = dict(rtol=1e-4, atol=1e-4)
ARRAYS = ("shard_points", "shard_sizes_ext", "shard_ids", "router_points",
          "router_labels", "router_sq")
CONFIG = ("num_shards", "capacity", "dim", "dim_pad", "max_size", "overlapping",
          "router_n_valid", "metric", "scan_mode", "voting_impl", "scan_phase2",
          "scan_nc")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda:0")


def port(jeng, device="cpu", **config_changes):
    """The port's engine on the JAX engine's state."""
    arrays = {name: np.asarray(getattr(jeng, name)) for name in ARRAYS}
    config = {name: getattr(jeng, name) for name in CONFIG}
    return ServingEngine.from_state(arrays, {**config, **config_changes},
                                    device=device)


def routing_sample(pts, clusters, size, seed):
    rng = np.random.default_rng(seed)
    sample = rng.choice(len(pts), size=size, replace=False)
    point_shard = np.empty(len(pts), np.int32)
    for b, c in enumerate(clusters):
        point_shard[c] = b
    return pts[sample], point_shard[sample]


@pytest.fixture(scope="module")
def setup():
    """The tests/test_serve.py setup: 4000 x 16, 8 balanced k-means shards."""
    rng = np.random.default_rng(555)
    kb, d, n, nq = 8, 16, 4000, 64
    centers = rng.standard_normal((kb, d)).astype(np.float32) * 4
    lbl = rng.integers(0, kb, size=n)
    pts = (centers[lbl] + 0.4 * rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, kb, size=nq)]
         + 0.4 * rng.standard_normal((nq, d))).astype(np.float32)
    gt_ids, gt_dists = compute_ground_truth(pts, q, 10)
    _, assign = balanced_kmeans(pts, k=8, eps=0.3, seed=1)
    clusters = partition_to_clusters(assign, 8)
    router = centroid_router(pts, clusters)
    jeng = JaxEngine(pts, clusters, np.asarray(router.points), router.labels_np,
                     pad_multiple=128)
    return pts, q, kth_neighbor_distance(gt_dists, 10), clusters, router, jeng


@pytest.fixture(scope="module")
def slice_case():
    """The slice as a whole: 40k x 16, 3 shards, binned scan (interpret)."""
    rng = np.random.default_rng(11)
    pts = rng.standard_normal((40_000, 16)).astype(np.float32)
    q = rng.standard_normal((32, 16)).astype(np.float32)
    clusters = partition_to_clusters(rng.integers(0, 3, size=len(pts)), 3)
    rpts, rlbl = routing_sample(pts, clusters, 600, 12)
    kth = kth_neighbor_distance(compute_ground_truth(pts, q, 10)[1], 10)
    jeng = JaxEngine(pts, clusters, rpts, rlbl, scan_mode="binned",
                     interpret=True)
    return pts, q, kth, clusters, rpts, rlbl, jeng


def test_slice_binned_serve_matches_jax(slice_case):
    pts, q, kth, clusters, rpts, rlbl, jeng = slice_case
    teng = port(jeng)
    assert teng.capacity == jeng.capacity and teng.dim == 16
    assert teng.shard_points.shape == (3 * jeng.capacity, 16)  # 128-dim pad dropped
    for nprobes in (2, 3):
        jd, ji = jeng.serve(q, k=10, nprobes=nprobes, voting_t=8,
                            query_block=16)
        td, ti = teng.serve(q, k=10, nprobes=nprobes, voting_t=8,
                            query_block=16)
        assert ti.dtype == np.int32 and td.shape == (len(q), 10)
        np.testing.assert_allclose(td, jd, **TOL)
        rec_t = recall_from_ids(pts, q, ti, kth, 10)
        assert rec_t == recall_from_ids(pts, q, ji, kth, 10)
    assert rec_t > 0.97  # every shard probed: only bin collisions lose
    # the port's own constructor (no TPU padding) serves the same results
    own = ServingEngine(pts, clusters, rpts, rlbl, scan_mode="binned",
                        device="cpu")
    assert own.capacity % 128 == 0 and own.capacity < jeng.capacity
    od, oi = own.serve(q, k=10, nprobes=3, voting_t=8, query_block=16)
    np.testing.assert_allclose(od, td, **TOL)


def test_slice_binned_recall_curve_matches_jax(slice_case):
    pts, q, kth, clusters, rpts, rlbl, jeng = slice_case
    want = jeng.recall_curve(q, 10, kth, voting_t=8, query_block=16)
    got = port(jeng).recall_curve(q, 10, kth, voting_t=8, query_block=16)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_slice_binned_voting_matches_jax(slice_case):
    """voting_impl="binned" routes through fused_topk (kernel B2's path)."""
    pts, q, kth, clusters, rpts, rlbl, _ = slice_case
    rpts2, rlbl2 = routing_sample(pts, clusters, 2048, 13)
    jeng = JaxEngine(pts, clusters, rpts2, rlbl2, voting_impl="binned",
                     scan_mode="binned", interpret=True)
    assert jeng.router_points.shape[0] == 16384  # the TPU's row padding
    teng = port(jeng)
    assert teng.router_points.shape[0] == 2048
    for rule in ("min_dist", "frequency"):
        want = jeng.probe_order(q, 3, voting_t=8, rule=rule)
        got = teng.probe_order(q, 3, voting_t=8, rule=rule)
        np.testing.assert_array_equal(got, want)
    jd, _ = jeng.serve(q, k=10, nprobes=1, voting_t=8, query_block=16)
    td, _ = teng.serve(q, k=10, nprobes=1, voting_t=8, query_block=16)
    np.testing.assert_allclose(td, jd, **TOL)


@pytest.mark.parametrize("rule", ["min_dist", "pyramid", "spann", "frequency"])
@pytest.mark.parametrize("voting_impl", ["exact", "approx", "rescore"])
def test_probe_order_matches_jax(setup, rule, voting_impl):
    pts, q, kth, clusters, router, _ = setup
    rpts, rlbl = routing_sample(pts, clusters, 256, 7)
    jeng = JaxEngine(pts, clusters, rpts, rlbl, pad_multiple=128,
                     voting_impl=voting_impl)
    got = port(jeng).probe_order(q, nprobes=8, voting_t=16, rule=rule)
    want = jeng.probe_order(q, nprobes=8, voting_t=16, rule=rule)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rule", ["min_dist", "pyramid", "spann", "frequency"])
def test_exact_scan_serve_matches_jax(setup, rule):
    pts, q, kth, clusters, router, jeng = setup
    teng = port(jeng)
    jd, ji = jeng.serve(q, k=10, nprobes=3, voting_t=8, rule=rule,
                        query_block=32)
    td, ti = teng.serve(q, k=10, nprobes=3, voting_t=8, rule=rule,
                        query_block=32)
    np.testing.assert_allclose(td, jd, **TOL)
    assert (recall_from_ids(pts, q, ti, kth, 10)
            == recall_from_ids(pts, q, ji, kth, 10))


def test_recall_curve_matches_jax(setup):
    pts, q, kth, clusters, router, jeng = setup
    want = jeng.recall_curve(q, 10, kth, voting_t=8, query_block=32)
    got = port(jeng).recall_curve(q, 10, kth, voting_t=8, query_block=32)
    assert got.shape == (8,)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_serve_scan_matches_serve(setup):
    pts, q, kth, clusters, router, jeng = setup
    teng = port(jeng)
    batches = np.stack([q, np.roll(q, 7, axis=0)])
    sd, si = teng.serve_scan(batches, k=10, nprobes=3, voting_t=8,
                             query_block=32)
    assert sd.shape == (2, len(q), 10)
    for r in range(2):
        fd, fi = teng.serve(batches[r], k=10, nprobes=3, voting_t=8,
                            query_block=32)
        np.testing.assert_array_equal(sd[r].numpy(), fd)
        np.testing.assert_array_equal(si[r].numpy(), fi)


def test_own_constructor_matches_jax_state(setup):
    pts, q, kth, clusters, router, jeng = setup
    own = ServingEngine(pts, clusters, np.asarray(router.points),
                        router.labels_np, pad_multiple=128, device="cpu")
    np.testing.assert_array_equal(own.shard_points.numpy(),
                                  np.asarray(jeng.shard_points))
    np.testing.assert_array_equal(own.shard_ids.numpy(),
                                  np.asarray(jeng.shard_ids))
    np.testing.assert_array_equal(own.router_sq.numpy(),
                                  np.asarray(jeng.router_sq))
    assert own.overlapping is False


def test_binned_tiny_shards_take_exact_scan(setup):
    """Shards too small to fill k candidates from their bins take the exact
    scan, in the port as in the JAX package."""
    pts, q, kth, clusters, router, jeng = setup
    rp, rl = np.asarray(router.points), router.labels_np
    binned = ServingEngine(pts, clusters, rp, rl, pad_multiple=128,
                           scan_mode="binned", device="cpu")
    assert not binned._binned(10)
    _, fi = binned.serve(q[:16], k=10, nprobes=8, voting_t=8, query_block=16)
    assert recall_from_ids(pts, q[:16], fi, kth[:16], 10) == 1.0


@pytest.mark.parametrize("metric", ["l2", "mips"])
@pytest.mark.parametrize("blocks_a_step", [1, 3])
def test_exact_scan_in_tile_steps_matches_one_step(monkeypatch, metric,
                                                   blocks_a_step):
    """The exact scan mode gives the same lists, bit for bit, whether its
    blocks go through in one step or in many under a small ``TILE_BYTES``;
    overlapping shards, a shard smaller than k and probes cut short to the
    dummy shard (``pyramid`` with one vote) included. Where a query meets
    fewer than k rows, the tail of its list is (+inf, -1)."""
    rng = np.random.default_rng(5)
    d = 8
    pts = rng.standard_normal((1000, d)).astype(np.float32)
    pts[:5] += 10.0                                  # the tiny shard, far off
    clusters = [np.arange(0, 5), np.arange(5, 600), np.arange(400, 1000)]
    rp = np.stack([pts[c].mean(0) for c in clusters]).astype(np.float32)
    q = np.concatenate([pts[:4] + 0.1 * rng.standard_normal((4, d)),
                        rng.standard_normal((44, d))]).astype(np.float32)
    eng = ServingEngine(pts, clusters, rp, np.arange(3, dtype=np.int32),
                        metric=metric, pad_multiple=128, device="cpu")
    assert eng.overlapping and not eng._binned(10)
    qb = 16
    for nprobes, rule, voting_t in ((1, "min_dist", 3), (2, "min_dist", 3),
                                    (2, "pyramid", 1)):
        args = dict(k=10, nprobes=nprobes, voting_t=voting_t, rule=rule,
                    query_block=qb)
        nb = -(-len(q) * nprobes // qb) + eng.num_shards + 1
        assert exact.blocks_per_step(eng.capacity, qb, d) >= nb  # one step
        one = eng.serve(q, **args)
        with monkeypatch.context() as mp:
            mp.setattr(exact, "TILE_BYTES",
                       4 * eng.capacity * (qb + d) * blocks_a_step)
            assert exact.blocks_per_step(eng.capacity, qb, d) == blocks_a_step
            many = eng.serve(q, **args)
        np.testing.assert_array_equal(many[0], one[0])
        np.testing.assert_array_equal(many[1], one[1])
        np.testing.assert_array_equal(one[1] < 0, np.isinf(one[0]))
        for row in one[1]:
            row = row[row >= 0]
            assert len(np.unique(row)) == len(row)
        if nprobes == 1 or rule == "pyramid":
            # the queries by the tiny shard meet its 5 rows only
            assert np.isfinite(one[0][:4, :5]).all()
            assert (one[1][:4, 5:] == -1).all()


def test_overlapping_dedup_matches_jax():
    rng = np.random.default_rng(21)
    pts = rng.standard_normal((1000, 8)).astype(np.float32)
    q = rng.standard_normal((16, 8)).astype(np.float32)
    base = [np.arange(0, 600, dtype=np.int32),
            np.arange(400, 1000, dtype=np.int32)]
    router = centroid_router(pts, base)
    jeng = JaxEngine(pts, base, np.asarray(router.points), router.labels_np,
                     pad_multiple=128)
    teng = port(jeng)
    assert teng.overlapping
    td, ti = teng.serve(q, k=10, nprobes=2, voting_t=2, query_block=16)
    for row in ti:
        row = row[row >= 0]
        assert len(np.unique(row)) == len(row)  # no duplicate ids returned
    jd, _ = jeng.serve(q, k=10, nprobes=2, voting_t=2, query_block=16)
    np.testing.assert_allclose(td, jd, **TOL)


def test_mips_binned_serve_matches_jax(slice_case):
    pts, q, kth, clusters, rpts, rlbl, _ = slice_case
    jeng = JaxEngine(pts, clusters, rpts, rlbl, metric="mips",
                     scan_mode="binned", interpret=True)
    jd, _ = jeng.serve(q, k=10, nprobes=1, voting_t=8, query_block=16)
    td, _ = port(jeng).serve(q, k=10, nprobes=1, voting_t=8, query_block=16)
    np.testing.assert_allclose(td, jd, **TOL)


def test_engine_rejects_unknown_options(setup):
    pts, q, kth, clusters, router, jeng = setup
    with pytest.raises(ValueError):
        ServingEngine(pts, clusters, np.asarray(router.points),
                      router.labels_np, scan_mode="dense", device="cpu")
    teng = port(jeng)
    with pytest.raises(ValueError):
        teng.probe_order(q, 2, rule="nearest")


def test_engine_device_is_required(setup):
    """No engine comes up on the CPU by default: ``device`` has to be named,
    for the constructor and for ``from_state`` alike."""
    pts, q, kth, clusters, router, jeng = setup
    args = (pts, clusters, np.asarray(router.points), router.labels_np)
    with pytest.raises(TypeError, match="device"):
        ServingEngine(*args)
    with pytest.raises(TypeError):          # keyword only
        ServingEngine(*args, "l2", 128, "exact", "exact", "exact", 0, "cpu")
    arrays = {name: np.asarray(getattr(jeng, name)) for name in ARRAYS}
    config = {name: getattr(jeng, name) for name in CONFIG}
    with pytest.raises(TypeError, match="device"):
        ServingEngine.from_state(arrays, config)
    assert ServingEngine(*args, device="cpu").device.type == "cpu"


@pytest.mark.gpu
def test_binned_engine_on_gpu_matches_cpu(cuda_device, slice_case):
    from gpann_tpu_torch import kernels

    pts, q, kth, clusters, rpts, rlbl, jeng = slice_case
    cpu = port(jeng)
    gpu = port(jeng, device=cuda_device)
    kernels.reset_launches()
    gd, gi = gpu.serve(q, k=10, nprobes=3, voting_t=8, query_block=16)
    assert kernels.LAUNCHES["bintop2_blocks"] == 1
    cd, _ = cpu.serve(q, k=10, nprobes=3, voting_t=8, query_block=16)
    np.testing.assert_allclose(gd, cd, **TOL)
    assert recall_from_ids(pts, q, gi, kth, 10) > 0.97


@pytest.mark.gpu
@pytest.mark.parametrize("scan_mode", ["binned", "exact"])
@pytest.mark.parametrize("rule", ["min_dist", "pyramid", "spann", "frequency"])
@pytest.mark.parametrize("voting_impl", ["exact", "approx", "rescore", "binned"])
def test_binned_engine_enqueues_a_batch_without_a_host_wait(
        cuda_device, slice_case, rule, voting_impl, scan_mode):
    """Routing, grouping, the scan (binned or exact) and the merge neither
    read a device value back nor copy a host value over: the first wait of
    a batch is the read-back of its results. ``serve`` on the card gives
    the CPU's ids."""
    pts, q, kth, clusters, rpts, rlbl, jeng = slice_case
    cpu = port(jeng, voting_impl=voting_impl, scan_mode=scan_mode)
    gpu = port(jeng, device=cuda_device, voting_impl=voting_impl,
               scan_mode=scan_mode)
    args = dict(k=10, nprobes=3, voting_t=8, rule=rule, query_block=16)
    gd, gi = gpu.serve(q, **args)   # the first call builds the kernels
    cd, ci = cpu.serve(q, **args)
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_allclose(gd, cd, **TOL)
    q_dev = torch.as_tensor(q, device=cuda_device)
    torch.cuda.synchronize(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [gpu.serve_device(q_dev, **args)]
        with profiling.recording(profiling.Recorder()):
            outs.append(gpu.serve_device(q_dev, **args))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for dd, di in outs:
        np.testing.assert_array_equal(dd.cpu().numpy(), gd)
        np.testing.assert_array_equal(di.cpu().numpy(), gi)


def _group_with_bincount(probes: torch.Tensor, s: int, qb: int):
    """``_group`` as it was when it counted the shards with ``bincount``
    (which reads the probes' min and max to the host): the oracle."""
    m, nprobes = probes.shape
    dev = probes.device
    mn = m * nprobes
    flat_b = probes.reshape(-1).long()
    sort = torch.argsort(flat_b, stable=True)
    b_sorted = flat_b[sort]
    q_sorted = sort // nprobes
    slot_sorted = sort % nprobes
    counts = torch.bincount(b_sorted, minlength=s + 1)
    padded = (counts + qb - 1) // qb * qb
    cum_padded = torch.cumsum(padded, 0)
    starts = cum_padded - padded
    first = torch.searchsorted(b_sorted, torch.arange(s + 1, device=dev),
                               right=False)
    rank = torch.arange(mn, device=dev) - first[b_sorted]
    pos = starts[b_sorted] + rank
    total = -(-mn // qb) * qb + (s + 1) * qb
    nb = total // qb
    pair_q = torch.full((total,), m, dtype=torch.int64, device=dev)
    pair_q[pos] = q_sorted
    block_start = torch.arange(nb, device=dev) * qb
    block_shard = torch.searchsorted(cum_padded, block_start, right=True)
    return (pos, q_sorted, slot_sorted, pair_q, block_shard.clamp(max=s))


def _probe_lists(case: str):
    """(probes [m, nprobes] int32, number of shards) lists of one kind."""
    g = torch.Generator().manual_seed(19)
    if case == "every_shard":      # m * nprobes a multiple of 128 and 1024
        return [(torch.randint(0, 8, (512, 2), generator=g), 8)]
    if case == "dummy_shard":      # slots cut short point at shard s
        p = torch.randint(0, 9, (300, 3), generator=g)
        return [(p, 8)]
    if case == "empty_shards":     # the first, last and odd shards unseen
        p = 2 * torch.randint(1, 7, (256, 4), generator=g)
        return [(p, 16), (torch.full((64, 1), 3), 8)]
    if case == "ragged":           # m * nprobes no multiple of qb
        return [(torch.randint(0, 5, (37, 3), generator=g), 5),
                (torch.randint(0, 40, (1, 1), generator=g), 40)]
    if case == "rule_cut":         # a rule's probe lists, cut short
        q = torch.randn(200, 8, generator=g)
        rp = torch.randn(64, 8, generator=g)
        labels = torch.randint(0, 6, (64,), generator=g)
        out = []
        for rule in ("spann", "pyramid"):
            p = _probe_rank(q, rp, labels, (rp ** 2).sum(1), s=6, voting_t=4,
                            rule=rule, spann_eps=0.1, nprobes=5, metric="l2",
                            voting_impl="exact")
            assert (p == 6).any()
            out.append((p, 6))
        return out
    # random lists of every shape and shard count, dummy and empty shards too
    out = []
    for _ in range(300):
        s = int(torch.randint(1, 40, (), generator=g))
        m = int(torch.randint(1, 300, (), generator=g))
        nprobes = int(torch.randint(1, min(s, 6) + 1, (), generator=g))
        hi = int(torch.randint(1, s + 2, (), generator=g))
        out.append((torch.randint(0, hi, (m, nprobes), generator=g), s))
    return out


@pytest.mark.parametrize("case", ["every_shard", "dummy_shard", "empty_shards",
                                  "ragged", "rule_cut", "random"])
@pytest.mark.parametrize("qb", [128, 1024])
def test_group_matches_the_bincount_grouping(case, qb):
    """Shard counts taken from the sorted probe list give every field of the
    grouping bit for bit as ``bincount`` gave it."""
    for probes, s in _probe_lists(case):
        probes = probes.to(torch.int32)
        got = _group(probes, s, qb)
        want = _group_with_bincount(probes, s, qb)
        for name, a, b in zip(got._fields, got, want):
            assert a.dtype == b.dtype, name
            assert torch.equal(a, b), name
