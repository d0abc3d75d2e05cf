"""Parity of the port's shard-major store and streamed engine with the JAX
package's (``gpann_tpu/search/relayout.py``, ``gpann_tpu/search/streamed.py``).

Both packages get the same seeded numpy inputs at the sizes of
``tests/test_relayout.py`` and ``tests/test_streamed.py``. The JAX engine runs
its Pallas scan in interpret mode where it is binned; the port runs on CPU
tensors, which take the plain PyTorch scan. Tolerances, per test: store
files byte-identical (the fused assignment's: the same points in every
shard, the rows of a chunk in id order where the JAX package writes them in
admission order); assignments and probe orders identical; distances at
rtol = atol = 1e-4 (f32 sums in different orders) with ids checked through
the distances they stand for; recall curves within 1e-6.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from gpann_tpu.cluster.kmeans import balanced_kmeans
from gpann_tpu.core.partition import partition_to_clusters
from gpann_tpu.eval.synth import VirtualPoints, generate, generate_queries
from gpann_tpu.search import relayout as jrel
from gpann_tpu.search.streamed import StreamedShardEngine as JaxEngine
from gpann_tpu_torch.cluster.streaming import capacity_stream_assign
from gpann_tpu_torch.core.distances import topk_neighbors
from gpann_tpu_torch.search import relayout as trel
from gpann_tpu_torch.search.streamed import (
    StreamedShardEngine, _masked_rescored_topk)

TOL = dict(rtol=1e-4, atol=1e-4)
N, D, NQ, S, K = 20_000, 24, 64, 8, 10
RN, RS, CHUNK = 5000, 8, 512  # the relayout tests' size


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
    """The tests/test_streamed.py setup: 20k x 24 hard mixture, 8 balanced
    k-means shards, 2000 routing points."""
    pts = generate("hard", N, D, seed=7)
    q = generate_queries("hard", NQ, D, seed=7)
    _, assign = balanced_kmeans(pts, k=S, eps=0.05, seed=7)
    clusters = partition_to_clusters(assign, S)
    rsub = np.sort(np.random.default_rng(3).choice(N, 2000, replace=False))
    return pts, q, assign, clusters, pts[rsub], assign[rsub]


def exact_dists(pts, q, ids, metric="l2"):
    """Exact f32 distances of each query to its ids (+inf for id -1)."""
    rows = np.asarray(pts[np.maximum(ids, 0)], np.float32)
    if metric == "mips":
        d = 1.0 - np.einsum("md,mkd->mk", q, rows)
    else:
        d = ((q[:, None, :] - rows) ** 2).sum(-1)
    return np.where(ids >= 0, d, np.inf).astype(np.float32)


def assert_same_search(got, want, pts, q, metric="l2"):
    """Distances within TOL; the port's ids stand for the distances it
    reports (a near-tie may swap two ids, never a distance)."""
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_allclose(gd, wd, **TOL)
    np.testing.assert_allclose(exact_dists(pts, q, gi, metric), gd, **TOL)
    assert ((gi >= 0) == np.isfinite(gd)).all()
    assert np.mean(gi == wi) > 0.99


def same_members(a: str, b: str, pts) -> None:
    """Two store directories with equal ``meta.json`` whose shards hold the
    same points, whatever their order inside a shard."""
    with open(os.path.join(a, "meta.json")) as f, \
            open(os.path.join(b, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    sa, sb = trel.ShardMajorStore(a), jrel.ShardMajorStore(b)
    for shard in range(sa.num_shards):
        ia = np.asarray(sa.shard_ids(shard)).astype(np.int64)
        ib = np.asarray(sb.shard_ids(shard)).astype(np.int64)
        np.testing.assert_array_equal(np.sort(ia), np.sort(ib))
        np.testing.assert_array_equal(np.asarray(sa.shard_rows(shard)),
                                      pts[ia])


def same_dir(a: str, b: str) -> None:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


# -- the store -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_relayout_store_files_identical_and_cross_readable(tmp_path, dtype):
    pts = generate("hard", RN, D, seed=3, dtype=dtype)
    part = np.random.default_rng(555).integers(0, RS, size=RN)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jrel.relayout_to_store(pts, part, RS, jdir, chunk_rows=CHUNK)
    tstore = trel.relayout_to_store(pts, part, RS, tdir, chunk_rows=CHUNK)
    same_dir(jdir, tdir)
    with open(os.path.join(tdir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["complete"] and meta["dtype"] == pts.dtype.name
    assert meta["ids_dtype"] == "uint32" and sum(meta["sizes"]) == RN
    # each package opens the other's directory
    for store in (trel.ShardMajorStore(jdir), jrel.ShardMajorStore(tdir)):
        assert store.n == RN and store.d == D and store.dtype == pts.dtype
        for b in range(RS):
            ids = np.asarray(store.shard_ids(b)).astype(np.int64)
            np.testing.assert_array_equal(ids, np.nonzero(part == b)[0])
            np.testing.assert_array_equal(np.asarray(store.shard_rows(b)),
                                          pts[ids])
    assert trel.ShardMajorStore.exists(jdir)
    assert not trel.ShardMajorStore.exists(str(tmp_path / "none"))
    jstore = jrel.ShardMajorStore(jdir)
    pos = np.array([[0, 100, -1], [RN - 1, 1, 2]])
    np.testing.assert_array_equal(tstore.orig_ids(pos), jstore.orig_ids(pos))
    for got, want in zip(tstore.sample(512, seed=1), jstore.sample(512, seed=1)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tstore.sample(4000, seed=2, widen=False),
                         jstore.sample(4000, seed=2, widen=False)):
        np.testing.assert_array_equal(got, want)
    tv, jv = tstore.concat_view(), jstore.concat_view()
    assert len(tv) == RN and tv.shape == (RN, D)
    idx = np.random.default_rng(2).integers(0, RN, 200)
    for key in (slice(0, 50), slice(600, 2100), slice(RN - 3, RN), idx,
                (slice(10, 20), slice(1, 4))):
        np.testing.assert_array_equal(tv[key], jv[key])


def test_incomplete_store_is_refused(tmp_path):
    w = trel._Writer(str(tmp_path), 2, 4, np.float32, np.uint32)
    w.append(np.array([0, 1, 1]), np.arange(3),
             np.ones((3, 4), np.float32))
    assert not trel.ShardMajorStore.exists(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        trel.ShardMajorStore(str(tmp_path))
    w.truncate_to(np.array([0, 1]))  # cut back to one row of shard 1
    store = w.finalize(1)
    assert store.sizes.tolist() == [0, 1]
    assert store.shard_rows(0).shape == (0, 4)


@pytest.mark.parametrize("max_chunks", [None, 2], ids=["one_shot", "resumed"])
def test_capacity_assign_to_store_matches(tmp_path, max_chunks):
    """The fused assign + relayout admits every point to the part that the
    port's ``capacity_stream_assign`` gives it, also when interrupted by
    ``max_chunks`` and resumed, and every shard holds the points of the JAX
    package's store, each chunk's rows in ascending id order."""
    rng = np.random.default_rng(555)
    pts = rng.standard_normal((RN, D)).astype(np.float32)
    reps = rng.standard_normal((37, D)).astype(np.float32)
    rep_labels = rng.integers(0, RS, size=37)
    rep_labels[:RS] = np.arange(RS)  # every part reachable
    want = capacity_stream_assign(pts, reps, rep_labels, RS, eps=0.05,
                                  chunk_rows=CHUNK, device="cpu")
    dirs = {}
    for name, fn, kw in (("j", jrel.capacity_assign_to_store, {}),
                         ("t", trel.capacity_assign_to_store,
                          {"device": "cpu"})):
        dirs[name] = str(tmp_path / name)
        calls = 0
        while not fn(pts, reps, rep_labels, RS, dirs[name], eps=0.05,
                     chunk_rows=CHUNK, max_chunks=max_chunks, **kw):
            calls += 1
            assert calls < 50
            assert os.path.exists(os.path.join(dirs[name], "ckpt.json"))
        assert (calls > 0) == (max_chunks is not None)
    same_members(dirs["t"], dirs["j"], pts)
    store = trel.ShardMajorStore(dirs["t"])
    got = np.full(RN, -1, np.int64)
    for b in range(RS):
        ids = np.asarray(store.shard_ids(b)).astype(np.int64)
        got[ids] = b
        # ascending through the chunks of the first pass; each retry round
        # appends one more ascending run (admission order would descend
        # hundreds of times)
        assert (np.diff(ids) < 0).sum() <= 5
    np.testing.assert_array_equal(got, want)
    assert store.sizes.max() <= int(1.05 * np.ceil(RN / RS))


def test_capacity_assign_to_store_virtual_u8_base(tmp_path):
    """A regenerating byte base goes through the prefetch thread and lands
    in shards that hold what the JAX package's hold."""
    base = VirtualPoints("hard2", 3000, 16, 5, dtype="u8", chunk_rows=1024)
    reps = np.asarray(base[:64], np.float32)
    labels = np.arange(64) % 4
    for name, fn, kw in (("j", jrel.capacity_assign_to_store, {}),
                         ("t", trel.capacity_assign_to_store,
                          {"device": "cpu"})):
        assert fn(base, reps, labels, 4, str(tmp_path / name), eps=0.0,
                  chunk_rows=700, **kw)
    same_members(str(tmp_path / "t"), str(tmp_path / "j"), base)
    assert trel.ShardMajorStore(str(tmp_path / "t")).dtype == np.uint8


def test_fused_store_row_order_keeps_binned_recall(tmp_path):
    """Why the port writes a chunk's rows in id order: in admission order
    (closest to the representative first, as the JAX package writes them)
    the points of one dense cluster sit side by side and share 128-row
    bins, and the bin-top-2 scan, which keeps two candidates a bin, loses
    neighbours even when every shard is probed. Same points, same engine,
    same queries; only the order inside the shard files differs."""
    n, d, s, k = 40_000, 48, 2, 10
    base = VirtualPoints("hard2", n, d, 9, dtype="u8", chunk_rows=1 << 15)
    q = generate_queries("hard2", 128, d, 9, dtype="u8")
    from gpann_tpu_torch.cluster.kmeans import kmeans
    from gpann_tpu_torch.core.distances import streaming_topk_neighbors

    cents, _ = kmeans(np.asarray(base[:8000], np.float32), k=s, seed=9,
                      device="cpu")
    labels = np.arange(s)
    assert jrel.capacity_assign_to_store(base, cents, labels, s,
                                         str(tmp_path / "j"), eps=0.05,
                                         chunk_rows=1 << 15)
    assert trel.capacity_assign_to_store(base, cents, labels, s,
                                         str(tmp_path / "t"), eps=0.05,
                                         chunk_rows=1 << 15, device="cpu")
    same_members(str(tmp_path / "t"), str(tmp_path / "j"), base)
    last = {}
    for name in "jt":
        store = trel.ShardMajorStore(str(tmp_path / name))
        gt_d, _ = streaming_topk_neighbors(q, store.concat_view(), k,
                                           device="cpu")
        engine = StreamedShardEngine(None, None, cents, labels,
                                     scan_mode="binned", store=store,
                                     device="cpu")
        last[name] = engine.recall_curve(q, k, gt_d[:, -1])[0][-1]
    assert last["t"] >= 0.999
    assert last["j"] <= last["t"] - 0.01, last


@pytest.mark.parametrize("sub_size", [2048, 512])
def test_regrouped_store_keeps_binned_recall(tmp_path, sub_size):
    """A sub-cluster-major store holds each sub-cluster's rows side by side,
    so near neighbours share 128-row bins again (the fault of the test
    above, made by the regrouping). The binned scan of such a store scans
    its blocks in a fixed row permutation: every shard probed, no pruning,
    the last prefix stays >= 0.999 (0.955 at sub-size 2048 and 0.821 at 512
    without the permutation), and the exact scan at 1.0. A permuted block
    still loses a neighbour where three of a query's ten share a bin, as an
    id-ordered one does: ~120 / 157^2 of the queries at 157 bins a shard."""
    n, d, s, k = 40_000, 48, 2, 10
    base = VirtualPoints("hard2", n, d, 9, dtype="u8", chunk_rows=1 << 15)
    q = generate_queries("hard2", 128, d, 9, dtype="u8")
    from gpann_tpu_torch.cluster.kmeans import kmeans
    from gpann_tpu_torch.core.distances import streaming_topk_neighbors

    cents, _ = kmeans(np.asarray(base[:8000], np.float32), k=s, seed=9,
                      device="cpu")
    labels = np.arange(s)
    assert trel.capacity_assign_to_store(base, cents, labels, s, str(tmp_path),
                                         eps=0.05, chunk_rows=1 << 15,
                                         device="cpu")
    store = trel.ShardMajorStore(str(tmp_path))
    gt_d, _ = streaming_topk_neighbors(q, store.concat_view(), k, device="cpu")
    StreamedShardEngine(None, None, cents, labels, store=store, device="cpu"
                        ).build_subclusters_store(target_sub_size=sub_size)
    last = {}
    for mode in ("binned", "exact"):
        engine = StreamedShardEngine(
            None, None, cents, labels, scan_mode=mode,
            store=trel.ShardMajorStore(str(tmp_path)), device="cpu")
        assert len(engine.sub_centroids[0]) >= n // s // sub_size
        last[mode] = engine.recall_curve(q, k, gt_d[:, -1])[0][-1]
    assert last["binned"] >= 0.999, last
    assert last["exact"] == 1.0, last


@pytest.mark.parametrize("sub_nprobe", [None, 1], ids=["whole", "pruned"])
def test_shard_block_is_what_a_pass_scans(tmp_path, monkeypatch, sub_nprobe):
    """``shard_block``, ``takes_binned`` and ``scan_permutation`` give, shard
    by shard, the blocks that a pass over a sub-cluster-major store hands
    to the binned scan, whole or pruned: the same query rows and the same
    rows in the same order (chip_smoke.py holds kernel B2 on such a
    block)."""
    from gpann_tpu_torch.core.distances import to_device
    from gpann_tpu_torch.search import streamed

    n, d, s, k = 40_000, 16, 4, 10
    base = VirtualPoints("hard2", n, d, 9, dtype="u8", chunk_rows=1 << 14)
    q = generate_queries("hard2", 8, d, 9, dtype="u8").astype(np.float32)
    cents = np.asarray(base[:: n // s][:s], np.float32)
    labels = np.arange(s)
    assert trel.capacity_assign_to_store(base, cents, labels, s, str(tmp_path),
                                         eps=0.05, chunk_rows=1 << 14,
                                         device="cpu")
    engine = StreamedShardEngine(None, None, cents, labels,
                                 store=trel.ShardMajorStore(str(tmp_path)),
                                 device="cpu")
    engine.build_subclusters_store(target_sub_size=3000, train_sample=4096)
    scanned = []

    def recording(qs, blk, *args, **kw):
        scanned.append((qs.clone(), blk.clone()))
        return fused_topk(qs, blk, *args, **kw)

    fused_topk = streamed.fused_topk
    monkeypatch.setattr(streamed, "fused_topk", recording)
    engine.search(q, k, 2, sub_nprobe=sub_nprobe)
    probes = engine.probe_order(q, 2)
    replayed = []
    for b in range(s):
        qidx = np.nonzero((probes == b).any(1))[0]
        if len(qidx) == 0:
            continue
        rows, _, grouped = engine.shard_block(b, q[qidx], sub_nprobe)
        assert grouped
        if not engine.takes_binned(len(rows), k):
            continue
        blk = to_device(rows, "cpu")[engine.scan_permutation(len(rows))]
        replayed.append((torch.as_tensor(q[qidx]), blk))
    assert len(replayed) == len(scanned) >= 2
    if sub_nprobe:
        assert sum(len(b) for _, b in scanned) < n
    for (gq, gb), (wq, wb) in zip(scanned, replayed):
        assert torch.equal(gq, wq) and torch.equal(gb, wb)


# -- routing -------------------------------------------------------------------

@pytest.mark.parametrize("voting_impl", ["exact", "rescore"])
@pytest.mark.parametrize("rule", ["min_dist", "frequency", "pyramid", "spann"])
def test_probe_orders_identical(setup, rule, voting_impl):
    pts, q, _, clusters, rp, rl = setup
    jeng = JaxEngine(pts, clusters, rp, rl, scan_mode="exact",
                     voting_impl=voting_impl)
    teng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact",
                               voting_impl=voting_impl, device="cpu")
    np.testing.assert_array_equal(
        teng.probe_order(q, 4, voting_t=30, rule=rule),
        jeng.probe_order(q, 4, voting_t=30, rule=rule))


def test_probe_order_binned_voting(setup):
    """"binned" voting on the CPU takes the plain scan; with 2000 routing
    points and T=8 its vote set is the exact one."""
    pts, q, _, clusters, rp, rl = setup
    want = StreamedShardEngine(pts, clusters, rp, rl, device="cpu"
                               ).probe_order(q, 3, voting_t=8)
    got = StreamedShardEngine(pts, clusters, rp, rl, voting_impl="binned",
                              device="cpu").probe_order(q, 3, voting_t=8)
    assert np.mean(got == want) > 0.98


def test_engine_rejects_bad_arguments(setup):
    pts, q, _, clusters, rp, rl = setup
    with pytest.raises(ValueError, match="scan_mode"):
        StreamedShardEngine(pts, clusters, rp, rl, scan_mode="fast",
                            device="cpu")
    with pytest.raises(ValueError, match="max_scan_rows"):
        StreamedShardEngine(pts, clusters, rp, rl, max_scan_rows=0,
                            device="cpu")
    with pytest.raises(TypeError):
        StreamedShardEngine(pts, clusters, rp, rl)  # device is required
    eng = StreamedShardEngine(pts, clusters, rp, rl, device="cpu")
    with pytest.raises(ValueError, match="unknown rule"):
        eng.probe_order(q, 2, rule="nearest")


# -- search --------------------------------------------------------------------

@pytest.mark.parametrize("scan_mode,max_scan_rows", [
    ("exact", None), ("exact", 1024), ("binned", None)],
    ids=["exact-unsliced", "exact-sliced", "binned-unsliced"])
def test_search_rows_layout_matches(setup, scan_mode, max_scan_rows):
    """Rows layout, f32: the port against the JAX engine (unsliced there),
    with whole shards and with every ~2.5k-row shard cut into 1024-row
    slices whose top-k lists merge on the host."""
    pts, q, _, clusters, rp, rl = setup
    jeng = JaxEngine(pts, clusters, rp, rl, scan_mode=scan_mode,
                     interpret=True)
    teng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode=scan_mode,
                               max_scan_rows=max_scan_rows, device="cpu")
    wd, wi, wstats = jeng.search(q, K, nprobes=3, voting_t=30)
    gd, gi, stats = teng.search(q, K, nprobes=3, voting_t=30)
    assert_same_search((gd, gi), (wd, wi), pts, q)
    assert stats["shards_scanned"] == wstats["shards_scanned"]
    assert (stats["blocks_scanned"] > stats["shards_scanned"]) == (
        max_scan_rows is not None)
    # the port uploads real rows, the JAX engine padded blocks
    sizes = np.asarray([len(c) for c in clusters])
    probes = teng.probe_order(q, 3, voting_t=30)
    assert stats["bytes_uploaded"] == 4 * D * (
        sizes[np.unique(probes)].sum() + probes.size)
    assert stats["bytes_uploaded"] < wstats["bytes_uploaded"]
    assert stats["device_scan_ms"] == 0.0  # CUDA events only


@pytest.mark.parametrize("scan_mode", ["exact", "binned"])
def test_search_rows_layout_matches_mips(setup, scan_mode):
    """Rows layout under MIPS (1 - q.x, no norms): the port against the
    JAX engine, whole shards."""
    pts, q, _, clusters, rp, rl = setup
    jeng = JaxEngine(pts, clusters, rp, rl, metric="mips",
                     scan_mode=scan_mode, interpret=True)
    teng = StreamedShardEngine(pts, clusters, rp, rl, metric="mips",
                               scan_mode=scan_mode, device="cpu")
    np.testing.assert_array_equal(teng.probe_order(q, 3, voting_t=30),
                                  jeng.probe_order(q, 3, voting_t=30))
    wd, wi, wstats = jeng.search(q, K, nprobes=3, voting_t=30)
    gd, gi, stats = teng.search(q, K, nprobes=3, voting_t=30)
    assert_same_search((gd, gi), (wd, wi), pts, q, metric="mips")
    assert stats["shards_scanned"] == wstats["shards_scanned"]


def test_rows_layout_of_a_cover_in_id_order(setup):
    """A cover lists each shard's members, then its extra points; the port
    lays every shard's rows out in id order, so the binned scan sees the
    layout the JAX engine gets from the same cover sorted."""
    pts, q, assign, clusters, rp, rl = setup
    rng = np.random.default_rng(9)
    cover = [np.concatenate([c, rng.choice(np.nonzero(assign != b)[0], 500,
                                           replace=False)])
             for b, c in enumerate(clusters)]
    teng = StreamedShardEngine(pts, cover, rp, rl, scan_mode="binned",
                               device="cpu")
    for got, c in zip(teng.clusters, cover):
        np.testing.assert_array_equal(got, np.sort(c))
    jeng = JaxEngine(pts, [np.sort(c) for c in cover], rp, rl,
                     scan_mode="binned", interpret=True)
    want = jeng.search(q, K, nprobes=3, voting_t=30)[:2]
    assert_same_search(teng.search(q, K, nprobes=3, voting_t=30)[:2], want,
                       pts, q)


def test_search_binned_sliced_matches():
    """Binned scan over shards cut at a row limit (the setup of the JAX
    package's ``test_sliced_scan_binned_mode``: 2 x 20k-row shards, limit
    16384). Every slice keeps its own 16 best bin entries, so the sliced
    pass sees a superset of the unsliced candidates: its distances are the
    unsliced ones or smaller, and its ids at the slice borders (block-local
    positions + the slice's first row) stand for the distances reported."""
    rng = np.random.default_rng(2)
    n, d = 40_000, 16
    pts = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    assign = (np.arange(n) >= n // 2).astype(np.int32)
    clusters = partition_to_clusters(assign, 2)
    rsub = np.sort(rng.choice(n, 1000, replace=False))
    rp, rl = pts[rsub], assign[rsub]
    # queries next to rows on both sides of the 16384-row border
    near = np.concatenate([np.arange(16380, 16390),
                           n // 2 + np.arange(16380, 16390)])
    q = pts[near] + 0.01
    jeng = JaxEngine(pts, clusters, rp, rl, scan_mode="binned",
                     interpret=True)
    wd, wi, _ = jeng.search(q, K, nprobes=2, voting_t=30)
    whole = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="binned",
                                device="cpu")
    sliced = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="binned",
                                 max_scan_rows=16384, device="cpu")
    ud, ui, us = whole.search(q, K, nprobes=2, voting_t=30)
    assert_same_search((ud, ui), (wd, wi), pts, q)
    sd, si, ss = sliced.search(q, K, nprobes=2, voting_t=30)
    assert us["blocks_scanned"] == 2 and ss["blocks_scanned"] == 4
    assert ss["bytes_uploaded"] == us["bytes_uploaded"]
    assert (sd <= ud + 1e-4 + 1e-4 * np.abs(ud)).all()
    np.testing.assert_allclose(exact_dists(pts, q, si), sd, **TOL)
    assert (si[:, 0] == near).all()     # each query's own row comes first
    overlap = np.mean([len(np.intersect1d(si[r], ui[r]))
                       for r in range(len(q))]) / K
    assert overlap >= 0.99, overlap


def test_search_given_probes_shard_range_and_tables(setup):
    pts, q, _, clusters, rp, rl = setup
    teng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact",
                               device="cpu")
    jeng = JaxEngine(pts, clusters, rp, rl, scan_mode="exact")
    probes = teng.probe_order(q, 3, voting_t=30)
    td, ti, _ = teng.search(q, K, 3, probes=probes, return_tables=True)
    jd, ji, _ = jeng.search(q, K, 3, probes=probes, return_tables=True)
    assert td.shape == (NQ, 3, K) and ti.dtype == np.int64
    np.testing.assert_allclose(td, jd, **TOL)
    assert np.mean(ti == ji) > 0.99
    # two half passes fill disjoint slots of the whole pass's tables
    lo_d, lo_i, s1 = teng.search(q, K, 3, probes=probes, return_tables=True,
                                 shard_range=(0, S // 2))
    hi_d, hi_i, s2 = teng.search(q, K, 3, probes=probes, return_tables=True,
                                 shard_range=(S // 2, S))
    np.testing.assert_array_equal(np.minimum(lo_d, hi_d), td)
    np.testing.assert_array_equal(np.maximum(lo_i, hi_i), ti)
    assert s1["shards_scanned"] + s2["shards_scanned"] <= S


@pytest.mark.parametrize("scan_mode,max_scan_rows", [
    ("exact", 1500), ("binned", None)], ids=["exact-sliced", "binned"])
def test_search_u8_store_matches(tmp_path, scan_mode, max_scan_rows):
    """Store layout over a byte base: rows go up raw and widen on the
    device; the store is the JAX package's, opened by the port."""
    pts = generate("hard", N, D, seed=5, dtype="u8")
    q = generate_queries("hard", 48, D, seed=5, dtype="u8")
    part = np.random.default_rng(555).integers(0, S, size=N)
    jstore = jrel.relayout_to_store(pts, part, S, str(tmp_path / "st"))
    tstore = trel.ShardMajorStore(str(tmp_path / "st"))
    rp, rl = np.asarray(pts[::20], np.float32), part[::20]
    jeng = JaxEngine(None, None, rp, rl, scan_mode=scan_mode, store=jstore,
                     interpret=True)
    teng = StreamedShardEngine(None, None, rp, rl, scan_mode=scan_mode,
                               store=tstore, max_scan_rows=max_scan_rows,
                               device="cpu")
    wd, wi, _ = jeng.search(q, K, nprobes=3)
    gd, gi, stats = teng.search(q, K, nprobes=3)
    assert_same_search((gd, gi), (wd, wi), pts, q)
    probed = np.unique(teng.probe_order(q, 3))
    assert stats["bytes_uploaded"] == (
        D * tstore.sizes[probed].sum() + 4 * D * q.shape[0] * 3)
    assert (stats["blocks_scanned"] > stats["shards_scanned"]) == (
        max_scan_rows is not None)


def test_recall_curve_matches(setup, tmp_path):
    pts, q, assign, clusters, rp, rl = setup
    kth = topk_neighbors(torch.from_numpy(q), torch.from_numpy(pts), K
                         )[0][:, -1].numpy()
    jeng = JaxEngine(pts, clusters, rp, rl, scan_mode="exact")
    want, _ = jeng.recall_curve(q, K, kth, voting_t=30)
    store = trel.relayout_to_store(pts, assign, S, str(tmp_path / "st"))
    for teng in (
        StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact",
                            device="cpu"),
        StreamedShardEngine(None, None, rp, rl, scan_mode="exact",
                            store=store, device="cpu"),
    ):
        got, stats = teng.recall_curve(q, K, kth, voting_t=30)
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert got[-1] > 0.999 and stats["shards_scanned"] == S
    short, _ = teng.recall_curve(q, K, kth, max_nprobes=3, voting_t=30)
    np.testing.assert_allclose(short, want[:3], atol=1e-6)


def test_memmap_base(setup, tmp_path):
    pts, q, _, clusters, rp, rl = setup
    path = str(tmp_path / "base.npy")
    np.save(path, pts)
    mm = np.load(path, mmap_mode="r")
    a = StreamedShardEngine(pts, clusters, rp, rl, device="cpu"
                            ).search(q, K, 2, voting_t=30)
    b = StreamedShardEngine(mm, clusters, rp, rl, device="cpu"
                            ).search(q, K, 2, voting_t=30)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])



def _ring_counters(eng, q, **kw):
    """A pass with a recorder installed: its answers, stats and counters."""
    from gpann_tpu_torch.core.profiling import Recorder, recording

    rec = Recorder()
    with recording(rec):
        d, i, stats = eng.search(q, K, **kw)
    return d, i, stats, rec.drain().counters


def test_store_pass_through_the_ring_matches(setup, tmp_path):
    """A store pass whose shards (~2.5k rows) take 5-6 blocks of 512 rows
    each: the two staging slots are refilled ~20 times in the pass, and the
    answers are the JAX engine's unsliced ones (the exact scan's top-k of
    the blocks' top-k lists is the shard's)."""
    pts, q, assign, _, rp, rl = setup
    jstore = jrel.relayout_to_store(pts, assign, S, str(tmp_path / "st"))
    jeng = JaxEngine(None, None, rp, rl, scan_mode="exact", store=jstore)
    teng = StreamedShardEngine(None, None, rp, rl, scan_mode="exact",
                               store=trel.ShardMajorStore(str(tmp_path / "st")),
                               max_scan_rows=512, device="cpu")
    wd, wi, _ = jeng.search(q, K, nprobes=3, voting_t=30)
    gd, gi, stats, counters = _ring_counters(teng, q, nprobes=3, voting_t=30)
    assert_same_search((gd, gi), (wd, wi), pts, q)
    assert stats["blocks_scanned"] >= 5 * stats["shards_scanned"] >= 5 * 3
    assert counters["stream.blocks_staged"] == stats["blocks_scanned"]
    assert counters["stream.staging_waits"] == 0   # no copies on the CPU
    assert teng._stage.rows == 512


@pytest.mark.parametrize("read", ["pruned-store", "memmap"])
def test_pruned_and_memmap_reads_go_through_the_ring(setup, tmp_path, read):
    """The reads that no benchmark cell makes fill the same staging slots:
    a pruned read of a sub-cluster-major store (the chosen sub-clusters'
    slices side by side, cut across block borders) and a fancy-indexed
    memmap base, both in blocks of a few hundred rows, match the JAX
    engine's unsliced pass."""
    if read == "pruned-store":
        pts = generate("hard", RN, D, seed=11)
        q = generate_queries("hard", 48, D, seed=11)
        part = np.random.default_rng(555).integers(0, RS, size=RN)
        rp, rl = pts[::50].copy(), part[::50].copy()
        jstore = jrel.relayout_to_store(pts, part, RS, str(tmp_path / "j"))
        jeng = JaxEngine(None, None, rp, rl, scan_mode="exact", store=jstore)
        jeng.build_subclusters_store(target_sub_size=100, train_sample=600,
                                     seed=1)
        teng = StreamedShardEngine(
            None, None, rp, rl, scan_mode="exact", max_scan_rows=96,
            store=trel.ShardMajorStore(str(tmp_path / "j")), device="cpu")
        kw = dict(nprobes=4, sub_nprobe=2)
    else:
        pts, q, _, clusters, rp, rl = setup
        np.save(str(tmp_path / "base.npy"), pts)
        mm = np.load(str(tmp_path / "base.npy"), mmap_mode="r")
        jeng = JaxEngine(pts, clusters, rp, rl, scan_mode="exact")
        teng = StreamedShardEngine(mm, clusters, rp, rl, scan_mode="exact",
                                   max_scan_rows=700, device="cpu")
        kw = dict(nprobes=3, voting_t=30)
    wd, wi, _ = jeng.search(q, K, **kw)
    gd, gi, stats, counters = _ring_counters(teng, q, **kw)
    assert_same_search((gd, gi), (wd, wi), pts, q)
    assert stats["blocks_scanned"] > stats["shards_scanned"] >= 3
    assert counters["stream.blocks_staged"] == stats["blocks_scanned"]


# -- the split fill of a store pass ------------------------------------------------

@pytest.fixture(scope="module")
def split_stores(tmp_path_factory):
    """f32 and u8 stores of a 5000 x 24 hard base in 8 shards, shard 0 of
    two rows (fewer than the three readers below), regrouped sub-cluster by
    sub-cluster by the port so that a pass can prune; the routing points
    and 4 queries of each."""
    out = {}
    for dtype in ("f32", "u8"):
        pts = generate("hard", RN, D, seed=17, dtype=dtype)
        part = np.random.default_rng(17).integers(1, RS, size=RN)
        part[:2] = 0
        path = str(tmp_path_factory.mktemp(dtype))
        store = trel.relayout_to_store(pts, part, RS, path)
        rp, rl = np.asarray(pts[::50], np.float32), part[::50]
        StreamedShardEngine(None, None, rp, rl, store=store, device="cpu"
                            ).build_subclusters_store(
            target_sub_size=100, train_sample=600, seed=1)
        q = generate_queries("hard", 4, D, seed=17, dtype=dtype)
        out[dtype] = (path, rp, rl, np.asarray(q, np.float32))
    return out


def _split_pass(data, readers, monkeypatch, **kw):
    """A pass over every shard of ``data``'s store with ``readers`` threads
    filling each staging buffer: answers, stats, counters, the engine."""
    from gpann_tpu_torch.search import streamed

    path, rp, rl, q = data
    monkeypatch.setattr(streamed, "_READERS", readers)
    eng = StreamedShardEngine(None, None, rp, rl, scan_mode="exact",
                              store=trel.ShardMajorStore(path), device="cpu",
                              max_scan_rows=kw.pop("max_scan_rows"))
    probes = np.tile(np.arange(RS), (len(q), 1))    # the 2-row shard too
    return (*_ring_counters(eng, q, nprobes=RS, probes=probes, **kw), eng)


@pytest.mark.parametrize("max_scan_rows", [None, 97],
                         ids=["whole-shards", "blocks-of-97"])
@pytest.mark.parametrize("sub_nprobe", [None, 1], ids=["whole", "pruned"])
@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_split_fill_bit_equal_to_one_reader(split_stores, monkeypatch, dtype,
                                            sub_nprobe, max_scan_rows):
    """A store pass whose staging buffers three readers fill side by side
    gives bit for bit the answers of the same pass with one reader: whole
    and pruned reads (runs of sub-clusters cut across the readers' ranges),
    blocks of 97 rows (no multiple of 3), and a 2-row shard, which is read
    as two parts."""
    kw = dict(sub_nprobe=sub_nprobe, max_scan_rows=max_scan_rows)
    d1, i1, s1, c1, one = _split_pass(split_stores[dtype], 1, monkeypatch,
                                      **kw)
    d3, i3, s3, c3, three = _split_pass(split_stores[dtype], 3, monkeypatch,
                                        **kw)
    np.testing.assert_array_equal(d3, d1)
    np.testing.assert_array_equal(i3, i1)
    assert one._stage.pool is None and three._stage.readers == 3
    assert s3["blocks_scanned"] == s1["blocks_scanned"] == \
        c3["stream.blocks_staged"] >= RS
    assert (s3["blocks_scanned"] > RS) == (max_scan_rows is not None)
    assert c1["stream.fill_parts"] == c1["stream.blocks_staged"]
    q = split_stores[dtype][3]
    blocks = []
    for b in range(RS):
        n = len(three.shard_block(b, q, sub_nprobe)[1])
        size = max_scan_rows or n
        blocks += [min(size, n - lo) for lo in range(0, n, size)]
    assert c3["stream.fill_parts"] == sum(min(3, n) for n in blocks)
    assert min(blocks) == 2
    if sub_nprobe:
        whole = _split_pass(split_stores[dtype], 3, monkeypatch,
                            max_scan_rows=max_scan_rows)[2]
        assert s3["bytes_uploaded"] < whole["bytes_uploaded"]


def test_many_readers_fill_tiny_blocks(split_stores, monkeypatch):
    """Twice as many readers as cores and a short switch interval, over
    blocks of 37 rows: every row lands where one reader puts it."""
    import os
    import sys

    readers = 2 * len(os.sched_getaffinity(0))
    interval = sys.getswitchinterval()
    kw = dict(sub_nprobe=1, max_scan_rows=37)
    want = _split_pass(split_stores["f32"], 1, monkeypatch, **kw)
    sys.setswitchinterval(1e-6)
    try:
        got = _split_pass(split_stores["f32"], readers, monkeypatch, **kw)
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[3]["stream.fill_parts"] > 4 * got[3]["stream.blocks_staged"]


@pytest.mark.parametrize("sub_nprobe", [None, 1], ids=["whole", "pruned"])
@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_store_read_gives_the_memmap_rows_at_any_borders(split_stores, dtype,
                                                         sub_nprobe):
    """A store read's ``fill(out, lo, hi)``, which each reader thread calls
    on its range, gives rows ``[lo, hi)`` of the read as the store's memmap
    holds them (of the chosen sub-clusters, pruned), at odd borders."""
    path, rp, rl, q = split_stores[dtype]
    store = trel.ShardMajorStore(path)
    eng = StreamedShardEngine(None, None, rp, rl, store=store, device="cpu")
    fill, members, grouped = eng._reader(3, q, sub_nprobe)
    rows = np.asarray(store.shard_rows(3))
    ids = np.asarray(store.shard_ids(3)).astype(np.int64)
    order = np.argsort(ids)
    want = rows[order[np.searchsorted(ids[order], members)]]
    n = len(want)
    assert grouped and (n < len(rows)) == (sub_nprobe is not None)
    for lo, hi in ((0, n), (1, 2), (7, n - 3), (n - 1, n)):
        out = np.full((hi - lo, D), 7, store.dtype)
        fill(out, lo, hi)
        np.testing.assert_array_equal(out, want[lo:hi])


# -- in-shard sub-clusters -----------------------------------------------------

def test_subcluster_artifact_carried_across(setup):
    """The JAX engine's ``subcluster_artifact()`` loads into the port;
    pruned search (members concatenated in the order of the rows) matches
    the JAX engine's, and uploads fewer bytes than the whole shards."""
    pts, q, _, clusters, rp, rl = setup
    jeng = JaxEngine(pts, clusters, rp, rl, scan_mode="exact")
    art = jeng.build_subclusters(target_sub_size=500, train_sample=2000,
                                 seed=7)
    teng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact",
                               device="cpu")
    teng.load_subclusters(art)
    back = teng.subcluster_artifact()
    assert sorted(back) == sorted(art)
    for key in art:
        np.testing.assert_array_equal(back[key], art[key])
    wd, wi, _ = jeng.search(q, K, 3, voting_t=30, sub_nprobe=2)
    gd, gi, pruned = teng.search(q, K, 3, voting_t=30, sub_nprobe=2)
    assert_same_search((gd, gi), (wd, wi), pts, q)
    _, _, whole = teng.search(q, K, 3, voting_t=30)
    assert pruned["bytes_uploaded"] < whole["bytes_uploaded"]
    # sub_nprobe >= every shard's sub-cluster count: the whole-shard search
    fd, fi, _ = teng.search(q, K, 3, voting_t=30, sub_nprobe=10_000)
    wd0, wi0, _ = teng.search(q, K, 3, voting_t=30)
    np.testing.assert_array_equal(fd, wd0)
    np.testing.assert_array_equal(fi, wi0)


def test_build_subclusters_own(setup):
    """The port's own sub-cluster build: every member once, pruning cuts
    bytes and keeps recall."""
    pts, q, _, clusters, rp, rl = setup
    teng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact",
                               device="cpu")
    art = teng.build_subclusters(target_sub_size=500, train_sample=2000,
                                 seed=7)
    np.testing.assert_array_equal(np.sort(art["flat"]), np.arange(N))
    assert art["shard_ptr"][-1] == len(art["cents"]) == len(art["indptr"]) - 1
    assert art["shard_ptr"][-1] > 3 * S
    kth = topk_neighbors(torch.from_numpy(q), torch.from_numpy(pts), K
                         )[0][:, -1].numpy()
    # few queries, so that the union of their closest sub-clusters is a cut
    q, kth = q[:8], kth[:8]
    full, s_full = teng.recall_curve(q, K, kth, max_nprobes=3, voting_t=30)
    cut, s_cut = teng.recall_curve(q, K, kth, max_nprobes=3, voting_t=30,
                                   sub_nprobe=2)
    assert s_cut["bytes_uploaded"] < s_full["bytes_uploaded"]
    assert full[-1] - 0.25 <= cut[-1] <= full[-1] + 1e-9


def test_subcluster_major_store_carried_across(tmp_path):
    """A store regrouped by the JAX package (rows by sub-cluster, sidecar)
    is opened by the port: same pruned search; and the port's own regroup
    keeps the store a valid permutation with slices that cover each shard."""
    pts = generate("hard", RN, D, seed=11)
    q = generate_queries("hard", 48, D, seed=11)
    part = np.random.default_rng(555).integers(0, RS, size=RN)
    rp, rl = pts[::50].copy(), part[::50].copy()
    jstore = jrel.relayout_to_store(pts, part, RS, str(tmp_path / "j"))
    jeng = JaxEngine(None, None, rp, rl, scan_mode="exact", store=jstore)
    jeng.build_subclusters_store(target_sub_size=100, train_sample=600,
                                 seed=1)
    teng = StreamedShardEngine(None, None, rp, rl, scan_mode="exact",
                               store=trel.ShardMajorStore(str(tmp_path / "j")),
                               device="cpu")
    assert teng.sub_slices is not None
    for off, want in zip(teng.sub_slices, jeng.sub_slices):
        np.testing.assert_array_equal(off, want)
    wd, wi, _ = jeng.search(q, K, 4, sub_nprobe=2)
    gd, gi, pruned = teng.search(q, K, 4, sub_nprobe=2)
    assert_same_search((gd, gi), (wd, wi), pts, q)

    tstore = trel.relayout_to_store(pts, part, RS, str(tmp_path / "t"))
    own = StreamedShardEngine(None, None, rp, rl, scan_mode="exact",
                              store=tstore, device="cpu")
    with pytest.raises(ValueError, match="sidecar"):
        own.search(q, K, 4, sub_nprobe=2)
    _, _, whole = own.search(q, K, 4)
    own.build_subclusters_store(target_sub_size=100, train_sample=600, seed=1)
    seen = []
    for b in range(RS):
        ids = np.asarray(tstore.shard_ids(b)).astype(np.int64)
        seen.append(ids)
        np.testing.assert_array_equal(np.asarray(tstore.shard_rows(b)),
                                      pts[ids])
        off = own.sub_slices[b]
        assert off[0] == 0 and off[-1] == tstore.sizes[b]
        assert (np.diff(off) > 0).all()
        assert len(own.sub_centroids[b]) == len(off) - 1
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(RN))
    # the sidecar persists: a fresh engine on the directory finds it
    again = StreamedShardEngine(None, None, rp, rl, scan_mode="exact",
                                store=trel.ShardMajorStore(str(tmp_path / "t")),
                                device="cpu")
    d1, i1, s1 = again.search(q, K, 4, sub_nprobe=2)
    assert s1["bytes_uploaded"] < whole["bytes_uploaded"]
    np.testing.assert_allclose(exact_dists(pts, q, i1), d1, **TOL)


# -- small shapes --------------------------------------------------------------

def test_tiny_shards_take_the_exact_scan():
    """Shards with fewer than 4k bin candidates, and one with fewer than k
    rows: finite distances first, then (+inf, -1) fillers."""
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((300, 8)).astype(np.float32)
    assign = np.zeros(300, np.int32)
    assign[:4] = 1                      # a 4-row shard (< k)
    clusters = partition_to_clusters(assign, 2)
    q = pts[:5] + 0.01
    rp, rl = pts[::3], assign[::3]
    for scan_mode in ("binned", "exact"):
        eng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode=scan_mode,
                                  device="cpu")
        d, i, _ = eng.search(q, K, 2, voting_t=20)
        assert np.isfinite(d).all() and (i >= 0).all()
        td, ti, _ = eng.search(q, K, 2, voting_t=20, return_tables=True)
        probes = eng.probe_order(q, 2, voting_t=20)
        small = td[probes == 1]         # slots that scanned the 4-row shard
        assert np.isfinite(small[:, :4]).all() and np.isinf(small[:, 4:]).all()
        assert (ti[probes == 1][:, 4:] == -1).all()
        np.testing.assert_allclose(exact_dists(pts, q, i), d, **TOL)


def test_masked_rescored_topk_masks_padding_rows():
    rng = np.random.default_rng(0)
    blk = torch.from_numpy(rng.standard_normal((600, 8)).astype(np.float32))
    blk[400:] = 0.0                     # padding rows at the origin
    qv = torch.zeros((3, 8))            # closest to the padding
    d, pos = _masked_rescored_topk(qv, blk, 400, K, "l2")
    assert (pos < 400).all() and torch.isfinite(d).all()
    want, _ = topk_neighbors(qv, blk[:400], K)
    torch.testing.assert_close(d, want, **TOL)
    # a byte block widens; fewer live rows than k pad with +inf
    d8, p8 = _masked_rescored_topk(qv, blk[:6].to(torch.uint8), 6, K, "l2")
    assert torch.isfinite(d8[:, :6]).all() and torch.isinf(d8[:, 6:]).all()
    assert (p8[:, 6:] == 0).all()
