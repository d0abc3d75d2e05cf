"""The streamed engine on a CUDA device against the same engine on the CPU.

Every test needs a GPU (marker ``gpu``) and skips without one. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_gpu_streamed.py -q

The CPU results are held against the JAX package by
``tests/test_torch_streamed.py``; here the device must not change them:
distances agree at rtol = atol = 1e-4 (the kernel's split-TF32 product
against the CPU's f32 product), ids stand for the distances reported, a
sliced pass equals the unsliced one, and a pass over a store launches kernel
B2 exactly once per probed shard. Through the staging ring (two page-locked
host buffers and two device blocks, refilled dozens of times a pass, also
under a slow copy or a slow scan) a pass gives bit for bit the answers of
the same pass composed serially from the engine's public pieces. A small GP store built on the card by
``cli.scale_bench --method gp`` holds every id once and its binned curve
lies within 0.002 of its exact one.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-4, atol=1e-4)
N, D, NQ, S, K = 60_000, 32, 96, 6, 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """60k x 32 hard mixture in 6 slab shards of ~10k rows (over the 4992
    rows a shard needs to take the binned scan at k=10), as f32 rows and as
    a u8 store."""
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.eval.synth import generate, generate_queries
    from gpann_tpu_torch.search.relayout import relayout_to_store

    pts = generate("hard", N, D, seed=7)
    q = generate_queries("hard", NQ, D, seed=7)
    order = np.argsort(pts[:, 0], kind="stable")
    part = np.empty(N, np.int32)
    part[order] = np.arange(N) * S // N
    rsub = np.sort(np.random.default_rng(3).choice(N, 3000, replace=False))
    u8 = generate("hard", N, D, seed=7, dtype="u8")
    store = relayout_to_store(u8, part, S,
                              str(tmp_path_factory.mktemp("store")))
    q8 = generate_queries("hard", NQ, D, seed=7, dtype="u8")
    return dict(pts=pts, q=q, part=part,
                clusters=partition_to_clusters(part, S), rp=pts[rsub],
                rl=part[rsub], u8=u8, q8=q8, store=store)


def exact_dists(pts, q, ids):
    rows = np.asarray(pts[np.maximum(ids, 0)], np.float32)
    d = ((q[:, None, :] - rows) ** 2).sum(-1)
    return np.where(ids >= 0, d, np.inf).astype(np.float32)


def engine(setup, device, **kw):
    from gpann_tpu_torch.search.streamed import StreamedShardEngine

    return StreamedShardEngine(setup["pts"], setup["clusters"], setup["rp"],
                               setup["rl"], device=device, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("scan_mode", ["binned", "exact"])
def test_cuda_search_equals_cpu_search(cuda, setup, scan_mode):
    cd, ci, _ = engine(setup, "cpu", scan_mode=scan_mode).search(
        setup["q"], K, 3, voting_t=30)
    gd, gi, stats = engine(setup, cuda, scan_mode=scan_mode).search(
        setup["q"], K, 3, voting_t=30)
    np.testing.assert_allclose(gd, cd, **TOL)
    np.testing.assert_allclose(exact_dists(setup["pts"], setup["q"], gi), gd,
                               **TOL)
    assert np.mean(gi == ci) > 0.99
    assert stats["device_scan_ms"] > 0 and stats["upload_s"] > 0


@pytest.mark.gpu
def test_probe_orders_equal_cpu(cuda, setup):
    for rule in ("min_dist", "frequency", "pyramid", "spann"):
        a = engine(setup, "cpu").probe_order(setup["q"], 4, 30, rule)
        b = engine(setup, cuda).probe_order(setup["q"], 4, 30, rule)
        assert np.mean(a == b) > 0.99, rule


@pytest.mark.gpu
def test_sliced_equals_unsliced(cuda, setup):
    """Slices of 6000 rows (no multiple of 128; over the binned guard): the
    sliced pass sees a superset of the candidates, ids at the slice borders
    stand for their distances."""
    from gpann_tpu_torch import kernels

    whole = engine(setup, cuda)
    sliced = engine(setup, cuda, max_scan_rows=6000)
    ud, ui, us = whole.search(setup["q"], K, 3, voting_t=30)
    kernels.reset_launches()
    sd, si, ss = sliced.search(setup["q"], K, 3, voting_t=30)
    assert ss["blocks_scanned"] == 2 * us["blocks_scanned"]
    assert kernels.LAUNCHES["binmin_scan"] == ss["blocks_scanned"]
    assert ss["bytes_uploaded"] == us["bytes_uploaded"]
    assert (sd <= ud + 1e-4 + 1e-4 * np.abs(ud)).all()
    np.testing.assert_allclose(exact_dists(setup["pts"], setup["q"], si), sd,
                               **TOL)
    overlap = np.mean([len(np.intersect1d(si[r], ui[r]))
                       for r in range(NQ)]) / K
    assert overlap >= 0.99, overlap


@pytest.mark.gpu
def test_default_row_limit_comes_from_free_memory(cuda, setup):
    eng = engine(setup, cuda)
    free, _ = torch.cuda.mem_get_info(cuda)
    limit = eng._scan_row_limit(NQ, 1)
    assert limit % 128 == 0
    # a u8 row costs 2 d raw (the staging ring's two device blocks) + 4 d
    # widened + its share of the summaries
    assert limit <= 0.5 * free / (6 * D) + 128
    assert limit > eng._scan_row_limit(NQ * 64, 1)
    # a grouped block's permuted rows are one more f32 copy a row
    assert eng._scan_row_limit(NQ, 1, grouped=True) <= 0.5 * free / (10 * D) + 128
    assert engine(setup, "cpu")._scan_row_limit(NQ, 4) is None
    assert engine(setup, cuda, max_scan_rows=77)._scan_row_limit(NQ, 4) == 77


@pytest.mark.gpu
def test_store_pass_launches_b2_once_per_probed_shard(cuda, setup):
    """A u8 store: rows go up raw, widen on the card, and every probed
    shard is one launch of kernel B2 (``binmin_scan``), none of B1."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.search.streamed import StreamedShardEngine

    rp = np.asarray(setup["u8"][::20], np.float32)
    rl = setup["part"][::20]
    outs = {}
    for device in ("cpu", cuda):
        eng = StreamedShardEngine(None, None, rp, rl, store=setup["store"],
                                  device=device)
        kernels.reset_launches()
        outs[str(device)] = eng.search(setup["q8"], K, 2)
        if device == "cpu":
            assert kernels.LAUNCHES == {"binmin_scan": 0, "bintop2_blocks": 0}
    (cd, ci, _), (gd, gi, stats) = outs["cpu"], outs[str(cuda)]
    probed = np.unique(eng.probe_order(setup["q8"], 2))
    assert kernels.LAUNCHES == {"binmin_scan": len(probed),
                                "bintop2_blocks": 0}
    assert stats["shards_scanned"] == len(probed) == stats["blocks_scanned"]
    assert stats["bytes_uploaded"] == (
        D * setup["store"].sizes[probed].sum() + 4 * D * NQ * 2)
    np.testing.assert_allclose(gd, cd, **TOL)
    np.testing.assert_allclose(exact_dists(setup["u8"], setup["q8"], gi), gd,
                               **TOL)


@pytest.mark.gpu
def test_kernel_b2_at_streamed_shapes(cuda):
    """Shapes the streamed path gives kernel B2: a shard whose row count is
    no multiple of 128, a u8 block widened on the card, a few query rows."""
    from gpann_tpu_torch.search import bin_scan as bs

    g = torch.Generator(device=cuda).manual_seed(5)
    for rows, m, as_u8 in ((9_999, 3, False), (12_345, 1, True),
                           (5_001, 200, True)):
        base = torch.randn((rows, 96), device=cuda, generator=g) * 20 + 128
        if as_u8:
            base = base.clamp(0, 255).to(torch.uint8).float()
        q = base[torch.randint(0, rows, (m,), device=cuda, generator=g)] + 0.5
        gm, gi = bs.binmin_scan(q, base, rows)
        wm, wi = bs.binmin_scan_plain(q, base, rows)
        torch.cuda.synchronize()
        fin = torch.isfinite(wm)
        assert torch.equal(fin, torch.isfinite(gm))
        # byte-scale data: |q|^2 + |x|^2 is ~3e6, whose f32 ulp is 0.25, and
        # the summaries carry a few ulp of it; the rescore below is exact
        torch.testing.assert_close(gm[fin], wm[fin], rtol=1e-4, atol=4.0)
        d, i = bs.fused_topk(q, base, rows, K)
        exact = ((q[:, None, :] - base[i.long()]) ** 2).sum(-1)
        torch.testing.assert_close(d, exact, rtol=1e-4, atol=1e-3)
        assert int(i.max()) < rows


@pytest.mark.gpu
def test_gp_store_on_cuda_binned_within_exact(cuda, tmp_path, monkeypatch):
    """``cli.scale_bench --method gp`` on the card (the fused assign of
    chip_smoke.py's path 9 at 200k x 32 u8, 8 shards of ~25k rows, over the
    binned guard): every id of ``range(n)`` once, no shard above the
    capacity, the binned curve within 0.002 of the exact one on the same
    store, router and queries, one B2 launch a shard in the binned pass and
    none in the exact one."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.cli import scale_bench
    from gpann_tpu_torch.search.relayout import ShardMajorStore

    n, shards = 200_000, 8
    monkeypatch.setenv("GPANN_CACHE_DIR", str(tmp_path))
    argv = ["--kind", "hard2", "--dtype", "u8", "--base", "virtual",
            "--layout", "shard-major", "--method", "gp", "--gp-subsample",
            "20000", "--gp-aggregates", "512", "--n", str(n), "--d", "32",
            "--shards", str(shards), "--nq", "256", "--train-sample", "20000",
            "--device", str(cuda)]
    curves = {}
    for mode, launches in (("binned", shards), ("exact", 0)):
        out = tmp_path / f"{mode}.csv"
        kernels.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            assert scale_bench.main(argv + ["--scan-mode", mode, "--out",
                                            str(out)]) == 0
        assert kernels.LAUNCHES == {"binmin_scan": launches,
                                    "bintop2_blocks": 0}
        rows = [line.split(",")
                for line in out.read_text().strip().split("\n")[1:]]
        curves[mode] = np.asarray([float(r[8]) for r in rows])
    store = ShardMajorStore(
        str(tmp_path / f"scale_hard2_555_{n}_32_{shards}_u8_gp_store"))
    assert store.sizes.max() <= int(1.05 * np.ceil(n / shards))
    ids = np.concatenate([store.shard_ids(b) for b in range(shards)])
    np.testing.assert_array_equal(np.sort(ids), np.arange(n))
    np.testing.assert_allclose(curves["binned"], curves["exact"], rtol=0,
                               atol=0.002)
    assert curves["binned"][-1] >= 0.999


# -- the staging ring ------------------------------------------------------------

RING_N, RING_ROWS = 120_000, 2560
# six shards of unequal sizes, 5 to 14 blocks of RING_ROWS each
RING_SIZES = (12_000, 14_400, 16_800, 19_200, 24_000, 33_600)


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """A 120k x 32 hard base, f32 and u8, as shard-major stores of six
    slab shards of unequal sizes, routed by every 20th row."""
    from gpann_tpu_torch.eval.synth import generate, generate_queries
    from gpann_tpu_torch.search.relayout import relayout_to_store

    part = np.empty(RING_N, np.int32)
    out = {}
    for dtype in ("f32", "u8"):
        pts = generate("hard", RING_N, D, seed=13, dtype=dtype)
        order = np.argsort(np.asarray(pts[:, 0], np.float32), kind="stable")
        part[order] = np.repeat(np.arange(len(RING_SIZES)), RING_SIZES)
        store = relayout_to_store(pts, part, len(RING_SIZES),
                                  str(tmp_path_factory.mktemp(dtype)))
        q = generate_queries("hard", NQ, D, seed=13, dtype=dtype)
        out[dtype] = dict(store=store, q=np.asarray(q, np.float32),
                          rp=np.asarray(pts[::20], np.float32),
                          rl=part[::20].copy())
    return out


def ring_engine(data, device, **kw):
    from gpann_tpu_torch.search.streamed import StreamedShardEngine

    return StreamedShardEngine(None, None, data["rp"], data["rl"],
                               store=data["store"], device=device, **kw)


def serial_pass(eng, q, nprobes, device):
    """The pass composed serially from the engine's public pieces: each
    probed shard's rows from ``shard_block``, uploaded and scanned block by
    block of ``max_scan_rows`` rows (``fused_topk``, or the exact scan below
    the binned guard), each block's results read back at once, then the
    host merge of ``search``."""
    from gpann_tpu_torch.search.streamed import (
        _masked_rescored_topk, fused_topk)

    probes = eng.probe_order(q, nprobes, voting_t=30)
    m, limit = len(q), eng.max_scan_rows
    tab_d = np.full((m, nprobes, K), np.inf, np.float32)
    tab_i = np.full((m, nprobes, K), -1, np.int64)
    for b in range(eng.num_shards):
        qidx, slot = np.nonzero(probes == b)
        if not len(qidx):
            continue
        rows, members, grouped = eng.shard_block(b, q[qidx])
        assert not grouped and len(rows) > 2 * limit
        qd = torch.from_numpy(q[qidx]).to(device)
        parts = []
        for lo in range(0, len(rows), limit):
            blk = torch.from_numpy(rows[lo : lo + limit]).to(device).float()
            n = len(blk)
            scan = fused_topk if eng.takes_binned(n, K) else \
                _masked_rescored_topk
            d, p = (t.cpu().numpy() for t in scan(qd, blk, n, K, eng.metric))
            parts.append((d, np.where(np.isfinite(d), p, 0).astype(np.int64)
                          + lo))
        dcat = np.concatenate([d for d, _ in parts], axis=1)
        pcat = np.concatenate([p for _, p in parts], axis=1)
        sel = np.argsort(dcat, axis=1, kind="stable")[:, :K]
        d = np.take_along_axis(dcat, sel, axis=1)
        pos = np.take_along_axis(pcat, sel, axis=1)
        tab_d[qidx, slot] = d
        tab_i[qidx, slot] = np.where(np.isfinite(d), members[pos], -1)
    flat_d, flat_i = tab_d.reshape(m, -1), tab_i.reshape(m, -1)
    sel = np.argsort(flat_d, axis=1, kind="stable")[:, :K]
    return (np.take_along_axis(flat_d, sel, axis=1),
            np.take_along_axis(flat_i, sel, axis=1))


SLOW_CYCLES = 4_000_000    # ~2 ms of the card's clock


@pytest.mark.gpu
@pytest.mark.parametrize("readers", [1, 3], ids=["one-reader", "split-fill"])
@pytest.mark.parametrize("lag", ["none", "slow-copy", "slow-scan"])
@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("scan_mode", ["binned", "exact"])
def test_ring_wraps_bit_equal_to_serial(cuda, ring, monkeypatch, scan_mode,
                                        dtype, lag, readers):
    """50 blocks through the two staging slots, each slot refilled ~25
    times in the pass: the answers equal the serial composition's bit for
    bit. ``slow-copy`` puts ~2 ms on the copy stream before every copy,
    so the host reaches a buffer whose copy is still queued (a refill that
    did not wait for it would send another block's rows); ``slow-scan``
    puts it on the compute stream before every scan, so a copy reaches a
    device block that a queued scan has still to read. ``split-fill``:
    three reader threads fill each staging buffer (2560 rows a block, no
    multiple of three) while the other buffer's copy may still run."""
    from gpann_tpu_torch.search import streamed

    monkeypatch.setattr(streamed, "_READERS", readers)
    data = ring[dtype]
    eng = ring_engine(data, cuda, scan_mode=scan_mode,
                      max_scan_rows=RING_ROWS)
    if lag == "slow-copy":
        upload = streamed._Staging.upload

        def slow_upload(self, i, n):
            with torch.cuda.stream(self.stream):
                torch.cuda._sleep(SLOW_CYCLES)
            return upload(self, i, n)
        monkeypatch.setattr(streamed._Staging, "upload", slow_upload)
    elif lag == "slow-scan":
        scan = streamed.StreamedShardEngine._scan

        def slow_scan(self, *args):
            torch.cuda._sleep(SLOW_CYCLES)
            return scan(self, *args)
        monkeypatch.setattr(streamed.StreamedShardEngine, "_scan", slow_scan)
    gd, gi, stats = eng.search(data["q"], K, 3, voting_t=30)
    monkeypatch.undo()
    assert stats["blocks_scanned"] >= 3 * stats["shards_scanned"] >= 3 * 4
    wd, wi = serial_pass(eng, data["q"], 3, cuda)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.gpu
def test_staging_is_pinned_kept_and_recorded(cuda, ring, monkeypatch):
    """The ring's host buffers are page-locked and, with its device blocks,
    kept from one pass to the next; the free memory is read once a pass;
    every block is staged; the six ``stream.*`` spans keep their tree, and
    the host time outside every step is not negative."""
    from annbench.streamwindow import summarise
    from gpann_tpu_torch.core.profiling import Recorder, recording

    data = ring["f32"]
    eng = ring_engine(data, cuda)
    reads = []
    mem_get_info = torch.cuda.mem_get_info

    def counted(*args, **kw):
        reads.append(args)
        return mem_get_info(*args, **kw)
    monkeypatch.setattr(torch.cuda, "mem_get_info", counted)
    eng.search(data["q"], K, 3, voting_t=30)
    assert len(reads) == 1
    stage = eng._stage
    assert all(h.is_pinned() for h in stage.host)
    assert all(b.device.type == "cuda" for b in stage.blocks)
    ptrs = [t.data_ptr() for t in stage.host + stage.blocks]
    rec = Recorder()
    with recording(rec):
        _, _, stats = eng.search(data["q"], K, 3, voting_t=30)
    assert len(reads) == 2
    assert eng._stage is stage
    assert [t.data_ptr() for t in stage.host + stage.blocks] == ptrs
    out = rec.drain()
    assert out.counters["stream.blocks_staged"] == stats["blocks_scanned"] \
        == stats["shards_scanned"] > 0
    assert out.counters["stream.staging_waits"] >= 0
    root = next(s for s in out.spans if s.name == "stream.pass")
    names = {s.name for s in out.spans}
    assert names == {"stream.pass", "stream.route", "stream.gather",
                     "stream.upload", "stream.scan", "stream.merge"}
    assert all(s.parent == root.id for s in out.spans if s is not root)
    assert all(s.stream_ms is not None for s in out.spans)
    summary = summarise(out.spans, out.counters)
    assert summary["outside_ms"] >= 0
    assert summary["stream_scan_ms"] > 0


@pytest.mark.gpu
def test_reader_pool_is_made_once_and_kept(cuda, ring, monkeypatch):
    """A store engine makes its pool of reader threads once, with the
    staging ring, and fills every block of later passes on the same
    threads; ``stream.fill_parts`` counts the readers of each block."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from gpann_tpu_torch.core.profiling import Recorder, recording
    from gpann_tpu_torch.search import streamed

    made = []

    class Counted(ThreadPoolExecutor):
        def __init__(self, *args, **kw):
            made.append(self)
            super().__init__(*args, **kw)
    monkeypatch.setattr(streamed, "ThreadPoolExecutor", Counted)
    monkeypatch.setattr(streamed, "_READERS", 3)
    data = ring["u8"]
    eng = ring_engine(data, cuda, max_scan_rows=RING_ROWS)
    seen = set()
    reader = streamed.StreamedShardEngine._reader

    def noted_reader(self, *args):
        fill, members, grouped = reader(self, *args)

        def noted(*part):
            seen.add(threading.get_ident())
            return fill(*part)
        return noted, members, grouped
    monkeypatch.setattr(streamed.StreamedShardEngine, "_reader", noted_reader)
    first = eng.search(data["q"], K, 3, voting_t=30)
    pool, threads = eng._stage.pool, set(seen)
    assert len(made) == 1 and pool is made[0]
    assert len(threads) == 3 and threading.get_ident() not in threads
    rec = Recorder()
    with recording(rec):
        again = eng.search(data["q"], K, 3, voting_t=30)
    assert len(made) == 1 and eng._stage.pool is pool and seen == threads
    np.testing.assert_array_equal(again[0], first[0])
    np.testing.assert_array_equal(again[1], first[1])
    c = rec.drain().counters
    assert c["stream.fill_parts"] == 3 * c["stream.blocks_staged"] \
        == 3 * again[2]["blocks_scanned"] > 0
