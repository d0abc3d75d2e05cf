"""The streamed engine on a CUDA device against the same engine on the CPU.

Every test needs a GPU (marker ``gpu``) and skips without one. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_gpu_streamed.py -q

The CPU results are held against the JAX package by
``tests/test_torch_streamed.py``; here the device must not change them:
distances agree at rtol = atol = 1e-4 (the kernel's split-TF32 product
against the CPU's f32 product), ids stand for the distances reported, a
sliced pass equals the unsliced one, and a pass over a store launches kernel
B2 exactly once per probed shard. A small GP store built on the card by
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
    # a u8 row costs d raw + 4 d widened + its share of the summaries
    assert limit <= 0.5 * free / (5 * D) + 128
    assert limit > eng._scan_row_limit(NQ * 64, 1)
    # a grouped block's permuted rows are one more f32 copy a row
    assert eng._scan_row_limit(NQ, 1, grouped=True) <= 0.5 * free / (9 * D) + 128
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
