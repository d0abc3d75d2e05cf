"""Smoke run of the PyTorch / CUDA port (``gpann_tpu_torch``) on one GPU.

Usage, from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit::

    python3 chip_smoke.py
    python3 chip_smoke.py --profile

The second form stops after the serve phase with the device time of a serve
batch by kernel (``torch.profiler``) and prints no result lines. The first
builds the bin-top-2 kernel from ``gpann_tpu_torch/csrc/``, holds it
against its plain PyTorch version (moderate shapes, shapes its tiling can
get wrong, ties, one tile against fp64 beside a CPU rehearsal of its
split-TF32 arithmetic; two launches must be bit-equal), then drives three
paths at the bench
configuration (8M x 96 points regenerated from seed 555, 4096 queries, k=10,
32 shards, eps 0.05):

1. Serve: the resident serving path on the artifacts the JAX package built
   (``exp_artifacts/bench_8m_gp_cache.npz``: GP partition, a 10,024-point
   router, ground truth) at nprobes=1 with top-32 voting, plus the
   brute-force baseline; recall is checked against the shipped ground truth
   and recall curve.
2. Cold build: the port builds every artifact itself on the card, as the
   bench's cold path does (``bench.py:189-241``) — ground truth through
   kernel B2, the GP partition of a 1M subsample extended to all points,
   and a k-means-tree router trained on a 2M subsample — then serves from
   them and checks them against the shipped ones.
3. Query attribution: the paper's experiment pipeline through the port's
   CLIs on the first 1024 queries, as ``exp_scripts/qa_ogp_8m.py`` runs it:
   an overlapping cover of the shipped GP partition (overlap 0.2, centroid
   method, streamed), the O* partitioners on a 100k prefix
   (``cli.partition``), ``cli.query_attribution`` (fresh ground truth through
   kernel B2, router budget 40k, the 9-step in-shard sweep, the 19-column
   CSV and its Pareto front), ``cli.oracle_recall`` and
   ``cli.small_scale_queries`` on the shipped partition. The inputs are
   written as ``.fbin`` into a temporary directory that is removed at the
   end.

Kernel times are CUDA-event times; build stages are wall seconds with a
CUDA synchronisation at each stage end. Any failed check raises, so the exit
code is non-zero; there is no CPU fallback.

The last line is ``{"ok": true, "device": {...}}``; two lines before it one
JSON object lists each kernel entry point with its launches, its error
against the plain version, its times, its bound (``scan_bounds``) and the
TFLOP/s it reached.
"""

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(REPO, "exp_artifacts", "bench_8m_gp_cache.npz")
N, D, NQ, SHARDS, K = 8_000_000, 96, 4096, 32, 10
SEED = 555
VOTING_T = 32
QUERY_BLOCK = 128
NPROBES = 1
DEVICE = "cuda:0"
# kernel vs plain: the kernel's product is three TF32 tensor-core products
# (~21 bits kept), its norms fp32, summed in another order than the plain
# version's; errors are a few ulp of terms up to ~1e3 (|q|^2 + |x|^2 at the
# bench data)
RTOL, ATOL = 1e-4, 1e-3
# the card's published peaks (H100 SXM data sheet, 700 W): device memory,
# TF32 tensor cores (dense), fp32 outside the tensor cores
PEAK_BYTES, PEAK_TF32, PEAK_FP32 = 3.35e12, 495e12, 67e12
# the fastest route that holds the tolerance above: three TF32 products
PEAK_SPLIT = PEAK_TF32 / 3
RECALL_SLACK = 0.002
# cold build at the bench's settings (bench.py:49-53,189-241)
EPS = 0.05
BUILD_SUBSAMPLE = 1_000_000   # GP graph on this many points
BUILD_AGGREGATES = 4096
GRAPH_DEGREE = 10
ROUTER_SUBSAMPLE = 2_000_000  # router trained on this many points ...
ROUTER_SEED = SEED + 1        # ... drawn with this seed
ROUTER_CENTROIDS = 32
ROUTER_BUDGET = 10_000
GT_RECALL_MIN = 0.9999        # fresh GT ids against the shipped kth distance
GT_KTH_RTOL = 1e-4
BUILD_SERVE_SLACK = 0.01      # fresh serve recall >= shipped curve[0] - this
# query attribution at the settings of exp_scripts/qa_ogp_8m.py
QA_NQ = 1024
QA_OVERLAP = 0.2
QA_REP_SUBSAMPLE = 2_000_000  # cover representatives from this many points,
QA_REP_SEED = SEED + 3        # drawn with this seed,
QA_REPS_PER_SHARD = 64        # 64 per shard
# router budgets: qa_ogp_8m.py sweeps 40000 and 400000; the 400k router
# is cut to keep the phase short (PERF.md, section 6)
QA_BUDGETS = "40000"
QA_PREFIX = 100_000           # rows the O* partitioners run on
QA_METHODS = ("OGP", "OKM")
QA_ORACLE_SLACK = 0.002       # CSV recall <= a route's oracle curve + this
QA_ORACLE_PROBES = (1, 2, 4, 32)
QA_SMALL_BRUTE_MIN = 0.999    # small-scale BruteForce recall at 32 probes
QA_FREE_BYTES = 12 << 30      # scratch space the phase needs
SOURCE = "gpann_tpu_torch/csrc/bintop2.cu"
REPLACES = {
    "binmin_scan": "gpann_tpu/search/pallas_scan.py:39",      # _bintop2_kernel
    "bintop2_blocks": "gpann_tpu/search/pallas_scan.py:271",  # _bintop2_blocks_kernel
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_bins(got, want, queries, base, row_base, metric: str,
                 id_rows=None) -> float:
    """Check kernel summaries ``got`` against the plain version's ``want``:
    the same +inf pattern, finite minima within tolerance, and every finite
    entry's id (in the first ``id_rows`` rows; all by default) pointing at a
    row whose plain distance is the reported minimum. Returns the largest
    absolute error of the minima."""
    (gm, gi), (wm, _) = got, want
    fin = torch.isfinite(wm)
    assert torch.equal(fin, torch.isfinite(gm)), "+inf pattern differs"
    torch.testing.assert_close(gm[fin], wm[fin], rtol=RTOL, atol=ATOL)
    err = float((gm[fin] - wm[fin]).abs().max()) if fin.any() else 0.0
    # ids: recompute each finite entry's distance from its row, in chunks
    step = max(1, (1 << 27) // (gm.shape[1] * base.shape[1]))
    for r0 in range(0, id_rows or gm.shape[0], step):
        sl = slice(r0, min(r0 + step, id_rows or gm.shape[0]))
        q = queries[sl]
        rows = gi[sl].long() + row_base[sl, None]
        f = fin[sl]
        cand = base[rows.clamp(0, base.shape[0] - 1)]          # [r, 2L, d]
        dots = torch.einsum("rd,rcd->rc", q, cand)
        if metric == "mips":
            dist = 1.0 - dots
        else:
            dist = ((q * q).sum(1)[:, None] + (cand * cand).sum(2) - 2.0 * dots)
        torch.testing.assert_close(dist[f], gm[sl][f], rtol=RTOL, atol=ATOL)
    return err


def scan_bounds(d: int, qb: int, cap: int, row_off, sizes, live_q) -> dict:
    """The least time the card could take for one bin-top-2 scan of these
    inputs. Operations: 2 * live_q[b] * sizes[b] * d summed over the blocks,
    ``live_q[b]`` being the rows of block ``b`` that hold a real query (a
    serving block is padded up to ``qb`` rows; padding rows, dead blocks and
    dead base rows count nothing). Bytes: each distinct live base window
    once, the live blocks' real query rows once, both summary arrays (every
    row of every block is written) once."""
    sizes = sizes.clamp(0, cap).long()
    live = sizes > 0
    live_q = live_q.long() * live
    ops = 2.0 * int((live_q * sizes).sum()) * d
    windows = torch.zeros(int(row_off.max()) + 1, dtype=torch.int64,
                          device=sizes.device)
    windows.scatter_reduce_(0, row_off[live].long(), sizes[live], "amax")
    nbytes = 4.0 * d * (int(windows.sum()) + int(live_q.sum()))
    nbytes += 2.0 * 4 * sizes.shape[0] * qb * 2 * (cap // 128)
    t_ops, t_fma, t_bytes = ops / PEAK_SPLIT, ops / PEAK_FP32, nbytes / PEAK_BYTES
    return {"ops": ops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "fp32_fma_bound_ms": 1e3 * max(t_fma, t_bytes)}


def check_first_tile(dev, pts: np.ndarray, q: np.ndarray) -> None:
    """One [128 x 128 x d] tile of the bench data: the kernel's bin top-2
    against fp64, beside the CPU rehearsal of its arithmetic (hi rounded to
    nearest, as the kernel splits, and hi cut, what a tensor core that drops
    the low 13 bits would make of raw fp32 words)."""
    from gpann_tpu_torch.search import bin_scan as bs

    qt = torch.from_numpy(q[:128]).to(dev)
    bt = torch.from_numpy(pts[:128]).to(dev)
    q64, b64 = qt.double(), bt.double()
    for metric in ("l2", "mips"):
        if metric == "mips":
            d64 = 1.0 - q64 @ b64.T
        else:
            d64 = ((q64 * q64).sum(1)[:, None] + (b64 * b64).sum(1)[None, :]
                   - 2.0 * q64 @ b64.T)
        want = torch.topk(d64, 2, dim=1, largest=False).values.T.reshape(-1)

        def err(mins):
            return float((mins.T.reshape(-1).double() - want).abs().max())

        km, _ = bs.binmin_scan(qt, bt, 128, metric)
        torch.cuda.synchronize()
        errs = {"kernel": err(km), "plain fp32": err(
            bs.binmin_scan_plain(qt, bt, 128, metric)[0])}
        for rounding in ("nearest", "truncate"):
            for passes in (3, 1):
                em, _ = bs.binmin_scan_plain(
                    qt, bt, 128, metric,
                    dots_fn=lambda a, b: bs.split_tf32_dots(a, b, rounding, passes))
                errs[f"rehearsal {rounding} x{passes}"] = err(em)
        log(f"first tile {metric} [128 x 128 x {bt.shape[1]}], max |top-2 "
            "distance - fp64|: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        limit = ATOL + RTOL * float(want.abs().max())
        assert errs["kernel"] <= limit, (errs, limit)
    log("the kernel zeroes the low 13 bits of hi and lo itself, so its result "
        "does not depend on how wgmma reads an fp32 word")


def _ragged_case(dev, name: str, nb: int, qb: int, cap: int, d: int, sizes,
                 row_off, rows: int, metric: str) -> None:
    """One bintop2_blocks call on random data against the plain version.
    Windows may run past the base's last row (the plain version gets a
    zero-padded copy; those rows are dead)."""
    from gpann_tpu_torch.search import bin_scan as bs

    g = torch.Generator(device=dev).manual_seed(SEED)
    base = 2.0 * torch.randn((rows, d), device=dev, generator=g)
    q = 2.0 * torch.randn((nb * qb, d), device=dev, generator=g)
    ro = torch.tensor(row_off, dtype=torch.int64, device=dev)
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    got = bs.bintop2_blocks(q, base, ro, sz, qb, cap, metric)
    again = bs.bintop2_blocks(q, base, ro, sz, qb, cap, metric)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]), (
        name, "two launches differ")
    padded = torch.cat([base, base.new_zeros((cap, d))])
    want = bs.bintop2_blocks_plain(q, padded, ro, sz, qb, cap, metric)
    err = compare_bins(got, want, q, padded, ro.repeat_interleave(qb), metric)
    dead = ~torch.isfinite(got[0])
    first = (128 * torch.arange(cap // 128, device=dev)).repeat(2)[None, :]
    first = first * (sz.repeat_interleave(qb) > 0)[:, None]
    assert torch.equal(got[1][dead], first.expand_as(got[1])[dead].int()), (
        name, "+inf entries do not carry their bin's first row")
    log(f"kernel vs plain, {name}: {nb} blocks x {qb} q, cap {cap}, d {d}, "
        f"{metric}: max_abs_err {err:.3e}, repeatable ok")


def check_ragged(dev) -> None:
    """Shapes the kernel's tiling can get wrong."""
    from gpann_tpu_torch.search import bin_scan as bs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(SEED)
    many = 2 * sms + 37
    cases = [
        # d % 32 != 0, qb % 64 != 0, an empty block, a 77-row window
        ("d 100, qb 96", 3, 96, 1280, 100, [1280, 0, 77], [1280, 0, 2000], 2560, "l2"),
        # d % 4 != 0 (padded copy), tiny qb, a 5-row window, 1279 of 1280 live
        ("d 17, qb 8", 3, 8, 1280, 17, [1280, 5, 1279], [0, 640, 1000], 2280, "mips"),
        ("d 8", 1, 64, 512, 8, [500], [0], 512, "l2"),
        # sizes == cap; a window that ends at the base's last row; one whose
        # cap runs past it
        ("sizes == cap, windows at the base's end", 3, 300, 2560, 96,
         [2560, 1300, 1000], [140, 0, 1700], 2700, "l2"),
        # d > 160: the query tile travels with the base boxes
        ("d 200 (streamed query tile)", 2, 130, 1280, 200, [1280, 700],
         [0, 1280], 2560, "l2"),
        ("d 160", 2, 130, 1280, 160, [1280, 700], [0, 1280], 2560, "mips"),
        (f"{many} blocks > 2 x {sms} SMs", many, 16, 640, 24,
         rng.integers(0, 641, many).tolist(), rng.integers(0, 5000, many).tolist(),
         5640, "l2"),
    ]
    for case in cases:
        _ragged_case(dev, *case)
    # ties: duplicated base rows in one bin; both ids, the lower first
    g = torch.Generator(device=dev).manual_seed(SEED)
    base = torch.randn((256, D), device=dev, generator=g)
    base[7] = base[3]
    base[100] = base[3]
    base[200] = base[130]
    q = base[[3, 130]].repeat(64, 1).contiguous()
    for metric in ("l2", "mips"):
        m, a = bs.binmin_scan(q, base, 256, metric)
        torch.cuda.synchronize()
        assert a[0, 0] == 3 and a[0, 2] == 7, a[0]
        assert a[1, 1] == 130 and a[1, 3] == 200, a[1]
        assert m[0, 0] == m[0, 2] and m[1, 1] == m[1, 3], m[:2]
    log("ties (duplicated rows in a bin): both ids reported, the lower first ok")


def time_template_instances(dev, tag: str) -> None:
    """The kernel's two template instances at one size, on random data: the
    query tile resident in shared memory (d <= 160) and travelling with the
    base boxes (d > 160, the instance for which ptxas reports spills)."""
    from gpann_tpu_torch.search import bin_scan as bs

    rows = 1_000_000
    g = torch.Generator(device=dev).manual_seed(SEED)
    for d in (96, 160, 200):
        base = torch.randn((rows, d), device=dev, generator=g)
        q = torch.randn((NQ, d), device=dev, generator=g)
        ms = cuda_ms(lambda: bs.binmin_scan(q, base, rows), reps=5)
        log(f"binmin_scan [{NQ} x {rows} x {d}], query tile "
            f"{'resident' if d <= 160 else 'streamed'}: {ms:.3f} ms, "
            f"{2.0 * NQ * rows * d / ms * 1e-9:.1f} TFLOP/s {tag}")


def profile_serve(engine, q_dev, tag: str, batches: int = 5) -> None:
    """Device time of a serve batch by kernel, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    def batch():
        return engine.serve_device(q_dev, K, NPROBES, voting_t=VOTING_T,
                                   query_block=QUERY_BLOCK)

    ms = cuda_ms(batch, reps=10, warmup=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            batch()
        torch.cuda.synchronize()
    # device-side entries only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / batches / 1e3, e.count // batches)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"serve {ms:.3f} ms/batch of {NQ} (CUDA events, unprofiled); device "
        f"busy {busy:.3f} ms a profiled batch, {sum(r[2] for r in rows)} "
        f"kernels and copies a batch {tag}")
    for key, per_batch, count in rows[:14]:
        log(f"  {per_batch:8.3f} ms  x{count:<3d} {key[:100]}")


def check_kernels(dev) -> None:
    """Kernel vs plain at moderate shapes, for both entry points and metrics."""
    from gpann_tpu_torch.search import bin_scan as bs

    rng = np.random.default_rng(SEED)
    base = torch.from_numpy(
        rng.standard_normal((150_001, D)).astype(np.float32)).to(dev)
    qs = torch.from_numpy(rng.standard_normal((500, D)).astype(np.float32)).to(dev)
    n_valid = 149_000
    cap, qb = 20_480, 128
    # four probe blocks: full, empty, partial, partial; windows out of order
    row_off = torch.tensor([2 * cap, 0, cap, 3 * cap], dtype=torch.int64,
                           device=dev)
    sizes = torch.tensor([cap, 0, 7_000, 12_345], dtype=torch.int32, device=dev)
    qblocks = torch.from_numpy(
        rng.standard_normal((4 * qb, D)).astype(np.float32)).to(dev)
    flat = base[: 4 * cap].contiguous()
    zeros = torch.zeros(qs.shape[0], dtype=torch.int64, device=dev)
    for metric in ("l2", "mips"):
        got = bs.binmin_scan(qs, base, n_valid, metric)
        want = bs.binmin_scan_plain(qs, base, n_valid, metric)
        torch.cuda.synchronize()
        err = compare_bins(got, want, qs, base, zeros, metric)
        log(f"kernel vs plain binmin_scan {metric} [{qs.shape[0]} x "
            f"{base.shape[0]} x {D}, n_valid {n_valid}]: max_abs_err {err:.3e} "
            f"(rtol {RTOL}, atol {ATOL}) ok")
        got = bs.bintop2_blocks(qblocks, flat, row_off, sizes, qb, cap, metric)
        want = bs.bintop2_blocks_plain(qblocks, flat, row_off, sizes, qb, cap,
                                       metric)
        torch.cuda.synchronize()
        assert torch.isinf(got[0][qb : 2 * qb]).all(), "empty block not +inf"
        assert (got[1][qb : 2 * qb] == 0).all(), "empty block ids not 0"
        err = compare_bins(got, want, qblocks, flat,
                           row_off.repeat_interleave(qb), metric)
        log(f"kernel vs plain bintop2_blocks {metric} [4 blocks x {qb} q, "
            f"cap {cap}, sizes {sizes.tolist()}]: max_abs_err {err:.3e} ok")


def bench_data():
    """The bench's 8M x 96 points and 4096 queries, drawn as bench.py does."""
    rng = np.random.default_rng(SEED)
    num_blobs = 64
    centers = rng.standard_normal((num_blobs, D)).astype(np.float32) * 2.0
    lbl = rng.integers(0, num_blobs, size=N)
    pts = np.empty((N, D), np.float32)
    for s in range(0, N, 1 << 20):  # chunked draws equal one monolithic draw
        e = min(s + (1 << 20), N)
        pts[s:e] = centers[lbl[s:e]] + 0.6 * rng.standard_normal((e - s, D))
    q = (centers[rng.integers(0, num_blobs, size=NQ)]
         + 0.6 * rng.standard_normal((NQ, D))).astype(np.float32)
    return pts, q


def check_small_engine(dev) -> None:
    """The engine on the GPU against the same engine on the CPU (plain)."""
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.search.serve import ServingEngine

    rng = np.random.default_rng(11)
    pts = rng.standard_normal((40_000, 16)).astype(np.float32)
    q = rng.standard_normal((64, 16)).astype(np.float32)
    clusters = partition_to_clusters(rng.integers(0, 3, size=len(pts)), 3)
    rsel = rng.choice(len(pts), size=600, replace=False)
    lbl = np.empty(len(pts), np.int32)
    for b, c in enumerate(clusters):
        lbl[c] = b
    outs = []
    for device in ("cpu", dev):
        eng = ServingEngine(pts, clusters, pts[rsel], lbl[rsel],
                            scan_mode="binned", voting_impl="binned",
                            device=device)
        outs.append(eng.serve(q, k=10, nprobes=2, voting_t=8, query_block=32))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-4, atol=1e-4)
    log("small engine (40k x 16, 3 shards, binned scan + binned voting): "
        "GPU distances match the CPU plain path at 1e-4 ok")


def cold_build(dev, pts: np.ndarray, q: np.ndarray, shipped: dict,
               tag: str) -> dict:
    """Build ground truth, the GP partition and the router on ``dev`` from
    the raw points, serve from them, and check them against the ``shipped``
    artifacts (``gt_ids``, ``gt_dists``, ``assign``, ``curve`` and
    ``first_probe``, the shipped engine's first probe per query). Returns
    the kernel launches of this path."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.core.distances import chunked_topk_neighbors
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.eval.recall import (
        compute_ground_truth,
        kth_neighbor_distance,
        max_first_shard_routing_recall,
        oracle_recall,
        recall_from_ids,
        verify_ground_truth,
    )
    from gpann_tpu_torch.gp.scale import subsample_gp_partition
    from gpann_tpu_torch.route import KMeansTreeRouter, KMeansTreeRouterOptions
    from gpann_tpu_torch.search.serve import ServingEngine

    n = len(pts)
    secs = {}

    def stage(name: str, t0: float) -> None:
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"cold build: {name} {secs[name]:.3f} s {tag}")

    kernels.reset_launches()
    # ---- 1. ground truth through kernel B2 ----
    t0 = time.perf_counter()
    gt_ids, gt_dists = compute_ground_truth(pts, q, K, device=dev)
    stage("ground truth", t0)
    assert kernels.LAUNCHES["binmin_scan"] > 0, kernels.LAUNCHES
    assert gt_ids.shape == (len(q), K) and np.isfinite(gt_dists).all()
    kth_shipped = kth_neighbor_distance(shipped["gt_dists"], K)
    kth = kth_neighbor_distance(gt_dists, K)
    gt_recall = recall_from_ids(pts, q, gt_ids, kth_shipped, K)
    log(f"fresh GT recall@10 against the shipped GT {gt_recall:.6f} (need >= "
        f"{GT_RECALL_MIN})")
    assert gt_recall >= GT_RECALL_MIN, gt_recall
    # kth distances agree within GT_KTH_RTOL, except where the shipped GT
    # (the TPU's bin-top-2 scan) missed a neighbour: there the fresh kth is
    # smaller, and an exact scan of those queries must confirm the fresh GT
    rel = (kth - kth_shipped) / np.abs(kth_shipped)
    off = np.nonzero(np.abs(rel) > GT_KTH_RTOL)[0]
    assert (rel[off] < 0).all(), rel[off]
    if len(off):
        _, exact_ids = chunked_topk_neighbors(q[off], pts, K, device=dev)
        _, exact_d = verify_ground_truth(pts, q[off], exact_ids,
                                         np.full(exact_ids.shape, np.nan))
        np.testing.assert_allclose(gt_dists[off], exact_d, rtol=GT_KTH_RTOL)
    log(f"fresh kth distance within rtol {GT_KTH_RTOL} of the shipped one for "
        f"{len(q) - len(off)} of {len(q)} queries; for the other {len(off)} "
        f"the shipped GT missed a neighbour (fresh kth smaller by up to "
        f"{-rel[off].min() if len(off) else 0.0:.3e} relative) and an exact "
        "scan of those queries matches the fresh GT")

    # ---- 2. GP partition: kNN graph + LP on a subsample, stream-assign ----
    t0 = time.perf_counter()
    assign = subsample_gp_partition(
        pts, k=SHARDS, eps=EPS, seed=SEED, num_subsample=BUILD_SUBSAMPLE,
        num_aggregate=BUILD_AGGREGATES, degree=GRAPH_DEGREE, device=dev)
    stage("partition", t0)
    sizes = np.bincount(assign, minlength=SHARDS)
    limit = int((1 + EPS) * np.ceil(n / SHARDS))
    log(f"fresh partition: {SHARDS} parts, largest {sizes.max()}, smallest "
        f"{sizes.min()} (limit {limit})")
    assert assign.min() >= 0 and len(sizes) == SHARDS and sizes.max() <= limit
    oracle_fresh = oracle_recall(gt_ids, partition=assign, num_shards=SHARDS)[0]
    oracle_shipped = oracle_recall(gt_ids, partition=shipped["assign"],
                                   num_shards=SHARDS)[0]
    log(f"oracle recall@10 at 1 probe: fresh {oracle_fresh:.5f}, shipped "
        f"{oracle_shipped:.5f}")

    # ---- 3. k-means-tree router on a subsample (bench.py:225-241) ----
    t0 = time.perf_counter()
    sub = np.sort(np.random.default_rng(ROUTER_SEED).choice(
        n, size=min(ROUTER_SUBSAMPLE, n), replace=False))
    router = KMeansTreeRouter(device=dev).train(
        pts[sub], partition_to_clusters(assign[sub], SHARDS),
        KMeansTreeRouterOptions(num_centroids=ROUTER_CENTROIDS,
                                budget=ROUTER_BUDGET), seed=SEED)
    routing_points, routing_labels = router.extract_points()
    stage("router", t0)
    log(f"fresh router: {len(routing_points)} routing points (shipped "
        f"{len(shipped['routing_points'])})")

    # ---- 4. serve from the fresh artifacts ----
    t0 = time.perf_counter()
    engine = ServingEngine(pts, partition_to_clusters(assign, SHARDS),
                           routing_points, routing_labels, scan_mode="binned",
                           voting_impl="exact", scan_phase2="exact", device=dev)
    stage("engine", t0)
    t0 = time.perf_counter()
    q_dev = torch.from_numpy(q).to(dev)
    sd, si = engine.serve(q_dev, K, NPROBES, voting_t=VOTING_T,
                          query_block=QUERY_BLOCK)
    stage("serve", t0)
    launches = dict(kernels.LAUNCHES)
    log(f"launches on the cold-build path (GT + serve): {launches}")
    assert all(v > 0 for v in launches.values()), launches
    assert sd.shape == (len(q), K) and np.isfinite(sd).all()
    serve_recall = recall_from_ids(pts, q, si, kth, K)
    ref = float(shipped["curve"][0])
    log(f"fresh serve recall@10 nprobes={NPROBES} {serve_recall:.5f} against "
        f"the fresh GT (shipped curve {ref:.5f}; need >= "
        f"{ref - BUILD_SERVE_SLACK:.5f})")
    assert serve_recall >= ref - BUILD_SERVE_SLACK
    first = engine.probe_order(q_dev, 1, voting_t=VOTING_T)
    log(f"max first-shard routing recall: fresh "
        f"{max_first_shard_routing_recall(gt_ids, first, assign):.5f}, shipped "
        f"{max_first_shard_routing_recall(gt_ids, shipped['first_probe'], shipped['assign']):.5f}")
    curve = engine.recall_curve(q_dev, K, kth, voting_t=VOTING_T,
                                query_block=QUERY_BLOCK)
    log("fresh recall curve:   " + " ".join(f"{p + 1}:{r:.5f}"
                                            for p, r in enumerate(curve)))
    log("shipped recall curve: " + " ".join(
        f"{p + 1}:{r:.5f}" for p, r in enumerate(shipped["curve"])))
    log("cold build stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items())
        + f"; total {sum(secs.values()):.3f} {tag}")
    return launches


def _qa_csv_recalls(path: str):
    """Recall of each (route, ef_search, nprobes) of a query-attribution CSV,
    and its row count. A route is keyed (routing query, routing index,
    voting points, routing index size); recall does not depend on the host
    count."""
    rec = {}
    with open(path) as f:
        assert len(f.readline().strip().split(",")) == 19
        rows = 0
        for line in f:
            c = line.rstrip("\n").split(",")
            assert len(c) == 19, c
            rows += 1
            rec[((c[2], c[3], int(c[5]), int(c[16])), int(c[4]),
                 int(c[7]))] = float(c[8])
    return rec, rows


def _assert_monotone(values, what: str) -> None:
    assert all(b >= a for a, b in zip(values, values[1:])), (what, values)


def query_attribution(dev, pts: np.ndarray, q: np.ndarray, shipped: dict,
                      tag: str) -> dict:
    """The query-attribution pipeline through the port's CLIs on ``dev``
    (module docstring, path 3). ``shipped`` holds the shipped ``assign``
    and ``gt_dists``. Returns the kernel launches of this path."""
    import shutil
    import tempfile

    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.cli import oracle_recall, small_scale_queries
    from gpann_tpu_torch.cli import partition as partition_cli
    from gpann_tpu_torch.cli import query_attribution as qa_cli
    from gpann_tpu_torch.core.metis_io import read_clusters, write_clusters
    from gpann_tpu_torch.core.partition import (clusters_to_cover_csr,
                                                partition_to_clusters)
    from gpann_tpu_torch.core.pointset import read_ground_truth, write_points
    from gpann_tpu_torch.eval.combination import deserialize_routes
    from gpann_tpu_torch.eval.recall import kth_neighbor_distance, recall_from_ids
    from gpann_tpu_torch.gp.overlap import (
        apply_extra_assignments,
        centroid_overlap_streamed,
    )
    from gpann_tpu_torch.gp.scale import gp_aggregates
    from gpann_tpu_torch.search import bin_scan as bs

    n = len(pts)
    q = q[:QA_NQ]
    dev_arg = ["--device", str(dev)]
    secs = {}

    def stage(name: str, t0: float) -> None:
        secs[name] = time.perf_counter() - t0
        log(f"query attribution: {name} {secs[name]:.3f} s {tag}")

    scratch = tempfile.mkdtemp(prefix="gpann_qa_")
    free = shutil.disk_usage(scratch).free
    log(f"query attribution: scratch {scratch}, {free / 2**30:.1f} GiB free")
    try:
        assert free >= QA_FREE_BYTES, f"needs {QA_FREE_BYTES >> 30} GiB free"
        path = lambda name: os.path.join(scratch, name)  # noqa: E731
        base_f, query_f, gt_f = path("base.fbin"), path("queries.fbin"), path("gt.bin")

        # ---- 1. inputs ----
        t0 = time.perf_counter()
        write_points(base_f, pts)
        write_points(query_f, q)
        assign = shipped["assign"]
        gp_f = path(f"bench.k={SHARDS}.GP")
        write_clusters(gp_f, partition_to_clusters(assign, SHARDS))
        stage("write inputs", t0)

        # ---- 2. overlapping cover of the shipped GP partition ----
        t0 = time.perf_counter()
        rng = np.random.default_rng(QA_REP_SEED)
        sub = np.sort(rng.choice(n, size=min(QA_REP_SUBSAMPLE, n // 2),
                                 replace=False))
        reps, rep_lbl = gp_aggregates(pts[sub], assign[sub], SHARDS,
                                      QA_REPS_PER_SHARD * SHARDS, seed=SEED,
                                      device=dev)
        cap2 = int((1.0 + EPS) * (1.0 + QA_OVERLAP) * n / SHARDS)
        ep, ec = centroid_overlap_streamed(
            pts, assign, reps, rep_lbl, SHARDS, cap2, int(QA_OVERLAP * n),
            device=dev)
        cover = apply_extra_assignments(partition_to_clusters(assign, SHARDS),
                                        ep, ec)
        cover_f = path(f"bench.k={SHARDS}.OGP.o={QA_OVERLAP}")
        write_clusters(cover_f, cover)
        stage("overlap cover", t0)
        sizes = np.asarray([len(c) for c in cover])
        log(f"overlap cover: {len(reps)} representatives, {sizes.sum()} "
            f"assignments of {n} points, largest cluster {sizes.max()} "
            f"(cap {cap2}), smallest {sizes.min()}")
        assert sizes.max() <= cap2 and n <= sizes.sum() <= (1 + QA_OVERLAP) * n
        del cover, ep, ec

        # ---- 3. the O* partitioners on a prefix, through the CLI ----
        prefix = min(QA_PREFIX, n)
        bound = int((1.0 + EPS) * prefix / SHARDS)
        for method in QA_METHODS:
            t0 = time.perf_counter()
            assert partition_cli.main(
                [base_f, path("prefix"), str(SHARDS), method, str(QA_OVERLAP),
                 "l2", str(prefix)] + dev_arg) == 0
            stage(f"partition {method}", t0)
            got = read_clusters(path(f"prefix.k={SHARDS}.{method}.o={QA_OVERLAP}"))
            sizes = np.asarray([len(c) for c in got])
            covered = len(np.unique(np.concatenate(got)))
            log(f"{method} on {prefix} rows: {len(got)} clusters, largest "
                f"{sizes.max()} (bound {bound}), {sizes.sum()} assignments, "
                f"{covered} points covered")
            assert sizes.max() <= bound and covered == prefix
            assert sizes.sum() <= prefix + int(QA_OVERLAP * prefix)

        # ---- 4. query attribution (ground truth through kernel B2) ----
        out = path("qa")
        kernels.reset_launches()
        t0 = time.perf_counter()
        assert qa_cli.main([base_f, query_f, gt_f, str(K), cover_f,
                            str(SHARDS), out, "OGP", "l2", QA_BUDGETS]
                           + dev_arg) == 0
        stage("query attribution CLI", t0)
        launches = dict(kernels.LAUNCHES)
        log(f"launches on the query-attribution path: {launches}")
        assert launches["binmin_scan"] > 0, launches
        # kernel B2 against its plain version at the shape the GT scan gave it
        q_dev, base = (torch.from_numpy(x).to(dev) for x in (q, pts))
        zeros = torch.zeros(len(q), dtype=torch.int64, device=dev)
        err = compare_bins(bs.binmin_scan(q_dev, base, n),
                           bs.binmin_scan_plain(q_dev, base, n), q_dev, base,
                           zeros, "l2", id_rows=256)
        log(f"kernel vs plain binmin_scan l2 [{len(q)} x {n} x {pts.shape[1]}] "
            f"(the QA ground truth's shape): max_abs_err {err:.3e} (rtol "
            f"{RTOL}, atol {ATOL}) ok")
        del q_dev, base, zeros
        torch.cuda.empty_cache()
        gt_ids, _ = read_ground_truth(gt_f)
        kth_shipped = kth_neighbor_distance(shipped["gt_dists"], K)[:QA_NQ]
        gt_recall = recall_from_ids(pts, q, gt_ids[:, :K], kth_shipped, K)
        log(f"fresh GT recall@10 against the shipped GT on {QA_NQ} queries "
            f"{gt_recall:.6f} (need >= {GT_RECALL_MIN})")
        assert gt_recall >= GT_RECALL_MIN
        for ext in ("routes", "searches", "csv", "pareto"):
            assert os.path.getsize(f"{out}.{ext}") > 0, ext
        rec, rows = _qa_csv_recalls(out + ".csv")
        pareto = sum(1 for _ in open(out + ".pareto")) - 1
        routes = sorted({key for key, _, _ in rec})
        efs = sorted({ef for _, ef, _ in rec})
        probes = sorted({p for _, _, p in rec})
        for key in routes:
            for ef in efs:
                _assert_monotone([rec[(key, ef, p)] for p in probes],
                                 (key, "ef", ef))
            for p in probes:
                _assert_monotone([rec[(key, ef, p)] for ef in efs],
                                 (key, "nprobes", p))
        best = max(rec.values())
        log(f"query attribution CSV: {rows} rows, {pareto} Pareto rows, "
            f"{len(routes)} routes x ef_search {efs} x {len(probes)} nprobes; "
            f"recall monotone in nprobes and in ef_search; highest recall "
            f"{best:.5f}")

        # ---- 5. oracle recall: the CLI, and every route's curve ----
        t0 = time.perf_counter()
        assert oracle_recall.main([gt_f, out + ".routes", str(K), cover_f,
                                   "OGP", path("oracle.csv")]) == 0
        csr = clusters_to_cover_csr(read_clusters(cover_f), n)
        gaps = {p: [] for p in QA_ORACLE_PROBES}
        for r in deserialize_routes(out + ".routes"):
            key = (r.routing_algorithm, r.index_trainer,
                   r.hnsw_num_voting_neighbors, r.index_size_bytes)
            curve = oracle_recall.recall_for_increasing_probes(
                list(r.buckets_to_probe), csr, gt_ids, K, SHARDS)
            for p in QA_ORACLE_PROBES:
                for ef in efs:
                    assert rec[(key, ef, p)] <= curve[p - 1] + QA_ORACLE_SLACK, (
                        key, ef, p, rec[(key, ef, p)], curve[p - 1])
                gaps[p].append(curve[p - 1] - rec[(key, efs[-1], p)])
        stage("oracle recall", t0)
        log(f"CSV recall <= oracle + {QA_ORACLE_SLACK} for every route, "
            f"nprobes {QA_ORACLE_PROBES}, ef_search; oracle - CSV recall at "
            f"ef_search {efs[-1]}: " + ", ".join(
                f"nprobes {p} mean {np.mean(g):.5f} max {np.max(g):.5f}"
                for p, g in gaps.items()))

        # ---- 6. small-scale queries on the shipped GP partition ----
        t0 = time.perf_counter()
        ss_csv = path("small_scale.csv")
        assert small_scale_queries.main([base_f, query_f, gt_f, str(K), gp_f,
                                         ss_csv, "GP"] + dev_arg) == 0
        stage("small scale CLI", t0)
        curves = {}
        with open(ss_csv) as f:
            f.readline()
            for line in f:
                c = line.strip().split(",")
                curves.setdefault((c[1], c[2]), []).append(
                    (int(c[3]), float(c[7])))
        for (router, engine), curve in curves.items():
            curve.sort()
            _assert_monotone([r for _, r in curve], (router, engine))
            log(f"small scale {router} {engine}: recall@10 " + " ".join(
                f"{p}:{r:.5f}" for p, r in curve if p in (1, 2, 4, 8, 32)))
            if engine == "BruteForce":
                assert curve[-1] == (SHARDS, curve[-1][1])
                assert curve[-1][1] >= QA_SMALL_BRUTE_MIN, curve[-1]
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    log("query attribution stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items())
        + f"; total {sum(secs.values()):.3f} {tag}")
    return launches


def main(profile_only: bool = False) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a GPU")
    t_start = time.perf_counter()
    gpu = card()
    log(gpu)
    tag = f"[{gpu}]"
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    dev = torch.device(DEVICE)
    logging.basicConfig(level=logging.WARNING, stream=sys.stdout,
                        format="%(name)s: %(message)s")
    logging.getLogger("gpann_tpu_torch").setLevel(logging.INFO)

    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.eval.recall import kth_neighbor_distance, recall_from_ids
    from gpann_tpu_torch.search import bin_scan as bs
    from gpann_tpu_torch.search.serve import ServingEngine

    # ---- build ----
    path, secs, ptxas = kernels.build()
    log(f"built {os.path.relpath(path, REPO)} in {secs:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    kernels.library()

    # ---- kernel vs plain at moderate shapes ----
    check_kernels(dev)
    check_ragged(dev)
    time_template_instances(dev, tag)
    check_small_engine(dev)

    # ---- main path at full size ----
    t0 = time.perf_counter()
    pts, q = bench_data()
    art = dict(np.load(ARTIFACT))
    log(f"bench data regenerated ({N} x {D}, {NQ} queries) in "
        f"{time.perf_counter() - t0:.1f} s")
    kth = kth_neighbor_distance(art["gt_dists"], K)
    clusters = partition_to_clusters(art["assign"].astype(np.int32), SHARDS)
    ref_curve = art["curve"].astype(np.float64)
    q_dev = torch.from_numpy(q).to(dev)
    base = torch.from_numpy(pts).to(dev)
    check_first_tile(dev, pts, q)

    kernels.reset_launches()
    bd, bi = bs.fused_topk(q_dev, base, N, K)
    engine = ServingEngine(pts, clusters, art["routing_points"],
                           art["routing_labels"], scan_mode="binned",
                           voting_impl="exact", scan_phase2="exact", device=dev)
    sd, si = engine.serve(q_dev, K, NPROBES, voting_t=VOTING_T,
                          query_block=QUERY_BLOCK)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"launches on the main path (brute + serve): {launches}")
    assert all(n > 0 for n in launches.values()), launches

    assert bd.shape == (NQ, K) and torch.isfinite(bd).all()
    brute_recall = recall_from_ids(pts, q, bi, kth, K)
    log(f"brute recall@10 {brute_recall:.5f} (GT shipped; need >= 0.999)")
    assert brute_recall >= 0.999, brute_recall
    assert sd.shape == (NQ, K) and np.isfinite(sd).all()
    assert ((si >= 0) & (si < N)).all()
    serve_recall = recall_from_ids(pts, q, si, kth, K)
    log(f"serve recall@10 nprobes={NPROBES} {serve_recall:.5f} "
        f"(TPU reference {ref_curve[0]:.5f}; need within {RECALL_SLACK})")
    assert abs(serve_recall - ref_curve[0]) <= RECALL_SLACK
    curve = engine.recall_curve(q_dev, K, kth, voting_t=VOTING_T,
                                query_block=QUERY_BLOCK)
    gap = float(np.abs(curve - ref_curve).max())
    log("recall curve: " + " ".join(f"{p + 1}:{r:.5f}"
                                    for p, r in enumerate(curve)))
    log(f"recall curve max |port - shipped| over 32 prefixes {gap:.5f} "
        f"(need <= {RECALL_SLACK})")
    assert gap <= RECALL_SLACK

    # ---- kernel vs plain at the main path's shapes, and timings ----
    log("library_ms is null for both entries: no single PyTorch call computes "
        "a per-bin top-2")
    stats = {}

    def measure(name: str, shape: str, kernel, plain, product, bounds: dict,
                check, reps: int) -> None:
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]), (
            name, "two launches on the same inputs differ")
        del again
        err = check(got, plain())
        del got
        ms = cuda_ms(kernel, reps=reps)
        plain_ms = cuda_ms(plain, reps=2)
        product_ms = cuda_ms(product, reps=2)
        tflops = bounds["ops"] / ms * 1e-9
        stats[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bounds["bound_ms"], bound_by=bounds["bound_by"],
                           fp32_fma_bound_ms=bounds["fp32_fma_bound_ms"],
                           tflops=tflops, library_ms=None)
        log(f"{name} [{shape}] kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s of "
            f"{bounds['ops']:.4e} operations, {bounds['bytes']:.4e} bytes), "
            f"bound {bounds['bound_ms']:.3f} ms by {bounds['bound_by']} "
            f"(max of ops / {PEAK_SPLIT:.3e} and bytes / {PEAK_BYTES:.3e}), "
            f"fp32-FMA bound {bounds['fp32_fma_bound_ms']:.3f} ms, plain "
            f"{plain_ms:.3f} ms, max_abs_err {err:.3e}, two launches bit-equal "
            f"{tag}")
        log(f"{name}: the product alone, chunked fp32 torch.mm (TF32 off, no "
            f"reduction; not used by the port) {product_ms:.3f} ms {tag}")

    assert not torch.backends.cuda.matmul.allow_tf32
    zeros = torch.zeros(NQ, dtype=torch.int64, device=dev)
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    mm_rows = 1 << 16
    mm_out = torch.empty((NQ, mm_rows), device=dev)

    def brute_product():
        for r0 in range(0, N, mm_rows):
            blk = base[r0 : r0 + mm_rows]
            torch.mm(q_dev, blk.T, out=mm_out[:, : blk.shape[0]])

    # ids are checked on the first 256 queries: the gather is 12 MB a row
    measure("binmin_scan", f"{NQ} x {N} x {D}",
            lambda: bs.binmin_scan(q_dev, base, N),
            lambda: bs.binmin_scan_plain(q_dev, base, N), brute_product,
            scan_bounds(D, NQ, -(-N // 128) * 128, one,
                        torch.full((1,), N, device=dev),
                        torch.full((1,), NQ, device=dev)),
            lambda got, want: compare_bins(got, want, q_dev, base, zeros, "l2",
                                           id_rows=256), reps=3)
    del mm_out

    qrows, row_off, sizes, live_q = engine.scan_inputs(
        q_dev, NPROBES, voting_t=VOTING_T, query_block=QUERY_BLOCK)
    cap = engine.capacity
    scan = (qrows, engine.shard_points, row_off, sizes, QUERY_BLOCK, cap)
    windows = [(b, off, size) for b, (off, size)
               in enumerate(zip(row_off.tolist(), sizes.tolist())) if size > 0]
    mm_out = torch.empty((QUERY_BLOCK, cap), device=dev)

    def serve_product():
        for b, off, size in windows:
            torch.mm(qrows[b * QUERY_BLOCK : (b + 1) * QUERY_BLOCK],
                     engine.shard_points[off : off + size].T,
                     out=mm_out[:, :size])

    measure("bintop2_blocks",
            f"{row_off.shape[0]} blocks x {QUERY_BLOCK} q, cap {cap}, "
            f"{len(windows)} live, {int(sizes.sum())} live rows, "
            f"{int(live_q[sizes > 0].sum())} of {len(windows) * QUERY_BLOCK} "
            "query rows real (the rest pad each shard's last block)",
            lambda: bs.bintop2_blocks(*scan),
            lambda: bs.bintop2_blocks_plain(*scan), serve_product,
            scan_bounds(D, QUERY_BLOCK, cap, row_off, sizes, live_q),
            lambda got, want: compare_bins(
                got, want, qrows, engine.shard_points,
                row_off.repeat_interleave(QUERY_BLOCK), "l2"), reps=10)
    del mm_out

    brute_ms = cuda_ms(lambda: bs.fused_topk(q_dev, base, N, K), reps=3)
    log(f"brute fused_topk {brute_ms:.3f} ms/batch of {NQ} "
        f"({NQ / brute_ms * 1e3:.1f} QPS) {tag}")
    serve_ms = cuda_ms(lambda: engine.serve_device(
        q_dev, K, NPROBES, voting_t=VOTING_T, query_block=QUERY_BLOCK), reps=10)
    log(f"serve {serve_ms:.3f} ms/batch of {NQ} ({NQ / serve_ms * 1e3:.1f} QPS), "
        f"nprobes={NPROBES}, {brute_ms / serve_ms:.2f}x brute {tag}")
    if profile_only:
        profile_serve(engine, q_dev, tag)
        return 0

    # ---- cold build: the port builds the artifacts itself ----
    shipped = {key: art[key] for key in ("gt_ids", "gt_dists", "routing_points")}
    shipped["assign"] = art["assign"].astype(np.int32)
    shipped["curve"] = ref_curve
    shipped["first_probe"] = engine.probe_order(q_dev, 1, voting_t=VOTING_T)
    del engine, base, scan, qrows, row_off, sizes, live_q
    torch.cuda.empty_cache()
    build_launches = cold_build(dev, pts, q, shipped, tag)
    torch.cuda.empty_cache()

    # ---- query attribution through the port's CLIs ----
    qa_launches = query_attribution(dev, pts, q, shipped, tag)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # launches: the serve, cold-build and query-attribution paths' runs
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name],
         "launches": launches[name] + build_launches[name] + qa_launches[name],
         **stats[name]}
        for name in ("binmin_scan", "bintop2_blocks")]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--profile"]):
        raise SystemExit(__doc__)
    sys.exit(main(profile_only=sys.argv[1:] == ["--profile"]))
