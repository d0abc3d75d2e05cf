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
split-TF32 arithmetic; two launches must be bit-equal), then drives twelve
paths at the bench configuration (8M x 96 points regenerated from seed 555,
4096 queries, k=10, 32 shards, eps 0.05):

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
   ``cli.small_scale_queries`` on the shipped partition's part of a 1M
   prefix. The inputs are
   written as ``.fbin`` into a temporary directory that is removed at the
   end.
4. Bench: ``cli.bench --config hard`` on the non-separable ``hard`` mixture
   (8M x 96 generated by ``eval/synth.py``; artifacts
   ``exp_artifacts/hardserve_8m_cache.npz``: a 31,643-point router, top-60
   voting), then ``cli.bench --config blobs`` on the data of path 1. Each
   prints the bench's JSON line; the hard curve is held against the shipped
   one.
5. Streamed: the hard base re-laid shard-major on disk
   (``relayout_to_store``) and served from the host by
   ``StreamedShardEngine``, one launch of kernel B2 per probed shard; its
   curve is held against the resident engine's of path 4, a sliced pass
   against the whole one, and on a small batch the pruned pass on a
   sub-cluster-major store against the same store unpruned and against the
   shard-major store.
6. ``cli.scale_bench`` as a user runs it (16M x 96 ``hard2`` bytes from a
   virtual base, balanced k-means, fused assign + relayout, 64 shards, 1024
   queries), pruned to 4 of each shard's 8192-row sub-clusters, then on its
   own caches without pruning; then ``cli.graph_quality_benchmark``,
   ``cli.analyze_approximation_losses`` and ``cli.extract_recall`` once
   each (after path 9).
7. Multi-rank: the engines of ``gpann_tpu_torch.dist`` on path 1's data and
   artifacts in 2 ranks (dp 1 x shard 2), then 4 (dp 2 x shard 2, routing
   through kernel B2), spawned with a timeout, sharing the card and
   exchanging over gloo; each rank copies only its shards from a
   memory-mapped copy of the points. Recall against path 1's, the probed
   search against ``IVFIndex.search_probed``, a sharded Lloyd round that
   repeats itself, each rank's batch split by step (the recorder's spans),
   B2 against its plain version at the routing shape; then
   ``cli.distributed_bench`` in 2 ranks through ``torch.distributed.run``
   on a 1M-point prefix.
8. MIPS (run right after path 5, on path 4's hard base and queries): A, the
   pipeline of ``exp_scripts/mips_overlap_8m.py`` through the port's
   modules, ground truth under MIPS through kernel B2 (held against a plain
   fp32 top-k), a subsample-GP partition (250k points), a k-means-tree
   router (1M points, budget 40k), a centroid-ranked overlap (0.2, cheapest
   first under a capacity), and the recall curves of two engines, ``gp`` on
   the partition and ``gp_overlap`` on the cover (kernel B1, the merge's id
   dedup), each with the binned and then the exact scan; B,
   ``cli.scale_bench --metric mips`` on a 2M-point virtual ``hard`` base
   (shard-major store, the streamed engine, kernel B2 at each shard).
9. GP at scale (run right after path 6, in its cache directory: the same
   base, ground truth and queries): ``cli.scale_bench --method gp``, the
   configuration of the JAX package's large runs (``exp_outputs/
   scale64m_gp.csv``) at 16M, with a 500k-point GP subsample and 4096
   aggregates; (a) binned, (b) the same store scanned exact, (c) the
   small-batch pruning runs (64 queries, 8 probes, 8192-row sub-clusters,
   whole shards, then the top 4 and top 2 of them). The store holds every
   id once under the capacity, the binned curve lies within 0.002 of the
   exact one, the streamed bytes fall with the sub-clusters read, and the
   probes at recall 0.95 are logged beside path 6's balanced k-means. The
   kNN graph's top-k is timed beside a stable sort first.
10. GP fidelity (run after path 6's analysis CLIs): ``cli.gp_fidelity``, the
   port of ``exp_scripts/gp_fidelity_8m.py``, on a 1M-point ``hard`` base
   (d 96, 4096 queries, 32 shards): ground truth through kernel B2, the
   subsample arm (GP of a 125k subsample extended through 4096
   aggregates, the shipped artifact's 1M of 8M) and the full-graph arm (the
   reference's GP: the kNN graph of every point, then LP), each with a
   k-means-tree router and its routed curve through kernel B1. Both arms
   balanced, every curve non-decreasing, each routed curve at or below its
   oracle curve and at 0.999 or more at the last prefix.
11. Partition quality (after path 10): (a) ``cli.partition_quality``, the
   port of ``exp_scripts/validate_partition_quality.py``, at the script's
   size, uncut: 1M x 96 ``hard``, 16 shards, 1024 queries; ground truth
   through kernel B2, then GP, BalancedKMeans and Random, each with its
   oracle curve and its curves under the single-centroid and the k-means-
   tree router. Every partition balanced and every id in one shard, every
   curve non-decreasing, the oracle 1.0 at 16 probes, each routed curve at
   or below its oracle; the script's claims (GP above BalancedKMeans at
   one probe, oracle and tree-routed; both 0.3 above Random); Random's
   oracle curve within 0.01 of ``exp_outputs/partition_quality_hard.csv``
   and GP's and BalancedKMeans' first probe no more than 0.02 below it.
   (b) every other method through ``cli.partition`` on the same base
   written as ``.fbin``: Pyramid, OurPyramid, KMeans, FlatKMeans and RKM on
   all 1M points, OGPS, OBKM and ORKM at overlap 0.2 on a 100k prefix, each
   read back and held to its balance bound and cover, the five to an
   oracle recall 0.3 above Random's.
12. The served batch split and the T2I-regime MIPS run, at the scripts'
   sizes, uncut: (a) right after path 5, ``cli.serve_tail_profile``, the
   port of ``exp_scripts/serve_tail_profile.py``, on path 4's blobs data
   and the shipped artifacts: one 4096-query batch at nprobes 1 split into
   route, scan (kernel B1 plus bin selection and rescoring) and tail
   (serve - route - scan: grouping, merge, dispatch), each a mean over
   32-batch windows of CUDA events, with its block and padding counts;
   (b) the same split on path 4's hard engine (top-60 votes, 3 probes,
   32 fresh ``hard`` batches); (c) after path 11, ``cli.mips_smoke``, the
   port of ``exp_scripts/mips_smoke.py``: 1M x 96 points with varying
   norms, queries from another distribution, ground truth under MIPS
   through kernel B2, BalancedKMeans under MIPS (16 shards), a MIPS
   k-means-tree router, the binned curve and a serve at recall 0.95
   (kernel B1). Recall within 0.002 of the shipped 0.99873 in (a), the
   block count path 1's; the MIPS curve non-decreasing, 0.995 or more at
   16 probes, no more than 0.02 under ``exp_outputs/mips_smoke.csv`` at
   any prefix and at 0.95 by that file's probe count.

Kernel times are CUDA-event times; build stages are wall seconds with a
CUDA synchronisation at each stage end. Any failed check raises, so the exit
code is non-zero; there is no CPU fallback.

The last line is ``{"ok": true, "device": {...}}``; two lines before it one
JSON object lists each kernel entry point with its launches, its error
against the plain version, its times, its bound (``scan_bounds``) and the
TFLOP/s it reached: first at the shapes of path 1 with the launches of
paths 1-6, then at the shapes paths 5, 4, 7, 8, 9, 10, 11 and 12 give it
with those paths' launches.
"""

import glob
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
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
BUILD_SUBSAMPLE = 1_000_000   # GP graph on this many points (bench.py:49-53)
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
QA_SMALL_PREFIX = 1_000_000   # small-scale queries on this prefix (for time)
QA_FREE_BYTES = 12 << 30      # scratch space the phase needs
# bench, hard mixture (exp_scripts/hard_serve_bench.py)
HARD_ARTIFACT = os.path.join(REPO, "exp_artifacts", "hardserve_8m_cache.npz")
HARD_VOTING_T = 60
HARD_NPROBES_MAX = 3          # the shipped choice
HARD_LAST_PREFIX_MIN = 0.999
BLOBS_SERVE_RECALL = 0.99873  # the shipped curve's first prefix
# streamed engine on the hard base
STREAM_NPROBES = 3
STREAM_SLICE_ROWS = 100_000   # below the largest shard; no multiple of 128
STREAM_SAME_SHARE = 0.999     # entries of two passes equal within tolerance
STREAM_SUB_SIZE = 8192        # rows per sub-cluster of the regrouped store
STREAM_SUB_NPROBE = 4
STREAM_SUB_NQ = 256           # a small batch, where pruning cuts bytes
STREAM_SUB_LOSS = 0.02
# cli.scale_bench as a user runs it; 16M rows fit the script's time
SCALE_N = 16_000_000
SCALE_SHARDS = 64
SCALE_NQ = 1024
SCALE_SUB_NPROBE = 4
SCALE_SUB_SIZE = 8192         # rows per sub-cluster (the CLI's default: 65,536)
SCALE_BALANCE_MAX = 1.05
SCALE_LAST_PREFIX_MIN = 0.999  # all 64 probes, no pruning
SCALE_TARGET = 0.95           # probes at this recall, GP against bkm
# path 9: cli.scale_bench --method gp on path 6's base, ground truth and
# queries; the JAX CLI's 2M-point GP subsample cut for the script's time
SCALE_GP_SUBSAMPLE = 500_000
SCALE_GP_AGGREGATES = 4096
SCALE_GP_BINNED_SLACK = 0.002  # binned curve within this of the exact one
# the small-batch pruning runs (README.md:443-458): 64 queries, 8 probes,
# top-t sub-clusters for t = 0 (whole shards), 4, 2
SCALE_SMALL_NQ = 64
SCALE_SMALL_NPROBES = 8
SCALE_SMALL_SUB = (0, 4, 2)
# one configuration of the graph-quality grid (the full grid is 125)
GQ_GRID = dict(REPS_GRID=(3,), FANOUT_GRID=(3,), CLUSTER_SIZE_GRID=(1000,))
# multi-rank phase: (ranks, dp, voting_impl); the ranks share the card and
# exchange over gloo (NCCL refuses two ranks on one device)
MR_RUNS = ((2, 1, "exact"), (4, 2, "binned"))
MR_MICROBATCH = 128
MR_CHECK_NQ = 256             # queries held against IVFIndex.search_probed
MR_CHECK_NPROBES = 3
MR_LLOYD_N = 1_000_000        # sharded Lloyd round on this prefix ...
MR_LLOYD_K = 32               # ... into this many clusters
MR_BENCH_N = 1_000_000        # cli.distributed_bench on this prefix ...
MR_BENCH_NQ = 1024            # ... and this many queries (cut from 4096)
MR_TIMEOUT = 300              # seconds one spawn of ranks may take
# the MIPS configuration (exp_scripts/mips_overlap_8m.py) on path 4's hard
# base: GP on a subsample, a k-means-tree router, centroid-ranked overlap
MIPS_SUBSAMPLE = 250_000      # GP graph on this many points (the script: 1M)
MIPS_AGGREGATES = 4096
MIPS_ROUTER_SAMPLE = 1_000_000  # router trained on this many points (the
                              # script: 2M; cut for time) ...
MIPS_ROUTER_SEED = SEED + 1   # ... drawn with this seed
MIPS_ROUTER_CENTROIDS = 32
MIPS_ROUTER_BUDGET = 40_000
MIPS_OVERLAP = 0.2
MIPS_KEEP = 5                 # foreign-cluster candidates a point
MIPS_VOTING_T = 60
MIPS_TARGET = 0.95            # the script's recall target
MIPS_GT_CHECK_NQ = 256        # GT held against a plain fp32 top-k
MIPS_EXACT_LAST_MIN = 0.9999  # exact scan, every shard probed
MIPS_ORACLE_SLACK = 1e-3      # routed curve <= oracle curve + this
MIPS_ARM_SLACK = 0.002        # overlap arm >= gp arm - this
MIPS_BINNED_SLACK = 0.005     # binned curve within this of the exact one
# the streamed path under MIPS: cli.scale_bench, cut from the reference's
# 16M GP run (exp_outputs/scale16m_mips_gp.csv) to 2M and bkm for time
MIPS_SCALE_N = 2_000_000
MIPS_SCALE_NQ = 1024
MIPS_SCALE_LAST_MIN = 0.995
# path 10: full-graph GP against subsample GP (exp_scripts/gp_fidelity_8m.py)
# through cli.gp_fidelity, cut from 8M to 1M points for time, the subsample
# cut with it (the shipped artifact's 1M of 8M)
FID_N = 1_000_000
FID_SUBSAMPLE = 125_000
FID_ORACLE_SLACK = 1e-3       # routed curve <= oracle curve + this
FID_LAST_MIN = 0.999          # routed curve at every probe
# path 11: the partition-quality experiment
# (exp_scripts/validate_partition_quality.py) through cli.partition_quality
# at the script's size, uncut; then every other partitioning method through
# cli.partition on the same base
PQ_N = 1_000_000
PQ_SHARDS = 16
PQ_KIND = "hard"
PQ_CSV = os.path.join(REPO, "exp_outputs", "partition_quality_hard.csv")
PQ_ORACLE_SLACK = 1e-3        # routed curve <= oracle curve + this
PQ_RANDOM_MARGIN = 0.3        # every method's oracle@1 >= Random's + this
PQ_RANDOM_CSV_TOL = 0.01      # Random's oracle curve against the TPU CSV
PQ_CSV_SLACK = 0.02           # GP, BalancedKMeans @1 >= the TPU CSV - this
PQ_METHODS = ("Pyramid", "OurPyramid", "KMeans", "FlatKMeans", "RKM")
PQ_METHODS_N = 1_000_000      # rows the five methods run on
PQ_OVERLAP_METHODS = ("OGPS", "OBKM", "ORKM")
PQ_OVERLAP = 0.2
PQ_OVERLAP_N = 100_000        # rows the overlapping methods run on (path 3's)
# phase 12: the serve-batch split (blobs, then the hard engine of path 4)
# and the T2I-regime MIPS experiment, both at the scripts' sizes, uncut
TAIL_HARD_WINDOW = 32         # hard batches a window ((b))
TAIL_ROUND = 0.006            # tail_ms_exact against the rounded parts
MIPS_SMOKE_N = 1_000_000
MIPS_SMOKE_SHARDS = 16
MIPS_SMOKE_CSV = os.path.join(REPO, "exp_outputs", "mips_smoke.csv")
MIPS_SMOKE_CSV_SLACK = 0.02   # curve >= the shipped CSV - this (C6)
MIPS_SMOKE_LAST_MIN = 0.995
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


def term_atol(queries, base) -> float:
    """``ATOL`` scaled to the data: 1e-6 (~8 ulp) of the largest |q|^2 +
    |x|^2, the terms whose rounding both versions carry. The blobs data,
    with terms up to ~1e3, gives the constant; the hard mixture's heavy
    tails and background points give more."""
    return max(ATOL, 1e-6 * float((queries * queries).sum(1).max()
                                  + (base * base).sum(1).max()))


def compare_bins(got, want, queries, base, row_base, metric: str,
                 id_rows=None, atol: float = ATOL) -> float:
    """Check kernel summaries ``got`` against the plain version's ``want``:
    the same +inf pattern, finite minima within tolerance (``RTOL``,
    ``atol``), and every finite entry's id (in the first ``id_rows`` rows;
    all by default) pointing at a row whose plain distance is the reported
    minimum. Returns the largest absolute error of the minima."""
    (gm, gi), (wm, _) = got, want
    fin = torch.isfinite(wm)
    assert torch.equal(fin, torch.isfinite(gm)), "+inf pattern differs"
    torch.testing.assert_close(gm[fin], wm[fin], rtol=RTOL, atol=atol)
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
        torch.testing.assert_close(dist[f], gm[sl][f], rtol=RTOL, atol=atol)
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


def measure_kernel(name: str, shape: str, kernel, plain, product,
                   bounds: dict, check, reps: int, tag: str) -> dict:
    """Hold ``kernel()`` against ``plain()`` on the same inputs (two launches
    must be bit-equal; ``check(got, want)`` returns the largest error), time
    both and the bare product, and return the entry's numbers for the
    ``kernels`` line."""
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
    log(f"{name} [{shape}] kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s of "
        f"{bounds['ops']:.4e} operations, {bounds['bytes']:.4e} bytes), "
        f"bound {bounds['bound_ms']:.3f} ms by {bounds['bound_by']} "
        f"(max of ops / {PEAK_SPLIT:.3e} and bytes / {PEAK_BYTES:.3e}), "
        f"fp32-FMA bound {bounds['fp32_fma_bound_ms']:.3f} ms, plain "
        f"{plain_ms:.3f} ms, max_abs_err {err:.3e}, two launches bit-equal "
        f"{tag}")
    log(f"{name}: the product alone, chunked fp32 torch.mm (TF32 off, no "
        f"reduction; not used by the port) {product_ms:.3f} ms {tag}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bounds["bound_ms"], bound_by=bounds["bound_by"],
                fp32_fma_bound_ms=bounds["fp32_fma_bound_ms"],
                tflops=tflops, library_ms=None)


def measure_base_scan(name: str, what: str, qs, base, tag: str,
                      id_rows=None, reps: int = 10, atol: float = ATOL,
                      metric: str = "l2") -> dict:
    """Kernel B2 (``binmin_scan``) of ``qs`` over all rows of ``base``
    against its plain version; the entry's numbers (:func:`measure_kernel`)."""
    from gpann_tpu_torch.search import bin_scan as bs

    dev, (m, d), n = qs.device, qs.shape, base.shape[0]
    zeros = torch.zeros(m, dtype=torch.int64, device=dev)
    rows = 1 << 16
    mm_out = torch.empty((m, rows), device=dev)

    def product():
        for r0 in range(0, n, rows):
            blk = base[r0 : r0 + rows]
            torch.mm(qs, blk.T, out=mm_out[:, : blk.shape[0]])

    return measure_kernel(
        name, f"{m} x {n} x {d}{what}",
        lambda: bs.binmin_scan(qs, base, n, metric),
        lambda: bs.binmin_scan_plain(qs, base, n, metric), product,
        scan_bounds(d, m, -(-n // 128) * 128,
                    torch.zeros(1, dtype=torch.int64, device=dev),
                    torch.full((1,), n, device=dev),
                    torch.full((1,), m, device=dev)),
        lambda got, want: compare_bins(got, want, qs, base, zeros, metric,
                                       id_rows=id_rows, atol=atol),
        reps=reps, tag=tag)


def measure_serve_scan(name: str, engine, q_dev, nprobes: int, voting_t: int,
                       tag: str, atol: float = ATOL) -> dict:
    """Kernel B1 (``bintop2_blocks``) at the shape one served batch gives it
    (route and group of ``q_dev`` at ``nprobes``) against its plain
    version; the entry's numbers (:func:`measure_kernel`)."""
    from gpann_tpu_torch.search import bin_scan as bs

    qrows, row_off, sizes, live_q = engine.scan_inputs(
        q_dev, nprobes, voting_t=voting_t, query_block=QUERY_BLOCK)
    cap, base = engine.capacity, engine.shard_points
    scan = (qrows, base, row_off, sizes, QUERY_BLOCK, cap, engine.metric)
    windows = [(b, off, size) for b, (off, size)
               in enumerate(zip(row_off.tolist(), sizes.tolist())) if size > 0]
    mm_out = torch.empty((QUERY_BLOCK, cap), device=q_dev.device)

    def product():
        for b, off, size in windows:
            torch.mm(qrows[b * QUERY_BLOCK : (b + 1) * QUERY_BLOCK],
                     base[off : off + size].T, out=mm_out[:, :size])

    return measure_kernel(
        name,
        f"{row_off.shape[0]} blocks x {QUERY_BLOCK} q, cap {cap}, "
        f"{len(windows)} live, {int(sizes.sum())} live rows, "
        f"{int(live_q[sizes > 0].sum())} of {len(windows) * QUERY_BLOCK} "
        f"query rows real (the rest pad each shard's last block), nprobes "
        f"{nprobes}",
        lambda: bs.bintop2_blocks(*scan),
        lambda: bs.bintop2_blocks_plain(*scan), product,
        scan_bounds(base.shape[1], QUERY_BLOCK, cap, row_off, sizes, live_q),
        lambda got, want: compare_bins(
            got, want, qrows, base, row_off.repeat_interleave(QUERY_BLOCK),
            engine.metric, atol=atol),
        reps=10, tag=tag)


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
                      tag: str, scratch: str):
    """The query-attribution pipeline through the port's CLIs on ``dev``
    (module docstring, path 3), its files under ``scratch``. ``shipped``
    holds the shipped ``assign`` and ``gt_dists``. Returns the kernel
    launches of this path and the files a later path reads again (ground
    truth, cover, routes)."""
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

    free = shutil.disk_usage(scratch).free
    log(f"query attribution: scratch {scratch}, {free / 2**30:.1f} GiB free")
    assert free >= QA_FREE_BYTES, f"needs {QA_FREE_BYTES >> 30} GiB free"
    path = lambda name: os.path.join(scratch, name)  # noqa: E731
    base_f, query_f, gt_f = path("base.fbin"), path("queries.fbin"), path("gt.bin")

    # ---- 1. inputs ----
    t0 = time.perf_counter()
    write_points(base_f, pts)
    write_points(query_f, q)
    assign = shipped["assign"]
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
    # on a prefix of the base and the shipped partition's part of it; the CLI
    # computes the prefix's ground truth (kernel B2), as no file holds it
    ss_base_f, ss_gp_f = path("small_base.fbin"), path("small.GP")
    write_points(ss_base_f, pts[:QA_SMALL_PREFIX])
    write_clusters(ss_gp_f, [c[c < QA_SMALL_PREFIX] for c in
                             partition_to_clusters(assign, SHARDS)])
    kernels.reset_launches()
    assert small_scale_queries.main([ss_base_f, query_f, path("small_gt.bin"),
                                     str(K), ss_gp_f, ss_csv, "GP"]
                                    + dev_arg) == 0
    stage("small scale CLI", t0)
    launches["binmin_scan"] += kernels.LAUNCHES["binmin_scan"]
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
    log("query attribution stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items())
        + f"; total {sum(secs.values()):.3f} {tag}")
    return launches, dict(gt=gt_f, cover=cover_f, routes=out + ".routes")


def _kernel_entry(name: str, launches: int, stats: dict) -> dict:
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name.split(" ")[0]], "launches": launches,
            **stats}


def bench_phase(dev, pts: np.ndarray, q: np.ndarray, shipped_hard: dict,
                cache_dir: str, tag: str):
    """``cli.bench`` on the hard mixture and on blobs (module docstring,
    path 4); ``pts`` and ``q`` are path 1's blobs data. Returns the kernel
    launches of this path, the hard run's state (engine, points, queries,
    kth) and JSON line, and the ``kernels`` entry of B1 at the hard serve
    shape."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.cli import bench as bench_cli
    from gpann_tpu_torch.eval.synth import dataset_cached
    from gpann_tpu_torch.search import bin_scan as bs

    size = ["--n", str(N), "--d", str(D), "--nq", str(NQ), "--shards",
            str(SHARDS), "--cache-dir", cache_dir, "--device", str(dev)]
    os.makedirs(cache_dir, exist_ok=True)
    t0 = time.perf_counter()
    dataset_cached("hard", N, D, SEED, cache_dir=cache_dir)
    log(f"bench: hard base {N} x {D} generated in "
        f"{time.perf_counter() - t0:.3f} s {tag}")

    # ---- hard mixture ----
    kernels.reset_launches()
    hard = {}
    t0 = time.perf_counter()
    out = bench_cli.run(bench_cli.parse_args(["--config", "hard"] + size), hard)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"bench hard: {time.perf_counter() - t0:.3f} s; launches {launches}")
    log(json.dumps(out))
    assert all(v > 0 for v in launches.values()), launches
    curve, ref = np.asarray(out["curve"]), shipped_hard["curve"]
    log("bench hard shipped curve: " + " ".join(
        f"{p + 1}:{r:.5f}" for p, r in enumerate(ref)))
    assert out["brute_recall_at_10"] >= 0.999, out["brute_recall_at_10"]
    _assert_monotone(list(curve), "hard curve")
    worst = float((ref - curve).max())
    log(f"bench hard: curve - shipped curve >= {-worst:.5f} over {len(curve)} "
        f"prefixes (need >= -{RECALL_SLACK}); last prefix {curve[-1]:.5f} "
        f"(need >= {HARD_LAST_PREFIX_MIN}); nprobes {out['nprobes']} (shipped "
        f"{int(shipped_hard['nprobes'])}); serve recall@10 "
        f"{out['recall_at_10']:.4f} (need >= 0.95)")
    assert worst <= RECALL_SLACK and curve[-1] >= HARD_LAST_PREFIX_MIN
    assert out["nprobes"] <= min(HARD_NPROBES_MAX, int(shipped_hard["nprobes"]))
    assert out["recall_at_10"] >= 0.95
    assert out["routing_points"] == len(shipped_hard["routing_points"])
    log(f"bench hard: serve {out['per_dispatch_ms']:.3f} ms/batch per dispatch "
        f"({out['per_dispatch_qps']:.1f} QPS), {out['window_ms_per_batch']:.3f} "
        f"ms/batch in 32-batch windows ({out['value']:.1f} QPS), brute "
        f"{out['brute_ms']:.3f} ms/batch ({out['brute_force_qps']:.1f} QPS), "
        f"vs_baseline {out['vs_baseline']} {tag}")

    # B1 against its plain version at the shape the hard serve gives it
    engine = hard["engine"]
    q_dev = torch.from_numpy(hard["queries"]).to(dev)
    atol = term_atol(q_dev, engine.shard_points)
    log(f"bench hard: kernel vs plain at rtol {RTOL}, atol {atol:.3e} (1e-6 of "
        "the largest |q|^2 + |x|^2 of the hard mixture)")
    entry = _kernel_entry(
        "bintop2_blocks (hard serve)", launches["bintop2_blocks"],
        measure_serve_scan("bintop2_blocks (hard serve)", engine, q_dev,
                           out["nprobes"], HARD_VOTING_T, tag, atol=atol))
    profile_batch(lambda: engine.serve_device(
        q_dev, K, out["nprobes"], voting_t=HARD_VOTING_T,
        query_block=QUERY_BLOCK), "hard serve", tag)
    del engine

    # ---- blobs: path 1's data, memory-mapped from the cache ----
    t0 = time.perf_counter()
    np.save(os.path.join(cache_dir, f"bench_pts_{SEED}_{N}_{D}_{NQ}.npy"), pts)
    np.save(os.path.join(cache_dir, f"bench_q_{SEED}_{N}_{D}_{NQ}.npy"), q)
    log(f"bench: blobs data written in {time.perf_counter() - t0:.3f} s")
    kernels.reset_launches()
    t0 = time.perf_counter()
    blobs = bench_cli.run(bench_cli.parse_args(["--config", "blobs"] + size))
    torch.cuda.synchronize()
    log(f"bench blobs: {time.perf_counter() - t0:.3f} s; launches "
        f"{kernels.LAUNCHES}")
    log(json.dumps(blobs))
    assert all(v > 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    for name in launches:
        launches[name] += kernels.LAUNCHES[name]
    assert abs(blobs["recall_at_10"] - BLOBS_SERVE_RECALL) <= RECALL_SLACK, blobs
    assert blobs["vs_baseline"] > 0 and blobs["nprobes"] == NPROBES
    log(f"bench blobs: serve recall@10 {blobs['recall_at_10']:.4f} (shipped "
        f"{BLOBS_SERVE_RECALL}; need within {RECALL_SLACK}), serve "
        f"{blobs['per_dispatch_ms']:.3f} ms/batch per dispatch, "
        f"{blobs['window_ms_per_batch']:.3f} ms/batch in windows "
        f"({blobs['value']:.1f} QPS), brute {blobs['brute_ms']:.3f} ms/batch, "
        f"vs_baseline {blobs['vs_baseline']} {tag}")
    torch.cuda.empty_cache()
    return launches, hard, out, entry


def profile_batch(batch, what: str, tag: str, batches: int = 5,
                  rows: int = 8) -> None:
    """Device time of one served batch by its ``rows`` largest kernels
    (``torch.profiler``), beside its CUDA-event time."""
    from torch.profiler import ProfilerActivity, profile

    ms = cuda_ms(batch, reps=10, warmup=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            batch()
        torch.cuda.synchronize()
    # device-side entries only: an operator's row repeats its kernels' time
    kernels_ = [(e.key, e.self_device_time_total / batches / 1e3,
                 e.count // batches)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels_.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels_)
    log(f"{what} {ms:.3f} ms/batch of {NQ} (CUDA events, unprofiled); device "
        f"busy {busy:.3f} ms a profiled batch, {sum(r[2] for r in kernels_)} "
        f"kernels and copies a batch {tag}")
    for key, per_batch, count in kernels_[:rows]:
        log(f"  {per_batch:8.3f} ms  x{count:<3d} {key[:100]}")


def streamed_phase(dev, hard: dict, hard_out: dict, shipped_hard: dict,
                   store_dir: str, tag: str):
    """The hard base served from the host, shard by shard (module docstring,
    path 5). ``hard`` is the state of path 4's hard run, ``hard_out`` its
    JSON line. Returns the kernel launches of this path and the ``kernels``
    entry of B2 at a shard's shape."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.eval.recall import recall_from_ids
    from gpann_tpu_torch.search import bin_scan as bs
    from gpann_tpu_torch.search.relayout import relayout_to_store
    from gpann_tpu_torch.search.streamed import StreamedShardEngine

    pts, q, kth = hard["points"], hard["queries"], hard["kth"]
    assign = shipped_hard["assign"]
    router = (shipped_hard["routing_points"], shipped_hard["routing_labels"])
    t0 = time.perf_counter()
    store = relayout_to_store(pts, assign, SHARDS, store_dir)
    log(f"streamed: relayout of {pts.shape} into {SHARDS} shard files "
        f"{time.perf_counter() - t0:.3f} s; sizes {store.sizes.min()}.."
        f"{store.sizes.max()} {tag}")
    assert store.n == len(pts) and (
        store.sizes == np.bincount(assign, minlength=SHARDS)).all()

    def one_pass(engine, what: str, queries=q, **kw):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i, stats = engine.search(queries, K, STREAM_NPROBES,
                                    voting_t=HARD_VOTING_T, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"streamed {what}: pass {secs:.3f} s for {len(queries)} queries, "
            f"{stats['bytes_uploaded'] / 1e9:.3f} GB copied; route "
            f"{stats['route_s']:.3f} s, gather {stats['gather_s']:.3f} s, scan "
            f"{stats['scan_s']:.3f} s of which upload {stats['upload_s']:.3f} "
            f"s; device scans {stats['device_scan_ms']:.3f} ms over "
            f"{stats['blocks_scanned']} blocks of {stats['shards_scanned']} "
            f"shards (CUDA events); launches {kernels.LAUNCHES} {tag}")
        return d, i, stats, dict(kernels.LAUNCHES)

    def same_share(a, b) -> float:
        return float(np.mean(np.abs(a - b) <= ATOL + RTOL * np.abs(b)))

    def ids_stand_for_distances(d, i) -> None:
        rows = np.asarray(pts[np.maximum(i, 0).reshape(-1)]).reshape(*i.shape, -1)
        exact = ((q[:, None, :] - rows) ** 2).sum(-1)
        np.testing.assert_allclose(exact[i >= 0], d[i >= 0], rtol=RTOL,
                                   atol=ATOL)
        assert ((i >= 0) == np.isfinite(d)).all()

    engine = StreamedShardEngine(None, None, *router, scan_mode="binned",
                                 store=store, device=dev)
    # ---- the curve of one pass against the resident engine's ----
    kernels.reset_launches()
    curve, stats = engine.recall_curve(q, K, kth, max_nprobes=STREAM_NPROBES,
                                       voting_t=HARD_VOTING_T)
    launches = dict(kernels.LAUNCHES)
    resident = np.asarray(hard_out["curve"][:STREAM_NPROBES])
    log("streamed curve: " + " ".join(f"{p + 1}:{r:.5f}" for p, r in
                                      enumerate(curve))
        + "; resident: " + " ".join(f"{p + 1}:{r:.5f}" for p, r in
                                    enumerate(resident))
        + f" (need within {RECALL_SLACK})")
    assert np.abs(curve - resident).max() <= RECALL_SLACK
    # one launch of B2 per probed shard; a shard with fewer than 4k bin
    # candidates takes the exact scan
    probes = engine.probe_order(q, STREAM_NPROBES, voting_t=HARD_VOTING_T)
    probed = np.unique(probes)
    binned = int((2 * (store.sizes[probed] // bs.BIN + 1) >= 4 * K).sum())
    log(f"streamed: {len(probed)} shards probed, {binned} through kernel B2, "
        f"launches {launches}")
    assert stats["shards_scanned"] == len(probed) == stats["blocks_scanned"]
    assert launches == {"binmin_scan": binned, "bintop2_blocks": 0}, launches

    # ---- ids and distances against the resident engine's serve ----
    d, i, stats, more = one_pass(engine, "whole shards")
    launches["binmin_scan"] += more["binmin_scan"]
    rd, ri = hard["engine"].serve(q, K, STREAM_NPROBES, voting_t=HARD_VOTING_T,
                                  query_block=QUERY_BLOCK)
    ids_stand_for_distances(d, i)
    share = same_share(d, rd)
    recalls = [recall_from_ids(pts, q, ids, kth, K) for ids in (i, ri)]
    log(f"streamed vs resident at nprobes {STREAM_NPROBES}: ids stand for "
        f"their distances (rtol {RTOL}, atol {ATOL}); {share:.6f} of the "
        f"distances equal (need >= {STREAM_SAME_SHARE}); recall@10 "
        f"{recalls[0]:.5f} against {recalls[1]:.5f}")
    assert share >= STREAM_SAME_SHARE
    assert abs(recalls[0] - recalls[1]) <= RECALL_SLACK
    copy_share = (stats["gather_s"] + stats["upload_s"]) / (
        stats["route_s"] + stats["gather_s"] + stats["scan_s"])
    log(f"streamed: gather + upload are {copy_share:.3f} of the pass, the "
        f"device scans {stats['device_scan_ms'] / 1e3 / (stats['route_s'] + stats['gather_s'] + stats['scan_s']):.3f} {tag}")

    # ---- sliced: blocks below the largest shard ----
    assert STREAM_SLICE_ROWS < store.sizes.max()
    sliced = StreamedShardEngine(None, None, *router, scan_mode="binned",
                                 store=store, max_scan_rows=STREAM_SLICE_ROWS,
                                 device=dev)
    sd, si, sstats, more = one_pass(sliced, f"slices of {STREAM_SLICE_ROWS} rows")
    launches["binmin_scan"] += more["binmin_scan"]
    assert sstats["blocks_scanned"] > sstats["shards_scanned"]
    assert sstats["bytes_uploaded"] == stats["bytes_uploaded"]
    share = same_share(sd, d)
    log(f"streamed sliced vs whole: {share:.6f} of the distances equal (need "
        f">= {STREAM_SAME_SHARE})")
    assert share >= STREAM_SAME_SHARE
    ids_stand_for_distances(sd, si)

    # ---- B2 against its plain version at one shard's shape ----
    b = int(probed[np.argmax(store.sizes[probed])])
    shard = torch.from_numpy(np.array(store.shard_rows(b))).to(dev)
    qs = torch.from_numpy(q[np.nonzero((probes == b).any(axis=1))[0]]).to(dev)
    entry = _kernel_entry(
        "binmin_scan (streamed shard)", launches["binmin_scan"],
        measure_base_scan("binmin_scan (streamed shard)",
                          f", shard {b} and the queries that probe it", qs,
                          shard, tag, atol=term_atol(qs, shard)))
    del shard, qs

    # ---- pruned: a sub-cluster-major store, a small batch ----
    qsub, ksub = q[:STREAM_SUB_NQ], kth[:STREAM_SUB_NQ]
    kernels.reset_launches()
    major, _ = engine.recall_curve(qsub, K, ksub, STREAM_NPROBES, HARD_VOTING_T)
    launches["binmin_scan"] += kernels.LAUNCHES["binmin_scan"]
    t0 = time.perf_counter()
    engine.build_subclusters_store(target_sub_size=STREAM_SUB_SIZE, seed=SEED)
    log(f"streamed: store regrouped into "
        f"{sum(len(c) for c in engine.sub_centroids)} sub-clusters of "
        f"~{STREAM_SUB_SIZE} rows in {time.perf_counter() - t0:.3f} s {tag}")
    kernels.reset_launches()
    whole, wstats = engine.recall_curve(qsub, K, ksub, STREAM_NPROBES,
                                        HARD_VOTING_T)
    cut, cstats = engine.recall_curve(qsub, K, ksub, STREAM_NPROBES,
                                      HARD_VOTING_T,
                                      sub_nprobe=STREAM_SUB_NPROBE)
    launches["binmin_scan"] += kernels.LAUNCHES["binmin_scan"]
    log(f"streamed pruned, {STREAM_SUB_NQ} queries, sub_nprobe "
        f"{STREAM_SUB_NPROBE}: {cstats['bytes_uploaded'] / 1e9:.3f} GB against "
        f"{wstats['bytes_uploaded'] / 1e9:.3f} GB whole; recall@10 at nprobes "
        f"{STREAM_NPROBES} {cut[-1]:.5f}")
    log(f"streamed regrouped store, unpruned, binned scan: recall@10 at "
        f"nprobes {STREAM_NPROBES} {whole[-1]:.5f}")
    log(f"streamed shard-major store, binned scan: recall@10 at nprobes "
        f"{STREAM_NPROBES} {major[-1]:.5f}")
    log(f"streamed: pruning alone loses {whole[-1] - cut[-1]:.5f} (may lose "
        f"{STREAM_SUB_LOSS}); the regrouped row order {major[-1] - whole[-1]:.5f} "
        f"(need <= {RECALL_SLACK})")
    assert cstats["bytes_uploaded"] < wstats["bytes_uploaded"]
    assert cut[-1] >= whole[-1] - STREAM_SUB_LOSS
    assert whole[-1] >= major[-1] - RECALL_SLACK
    return launches, entry


def run_scale_bench(argv, cache_dir: str, out_csv: str, curve_len: int,
                    what: str, tag: str):
    """One ``cli.scale_bench.main(argv)`` call with its caches in
    ``cache_dir`` and its CSV at ``out_csv``: logs its JSON line, stage
    seconds and curve, checks the row count (``curve_len`` probe prefixes),
    the balance and a non-decreasing curve. Returns (summary, curve,
    seconds, the CSV's first row as a dict: its stage seconds and its
    streamed GB to 0.01)."""
    import contextlib
    import io

    from gpann_tpu_torch.cli import scale_bench

    prev = os.environ.get("GPANN_CACHE_DIR")
    os.environ["GPANN_CACHE_DIR"] = cache_dir
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            assert scale_bench.main(argv + ["--out", out_csv]) == 0
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        if prev is None:
            del os.environ["GPANN_CACHE_DIR"]
        else:
            os.environ["GPANN_CACHE_DIR"] = prev
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(out_csv) as f:
        header = f.readline().strip().split(",")
        rows = [dict(zip(header, line.strip().split(","))) for line in f]
    log(f"scale_bench {what}: {secs:.3f} s {tag}")
    log(json.dumps(summary))
    log("scale_bench stage seconds: " + ", ".join(
        f"{k} {rows[0][k]}" for k in
        ("partition_s", "gt_s", "router_s", "curve_pass_s"))
        + f"; {rows[0]['gb_streamed']} GB streamed")
    curve = [float(r["recall"]) for r in rows]
    log("scale_bench curve: " + " ".join(
        f"{p + 1}:{r:.4f}" for p, r in enumerate(curve)
        if p < 8 or p + 1 == len(curve)))
    assert len(rows) == curve_len, len(rows)
    assert summary["balance"] <= SCALE_BALANCE_MAX, summary
    _assert_monotone(curve, f"scale_bench {what}")
    return summary, curve, secs, rows[0]


def scale_argv(dev, method: str) -> list:
    """Paths 6 and 9's ``cli.scale_bench`` arguments: a virtual 16M x 96 u8
    ``hard2`` base, fused assign + relayout into 64 shards, 1024 queries."""
    return ["--kind", "hard2", "--dtype", "u8", "--base", "virtual",
            "--layout", "shard-major", "--method", method, "--shards",
            str(SCALE_SHARDS), "--nq", str(SCALE_NQ), "--n", str(SCALE_N),
            "--d", str(D), "--device", str(dev)]


def scale_phase(dev, cache_dir: str, tag: str):
    """``cli.scale_bench`` as a user runs it, twice (module docstring, path
    6). Returns the kernel launches of this path and the curve without
    pruning."""
    from gpann_tpu_torch import kernels

    argv = scale_argv(dev, "bkm") + ["--sub-size", str(SCALE_SUB_SIZE)]
    kernels.reset_launches()
    runs = []
    for name, sub in (("pruned", SCALE_SUB_NPROBE), ("whole", 0)):
        summary, curve, secs, row = run_scale_bench(
            argv + ["--sub-nprobe", str(sub)], cache_dir,
            os.path.join(cache_dir, f"scale_{name}.csv"), SCALE_SHARDS,
            f"--sub-nprobe {sub}", tag)
        assert summary["n"] == SCALE_N, summary
        runs.append((summary, curve, secs, float(row["gb_streamed"])))
    (_, pruned, cold, gb_pruned), (whole, curve, warm, gb_whole) = runs
    log(f"scale_bench: cold {cold:.3f} s, on its own caches {warm:.3f} s; last "
        f"prefix without pruning {curve[-1]:.6f} (need >= {SCALE_LAST_PREFIX_MIN})")
    log(f"scale_bench --sub-nprobe {SCALE_SUB_NPROBE} --sub-size "
        f"{SCALE_SUB_SIZE}: {gb_pruned:.2f} GB streamed against {gb_whole:.2f} "
        f"whole, last prefix {pruned[-1]:.6f} against {curve[-1]:.6f}")
    assert curve[-1] >= SCALE_LAST_PREFIX_MIN and whole["sub_nprobe"] == 0
    launches = dict(kernels.LAUNCHES)
    log(f"launches on the scale_bench path: {launches}")
    assert launches["binmin_scan"] > 0, launches
    return launches, curve


def check_gp_store(store, n: int, shards: int) -> None:
    """The fused GP store holds every id of ``range(n)`` exactly once, no
    shard above the capacity of ``relayout.py::capacity_assign_to_store``;
    logs the rows of each shard's retry tail (its main-pass rows are in
    ascending id order, the retry rounds' rows follow)."""
    cap = int((1.0 + EPS) * -(-n // shards))
    assert store.n == n and store.num_shards == shards, (store.n, n)
    assert int(store.sizes.max()) <= cap, (int(store.sizes.max()), cap)
    tails, ids = [], []
    for b in range(shards):
        sid = np.asarray(store.shard_ids(b)).astype(np.int64)
        drop = np.nonzero(np.diff(sid) < 0)[0]
        tails.append(len(sid) - int(drop[0]) - 1 if len(drop) else 0)
        ids.append(sid)
    ids = np.concatenate(ids)
    assert len(ids) == n and ids.min() >= 0 and ids.max() < n
    assert (np.bincount(ids, minlength=n) == 1).all(), "an id is not once"
    tails = np.asarray(tails)
    log(f"gp store: shards {int(store.sizes.min())}..{int(store.sizes.max())} "
        f"rows (cap {cap}); every id of range({n}) once; retry tails "
        f"{int(tails.sum())} rows in {int((tails > 0).sum())} shards, "
        f"largest {int(tails.max())}")


def time_topk_choice(dev, tag: str) -> None:
    """The kNN graph build's top-k (``topk_smallest``: equal values in
    ascending position, C12) against a stable sort cut to its first k, at
    the build's two shapes (a batch of 8192-row buckets, k = the degree; a
    step of the leader match, 1024 leaders, fanout 3) on integer distances
    with many ties: the two must agree; both times are logged."""
    from gpann_tpu_torch.core.distances import topk_smallest

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for what, shape, k in (("bucket crunch", (4, 8192, 8192), GRAPH_DEGREE),
                           ("leader match", (1 << 16, 1024), 3)):
        x = torch.randint(0, 4096, shape, device=dev, generator=gen).float()

        def by_sort():
            v, i = torch.sort(x, dim=-1, stable=True)
            return v[..., :k], i[..., :k]

        (sv, si), (tv, ti) = by_sort(), topk_smallest(x, k)
        assert torch.equal(sv, tv) and torch.equal(si, ti), what
        del sv, si, tv, ti
        ms_topk = cuda_ms(lambda: topk_smallest(x, k), reps=3)
        ms_sort = cuda_ms(by_sort, reps=3)
        log(f"kNN top-k, {what} {list(shape)}, k {k}: topk_smallest "
            f"{ms_topk:.3f} ms, stable sort cut to k {ms_sort:.3f} ms "
            f"(same values and positions) {tag}")
        del x
    torch.cuda.empty_cache()


def small_batch_entry(dev, store_dir: str, router, queries: np.ndarray,
                      sub: int, launches: int, tag: str) -> dict:
    """The ``kernels`` entry of B2 at one small-batch run (c) of path 9,
    ``--sub-nprobe sub``: the run's pass is read again through the engine
    the CLI builds (its router, saved queries and store), shard by shard as
    ``StreamedShardEngine.search`` reads it, to find every block that
    reaches the kernel. Their number must be the run's launches; the block
    with the most probing queries (rows in the scan's order) is held
    against the plain version."""
    from gpann_tpu_torch.cli.scale_bench import K as SCALE_K
    from gpann_tpu_torch.core.distances import to_device
    from gpann_tpu_torch.search.relayout import ShardMajorStore
    from gpann_tpu_torch.search.streamed import StreamedShardEngine

    engine = StreamedShardEngine(None, None, router["rp"], router["rl"],
                                 store=ShardMajorStore(store_dir), device=dev)
    probes = engine.probe_order(queries, SCALE_SMALL_NPROBES)
    blocks = []
    for b in range(engine.num_shards):
        qidx = np.nonzero((probes == b).any(1))[0]
        if len(qidx) == 0:
            continue
        rows, members, _ = engine.shard_block(b, queries[qidx], sub or None)
        if len(members) and engine.takes_binned(len(rows), SCALE_K):
            blocks.append((len(qidx), len(rows), b))
    assert launches > 0 and len(blocks) == launches, (len(blocks), launches)
    nqs, sizes, _ = zip(*blocks)
    log(f"small batch --sub-nprobe {sub}: {launches} blocks reach B2, "
        f"{min(sizes)}..{max(sizes)} rows, {min(nqs)}..{max(nqs)} probing "
        f"queries")
    mq, size, b = max(blocks)
    qidx = np.nonzero((probes == b).any(1))[0]
    rows, _, grouped = engine.shard_block(b, queries[qidx], sub or None)
    base = to_device(rows, dev)
    if grouped:
        base = base[engine.scan_permutation(size).to(dev)]
    qs = torch.as_tensor(queries[qidx], device=dev)
    cut = f"top-{sub} sub-clusters" if sub else "whole shards"
    name = f"binmin_scan (gp small batch, {cut})"
    return _kernel_entry(name, launches, measure_base_scan(
        name, f", u8 widened, shard {b}, {cut}"
        f"{' in the scan order' if grouped else ''}", qs, base, tag,
        atol=term_atol(qs, base)))


def scale_gp_phase(dev, cache_dir: str, bkm_curve, tag: str) -> list:
    """``cli.scale_bench --method gp`` (module docstring, path 9) in path 6's
    cache directory, on its base, ground truth and queries: (a) binned, (b)
    exact on the same store, (c) the small-batch pruning runs. Returns the
    ``kernels`` entries of B2, each with the launches of the runs at its
    shape: (a)'s at the store's largest shard with every query, and one for
    each run of (c) at one of its blocks (:func:`small_batch_entry`)."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.core.distances import to_device
    from gpann_tpu_torch.search.relayout import ShardMajorStore

    time_topk_choice(dev, tag)
    t_phase = time.perf_counter()
    argv = scale_argv(dev, "gp") + [
        "--gp-subsample", str(SCALE_GP_SUBSAMPLE),
        "--gp-aggregates", str(SCALE_GP_AGGREGATES)]

    def run(extra, name, curve_len):
        kernels.reset_launches()
        out = run_scale_bench(argv + extra, cache_dir,
                              os.path.join(cache_dir, f"scale_gp_{name}.csv"),
                              curve_len, f"--method gp {' '.join(extra)}", tag)
        counted = dict(kernels.LAUNCHES)
        log(f"launches of scale_bench --method gp {' '.join(extra)}: {counted}")
        assert counted["bintop2_blocks"] == 0, counted
        return out, counted["binmin_scan"]

    # (a), (b): the whole curve, binned then exact, from one store
    (gp, binned, cold, row), launches = run([], "binned", SCALE_SHARDS)
    assert gp["n"] == SCALE_N and gp["method"] == "gp", gp
    # the pass probes every shard (min_dist ranks them all): one launch each
    assert launches == SCALE_SHARDS, launches
    (aggs_time,) = glob.glob(os.path.join(cache_dir, "*_gp_aggs.npz.time"))
    with open(aggs_time) as f:
        aggs_s = json.load(f)["seconds"]
    log(f"scale_bench --method gp stage seconds: aggregates (subsample "
        f"{SCALE_GP_SUBSAMPLE}, kNN graph, LP, {SCALE_GP_AGGREGATES} "
        f"aggregates) {aggs_s:.1f}, fused assign + relayout "
        f"{float(row['partition_s']) - aggs_s:.1f}, GT {row['gt_s']} (path "
        f"6's cache), router {row['router_s']}, pass {row['curve_pass_s']}; "
        f"whole run {cold:.3f} s {tag}")
    (store_dir,) = glob.glob(os.path.join(cache_dir, "*_gp_store"))
    store = ShardMajorStore(store_dir)
    check_gp_store(store, SCALE_N, SCALE_SHARDS)
    (_, exact, _, _), counted = run(["--scan-mode", "exact"], "exact",
                                    SCALE_SHARDS)
    assert counted == 0, counted
    gap = np.abs(np.asarray(binned) - np.asarray(exact))
    log("scale_bench --method gp exact curve: " + " ".join(
        f"{p + 1}:{r:.4f}" for p, r in enumerate(exact)
        if p < 8 or p + 1 == len(exact)))
    log(f"scale_bench --method gp: binned against exact, largest gap "
        f"{gap.max():.6f} at {int(gap.argmax()) + 1} probes (need <= "
        f"{SCALE_GP_BINNED_SLACK}); last prefix {binned[-1]:.6f} (need >= "
        f"{SCALE_LAST_PREFIX_MIN})")
    at = {name: _probes_at(c, SCALE_TARGET)
          for name, c in (("gp", binned), ("bkm", bkm_curve))}
    log(f"probes at recall {SCALE_TARGET}: gp {at['gp']} (recall "
        f"{binned[at['gp'] - 1]:.4f}), bkm {at['bkm']} (recall "
        f"{bkm_curve[at['bkm'] - 1]:.4f}); same base, GT and queries; 1 probe "
        f"gp {binned[0]:.4f} bkm {bkm_curve[0]:.4f} {tag}")
    assert binned[-1] >= SCALE_LAST_PREFIX_MIN, binned[-1]
    assert gap.max() <= SCALE_GP_BINNED_SLACK, gap.max()

    # (a)'s launches against the plain version at the store's largest shard
    # with the CLI's queries (saved beside its ground truth), before (c)
    # regroups the store
    (gt_path,) = glob.glob(os.path.join(cache_dir, "*_gt.npz"))
    saved_q = np.load(gt_path)["queries"]
    b = int(np.argmax(store.sizes))
    shard = to_device(store.shard_rows(b), dev)
    qs = to_device(saved_q[:SCALE_NQ], dev)
    name = "binmin_scan (gp streamed shard)"
    entries = [_kernel_entry(name, launches, measure_base_scan(
        name, f", u8 widened, shard {b} of the gp store, every query", qs,
        shard, tag, atol=term_atol(qs, shard)))]
    del shard, qs

    # (c) the small-batch pruning runs on the same store, each run's
    # launches held at one of its blocks
    (rt_path,) = glob.glob(os.path.join(cache_dir, "*_gp_router.npz"))
    router = dict(np.load(rt_path))
    small_q = np.asarray(saved_q[:SCALE_SMALL_NQ], np.float32)
    gbs = []
    for sub in SCALE_SMALL_SUB:
        (_, curve, secs, row), counted = run(
            ["--nq", str(SCALE_SMALL_NQ), "--max-nprobes",
             str(SCALE_SMALL_NPROBES), "--sub-size", str(SCALE_SUB_SIZE),
             "--sub-nprobe", str(sub)], f"small_t{sub}", SCALE_SMALL_NPROBES)
        gbs.append(float(row["gb_streamed"]))
        log(f"small batch --sub-nprobe {sub}: {gbs[-1]:.2f} GB streamed, "
            f"recall {curve[4]:.4f} at 5 probes, {curve[-1]:.4f} at "
            f"{SCALE_SMALL_NPROBES}, {secs:.3f} s {tag}")
        entries.append(small_batch_entry(dev, store_dir, router, small_q, sub,
                                         counted, tag))
    assert gbs[0] > gbs[1] > gbs[2], gbs
    log(f"B2 launches on the scale_bench --method gp path: "
        f"{[e['launches'] for e in entries]}")
    log(f"scale_bench --method gp phase {time.perf_counter() - t_phase:.3f} s "
        f"{tag}")
    return entries


def _probes_at(curve, target: float) -> int:
    ok = np.nonzero(np.asarray(curve) >= target)[0]
    return int(ok[0] + 1) if len(ok) else len(curve)


def mips_phase(dev, hard: dict, cache_dir: str, tag: str) -> list:
    """The MIPS configuration (module docstring, path 8) on path 4's hard
    base and queries (``hard["points"]``, ``hard["queries"]``): part A as
    ``exp_scripts/mips_overlap_8m.py`` runs it, part B ``cli.scale_bench
    --metric mips``. Returns the ``kernels`` entries of the kernel launches
    of this path, each held against its plain version at the shape of the
    launches it counts: B2 at the ground truth, B1 at each arm's binned
    curve, B2 at part B's streamed shards."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.core.distances import chunked_topk_neighbors
    from gpann_tpu_torch.core.partition import (clusters_to_cover,
                                                partition_to_clusters)
    from gpann_tpu_torch.eval.recall import (compute_ground_truth,
                                             kth_neighbor_distance,
                                             oracle_recall)
    from gpann_tpu_torch.gp.overlap import (apply_extra_assignments,
                                            centroid_overlap_streamed)
    from gpann_tpu_torch.gp.scale import subsample_gp_partition
    from gpann_tpu_torch.route import KMeansTreeRouter, KMeansTreeRouterOptions
    from gpann_tpu_torch.search.relayout import ShardMajorStore
    from gpann_tpu_torch.search.serve import ServingEngine

    t_phase = time.perf_counter()
    pts, q = hard["points"], hard["queries"]
    n = len(pts)
    secs = {}

    def stage(name: str, t0: float) -> None:
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"mips: {name} {secs[name]:.3f} s {tag}")

    def launched(what: str) -> dict:
        """The launches since the last call (counts reset to 0 after)."""
        torch.cuda.synchronize()
        out = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        log(f"mips launches, {what}: {out}")
        return out

    entries = []
    kernels.reset_launches()
    # ---- A1. ground truth under MIPS through kernel B2 ----
    t0 = time.perf_counter()
    gt_ids, gt_dists = compute_ground_truth(pts, q, K, metric="mips",
                                            device=dev)
    stage("ground truth", t0)
    # one launch: all queries over the whole base
    gt_launches = launched("ground truth")
    assert gt_launches == {"binmin_scan": 1, "bintop2_blocks": 0}
    assert gt_ids.shape == (len(q), K) and np.isfinite(gt_dists).all()
    kth = kth_neighbor_distance(gt_dists, K)
    # held against a plain fp32 top-k (TF32 off) on a slice of the queries;
    # the GT's distances are its ids' scores, so ids are checked through them
    assert not torch.backends.cuda.matmul.allow_tf32
    m = MIPS_GT_CHECK_NQ
    t0 = time.perf_counter()
    plain_d, _ = chunked_topk_neighbors(q[:m], pts, K, metric="mips",
                                        device=dev)
    stage("ground truth check", t0)
    np.testing.assert_allclose(gt_dists[:m], plain_d, rtol=GT_KTH_RTOL)
    log(f"mips GT: {m} queries' 10 scores (kth {kth[:m].min():.3f}.."
        f"{kth[:m].max():.3f}) equal a plain fp32 top-10 within rtol "
        f"{GT_KTH_RTOL} ok")

    # ---- A2. GP partition on a subsample, stream-assigned ----
    t0 = time.perf_counter()
    assign, (aggs, agg_lbl, _, _) = subsample_gp_partition(
        pts, k=SHARDS, eps=EPS, seed=SEED, metric="mips",
        num_subsample=MIPS_SUBSAMPLE, num_aggregate=MIPS_AGGREGATES,
        return_artifacts=True, device=dev)
    stage("partition", t0)
    sizes = np.bincount(assign, minlength=SHARDS)
    balance = float(sizes.max() / np.ceil(n / SHARDS))
    log(f"mips partition: {SHARDS} parts, {sizes.min()}..{sizes.max()} rows, "
        f"balance {balance:.4f} (need <= {1 + EPS})")
    assert len(sizes) == SHARDS and balance <= 1 + EPS

    # ---- A3. k-means-tree router on a subsample ----
    t0 = time.perf_counter()
    sub = np.sort(np.random.default_rng(MIPS_ROUTER_SEED).choice(
        n, size=min(MIPS_ROUTER_SAMPLE, n // 2), replace=False))
    rp, rl = KMeansTreeRouter(metric="mips", device=dev).train(
        np.asarray(pts[sub], np.float32),
        partition_to_clusters(assign[sub], SHARDS),
        KMeansTreeRouterOptions(num_centroids=MIPS_ROUTER_CENTROIDS,
                                budget=MIPS_ROUTER_BUDGET), seed=SEED
    ).extract_points()
    stage("router", t0)
    log(f"mips router: {len(rp)} routing points from {len(sub)}")

    # ---- A4. centroid-ranked overlap, cheapest first under a capacity ----
    t0 = time.perf_counter()
    cap2 = int((1.0 + EPS) * (1.0 + MIPS_OVERLAP) * n / SHARDS)
    extra = int(MIPS_OVERLAP * n)
    ep, ec = centroid_overlap_streamed(
        pts, assign, aggs, agg_lbl, SHARDS, cap2, extra, keep=MIPS_KEEP,
        metric="mips", device=dev)
    clusters = partition_to_clusters(assign, SHARDS)
    cover = apply_extra_assignments(clusters, ep, ec)
    stage("overlap", t0)
    largest = max(len(c) for c in cover)
    log(f"mips overlap: {len(ep)} extra assignments (need {extra}), largest "
        f"cover shard {largest} (capacity {cap2})")
    assert len(ep) == extra and largest <= cap2
    # every launch of the path is counted by an entry below
    assert not any(launched("partition, router, overlap").values())

    # ---- A5. both arms served on one router, binned then exact ----
    q_dev = torch.from_numpy(q).to(dev)
    log("mips serving: voting_impl exact (the script's \"approx\" is exact "
        "torch.topk in the port)")
    oracle = {"gp": oracle_recall(gt_ids, partition=assign, num_shards=SHARDS),
              "gp_overlap": oracle_recall(
                  gt_ids, cover=clusters_to_cover(cover, n=n),
                  num_shards=SHARDS)}
    curves, summary, b1 = {}, {}, {}
    for arm, cl in (("gp", clusters), ("gp_overlap", cover)):
        t0 = time.perf_counter()
        engine = ServingEngine(pts, cl, rp, rl, metric="mips",
                               scan_mode="binned", voting_impl="exact",
                               device=dev)
        stage(f"{arm} engine", t0)
        # one engine serves both scans: its capacity is a multiple of the
        # bin either way, so the exact engine's arrays would be the same
        for scan_mode in ("binned", "exact"):
            engine.scan_mode = scan_mode
            t0 = time.perf_counter()
            curve = engine.recall_curve(q_dev, K, kth, voting_t=MIPS_VOTING_T,
                                        rule="min_dist",
                                        query_block=QUERY_BLOCK)
            stage(f"{arm} {scan_mode} curve", t0)
            # the binned curve is one launch of B1: every query at every
            # probe, the shape held below; the exact scan launches nothing
            counted = launched(f"{arm} {scan_mode} curve")
            assert counted == {"binmin_scan": 0, "bintop2_blocks":
                               int(scan_mode == "binned")}, counted
            curves[arm, scan_mode] = np.asarray(curve, np.float64)
            log(f"mips {arm} {scan_mode} curve: " + " ".join(
                f"{p + 1}:{r:.5f}" for p, r in enumerate(curve)))
            if scan_mode == "exact":
                continue
            npb = _probes_at(curve, MIPS_TARGET)
            summary[arm] = {
                "probes_at_095": npb,
                "recall_at_that": round(float(curve[npb - 1]), 4),
                "scanned_rows_at_095": npb * engine.capacity,
                "oracle_probes_at_095": _probes_at(oracle[arm], MIPS_TARGET),
                "curve12": [round(float(r), 4) for r in curve[:12]]}
            # B1 against its plain version at the curve's shape
            name = f"bintop2_blocks (MIPS {arm.removeprefix('gp_')} serve)"
            b1[arm] = _kernel_entry(
                name, counted["bintop2_blocks"],
                measure_serve_scan(name, engine, q_dev, SHARDS, MIPS_VOTING_T,
                                   tag,
                                   atol=term_atol(q_dev, engine.shard_points)))
            kernels.reset_launches()  # the comparison's launches do not count
            torch.cuda.empty_cache()
        del engine
        torch.cuda.empty_cache()
    log("mips summary (the script's JSON): " + json.dumps(
        {"overlap": MIPS_OVERLAP, "num_extra": int(len(ep)), **summary}))
    for arm in ("gp", "gp_overlap"):
        binned, exact = curves[arm, "binned"], curves[arm, "exact"]
        log(f"mips {arm} oracle curve: " + " ".join(
            f"{p + 1}:{r:.5f}" for p, r in enumerate(oracle[arm][:12])))
        gap = float(np.abs(binned - exact).max())
        over = max(float((c - oracle[arm]).max()) for c in (binned, exact))
        log(f"mips {arm}: binned - exact within {gap:.5f} (need <= "
            f"{MIPS_BINNED_SLACK}); exact last prefix {exact[-1]:.5f} (need "
            f">= {MIPS_EXACT_LAST_MIN}); routed - oracle <= {over:.5f} (need "
            f"<= {MIPS_ORACLE_SLACK})")
        _assert_monotone(list(binned), f"mips {arm} binned curve")    # (a)
        assert exact[-1] >= MIPS_EXACT_LAST_MIN, exact                 # (b)
        assert over <= MIPS_ORACLE_SLACK, (arm, over)                  # (c)
        assert gap <= MIPS_BINNED_SLACK, (arm, binned, exact)          # (e)
    worst = float((curves["gp", "binned"]
                   - curves["gp_overlap", "binned"]).max())
    log(f"mips: overlap arm - gp arm >= {-worst:.5f} (need >= "
        f"-{MIPS_ARM_SLACK})")
    assert worst <= MIPS_ARM_SLACK                                     # (d)
    log("mips stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items())
        + f"; total {sum(secs.values()):.3f} {tag}")

    # B2 against its plain version at the ground truth's shape
    base = torch.tensor(pts, device=dev)  # a copy: the points are read-only
    log(f"mips: kernel vs plain at rtol {RTOL}, atol 1e-6 of the largest "
        "|q|^2 + |x|^2")
    name = "binmin_scan (MIPS ground truth)"
    entries.append(_kernel_entry(
        name, gt_launches["binmin_scan"],
        measure_base_scan(name, "", q_dev, base, tag, id_rows=256, reps=3,
                          atol=term_atol(q_dev, base), metric="mips")))
    entries += [b1["gp"], b1["gp_overlap"]]
    kernels.reset_launches()
    del base, q_dev
    torch.cuda.empty_cache()
    log(f"mips part A {time.perf_counter() - t_phase:.3f} s {tag}")

    # ---- B. the streamed path under MIPS: cli.scale_bench ----
    t0 = time.perf_counter()
    argv = ["--kind", "hard", "--dtype", "f32", "--metric", "mips",
            "--base", "virtual", "--layout", "shard-major", "--method", "bkm",
            "--shards", str(SHARDS), "--nq", str(MIPS_SCALE_NQ), "--n",
            str(MIPS_SCALE_N), "--d", str(D), "--device", str(dev)]
    os.makedirs(cache_dir, exist_ok=True)
    scale, curve, _, _ = run_scale_bench(
        argv, cache_dir, os.path.join(cache_dir, "scale_mips.csv"), SHARDS,
        "--metric mips", tag)
    # the curve pass probes every shard (min_dist ranks them all), so it
    # scans each shard once, with every query
    counted = launched("scale_bench --metric mips")
    log(f"scale_bench --metric mips: last prefix {curve[-1]:.6f} (need >= "
        f"{MIPS_SCALE_LAST_MIN})")
    assert scale["n"] == MIPS_SCALE_N and scale["metric"] == "mips"
    assert curve[-1] >= MIPS_SCALE_LAST_MIN
    assert counted == {"binmin_scan": SHARDS, "bintop2_blocks": 0}, counted
    # B2 against its plain version at the largest shard of the CLI's store,
    # with the CLI's queries (saved beside its ground truth)
    (store_dir,) = glob.glob(os.path.join(cache_dir, "*_store"))
    (gt_path,) = glob.glob(os.path.join(cache_dir, "*_gt.npz"))
    store = ShardMajorStore(store_dir)
    b = int(np.argmax(store.sizes))
    shard = torch.from_numpy(np.array(store.shard_rows(b))).to(dev)
    qs = torch.from_numpy(np.load(gt_path)["queries"][:MIPS_SCALE_NQ]).to(dev)
    name = "binmin_scan (MIPS streamed shard)"
    entries.append(_kernel_entry(
        name, counted["binmin_scan"],
        measure_base_scan(name, f", shard {b}, every query", qs, shard, tag,
                          atol=term_atol(qs, shard), metric="mips")))
    del shard, qs
    log(f"mips part B {time.perf_counter() - t0:.3f} s; phase "
        f"{time.perf_counter() - t_phase:.3f} s {tag}")
    return entries


def fidelity_phase(dev, scratch: str, tag: str) -> list:
    """``cli.gp_fidelity`` (module docstring, path 10): the full-graph GP
    arm against the subsample arm on a ``FID_N``-point ``hard`` base, run as
    a user runs the module, with the launches counted stage by stage.
    Returns the ``kernels`` entries of B2 at the ground truth and of B1 at
    each arm's curve, each held against its plain version at the shape of
    its one launch."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.cli import gp_fidelity
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.search.serve import ServingEngine

    t_phase = time.perf_counter()
    cache = os.path.join(scratch, "fidelity")
    out_csv = os.path.join(cache, "gp_fidelity.csv")
    argv = ["--n", str(FID_N), "--d", str(D), "--nq", str(NQ), "--shards",
            str(SHARDS), "--subsample", str(FID_SUBSAMPLE), "--cache-dir",
            cache, "--out", out_csv, "--device", str(dev)]
    log(f"gp fidelity: python -m gpann_tpu_torch.cli.gp_fidelity "
        + " ".join(argv))
    launches = {}

    def on_stage(name: str) -> None:
        torch.cuda.synchronize()
        launches[name] = dict(kernels.LAUNCHES)
        kernels.reset_launches()

    state = {}
    kernels.reset_launches()
    summary = gp_fidelity.run(gp_fidelity.parse_args(argv), state, on_stage)
    log(f"gp fidelity: {time.perf_counter() - t_phase:.3f} s; launches by "
        f"stage {launches}")
    log("gp fidelity summary (the script's JSON): " + json.dumps(summary))
    # the ground truth is one launch of B2 (every query over the base), each
    # arm's binned curve one launch of B1 (every query at every probe);
    # partitions and routers launch nothing
    arms = gp_fidelity.ARMS
    want = {name: {"binmin_scan": 0, "bintop2_blocks": 0} for name in
            ["data", "ground truth"]
            + [f"{arm} {step}" for arm in arms
               for step in ("partition", "router")]
            + [f"{arm} curve" for arm in arms]}
    want["ground truth"]["binmin_scan"] = 1
    for arm in arms:
        want[f"{arm} curve"]["bintop2_blocks"] = 1
    assert launches == want, launches
    rows = open(out_csv).read().strip().split("\n")
    assert rows[0] == gp_fidelity.CSV_HEADER and len(rows) == 1 + 2 * SHARDS
    for arm in arms:
        assign, oracle, curve = (state[arm][key]
                                 for key in ("assign", "oracle", "curve"))
        balance = float(np.bincount(assign, minlength=SHARDS).max()
                        / np.ceil(FID_N / SHARDS))
        over = float((curve - oracle).max())
        log(f"gp fidelity {arm}: balance {balance:.4f} (need <= {1 + EPS}); "
            f"oracle " + " ".join(f"{p + 1}:{r:.5f}"
                                  for p, r in enumerate(oracle[:8]))
            + "; routed " + " ".join(f"{p + 1}:{r:.5f}"
                                     for p, r in enumerate(curve[:8]))
            + f"; routed - oracle <= {over:.5f} (need <= {FID_ORACLE_SLACK});"
            f" last prefix {curve[-1]:.5f} (need >= {FID_LAST_MIN}); probes "
            f"at {gp_fidelity.TARGET}: oracle "
            f"{_probes_at(oracle, gp_fidelity.TARGET)}, routed "
            f"{_probes_at(curve, gp_fidelity.TARGET)} {tag}")
        assert balance <= 1 + EPS and summary[arm]["balance"] <= 1 + EPS
        _assert_monotone(list(oracle), f"gp fidelity {arm} oracle curve")
        _assert_monotone(list(curve), f"gp fidelity {arm} routed curve")
        assert over <= FID_ORACLE_SLACK, (arm, over)
        assert curve[-1] >= FID_LAST_MIN, (arm, curve)

    # each launch's shape against the plain version
    pts, q_dev = state["points"], torch.from_numpy(state["queries"]).to(dev)
    base = torch.tensor(np.asarray(pts), device=dev)  # a copy: read-only
    log(f"gp fidelity: kernel vs plain at rtol {RTOL}, atol 1e-6 of the "
        "largest |q|^2 + |x|^2")
    name = "binmin_scan (gp fidelity GT)"
    entries = [_kernel_entry(
        name, launches["ground truth"]["binmin_scan"],
        measure_base_scan(name, "", q_dev, base, tag, id_rows=256,
                          atol=term_atol(q_dev, base)))]
    del base
    for arm, what in (("fullgraph_gp", "full graph"),
                      ("subsample_gp", "subsample")):
        name = f"bintop2_blocks (gp fidelity, {what})"
        engine = ServingEngine(
            pts, partition_to_clusters(state[arm]["assign"], SHARDS),
            state[arm]["routing_points"], state[arm]["routing_labels"],
            scan_mode="binned", voting_impl="exact", device=dev)
        entries.append(_kernel_entry(
            name, launches[f"{arm} curve"]["bintop2_blocks"],
            measure_serve_scan(name, engine, q_dev, SHARDS,
                               gp_fidelity.VOTING_T, tag,
                               atol=term_atol(q_dev, engine.shard_points))))
        del engine
        torch.cuda.empty_cache()
    kernels.reset_launches()  # the comparisons' launches do not count
    shutil.rmtree(cache)
    log(f"gp fidelity phase {time.perf_counter() - t_phase:.3f} s {tag}")
    return entries


def tail_phase(dev, hard: dict, hard_out: dict, cache_dir: str,
               serve_blocks: int, tag: str) -> list:
    """The served batch split into route, scan and tail (module docstring,
    path 12 (a), (b)): ``cli.serve_tail_profile`` on path 4's cache
    directory (the blobs data and the shipped artifacts), then its
    ``decompose`` on path 4's hard engine (``hard``, its JSON line
    ``hard_out``) over fresh hard batches. ``serve_blocks`` is the block
    count of path 1's B1 entry. Returns the ``kernels`` entries of B1 at
    each run's scan shape with that run's launches."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.cli import serve_tail_profile as stp
    from gpann_tpu_torch.eval.synth import generate_queries

    t_phase = time.perf_counter()
    # each run: one recall serve, then a warm and REPS timed windows of
    # serves and of scans, one B1 launch a batch; routing launches nothing
    # (its vote set is torch.topk)
    want = {"binmin_scan": 0,
            "bintop2_blocks": 1 + 2 * (1 + stp.REPS) * stp.WINDOW}

    def check(res: dict, st: dict, what: str, nprobes: int) -> None:
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        ms = st["ms"]
        scanned_rows = st["scanned_padding_rows"] + len(st["ids"]) * nprobes
        log(f"serve tail, {what}: " + json.dumps(res))
        log(f"serve tail, {what}: serve {ms['serve']:.4f} ms/batch "
            f"({res['serve_exact']['qps']:.1f} QPS), route {ms['route']:.4f}, "
            f"scan (B1 + phase 2) {ms['scan']:.4f}, tail {ms['tail']:.4f} "
            f"(route {ms['route'] / ms['serve']:.1%}, scan "
            f"{ms['scan'] / ms['serve']:.1%}, tail {ms['tail'] / ms['serve']:.1%}"
            f" of the batch); {res['num_blocks']} blocks, "
            f"{res['num_padding_blocks']} padding; "
            f"{st['scanned_padding_rows']} padding rows in the "
            f"{res['num_blocks'] - res['num_padding_blocks']} blocks the scan "
            f"reads ({st['scanned_padding_rows'] / scanned_rows:.1%}), "
            f"{st['padding_rows']} in all; launches {launches} {tag}")
        assert launches == want, (launches, want)
        assert ms["serve"] > 0 and ms["route"] > 0 and ms["scan"] > 0, ms
        assert abs(res["tail_ms_exact"] - (
            res["serve_exact"]["ms_batch"] - res["route_only_ms"]
            - res["scan_phase2_exact_ms"])) <= TAIL_ROUND, res
        kernels.reset_launches()

    # ---- (a) cli.serve_tail_profile at the bench configuration ----
    argv = ["--cache-dir", cache_dir, "--out",
            os.path.join(cache_dir, "serve_tail_profile.json"), "--device",
            str(dev)]
    log("serve tail (a): python -m gpann_tpu_torch.cli.serve_tail_profile "
        + " ".join(argv))
    kernels.reset_launches()
    st = {}
    res = stp.run(stp.parse_args(argv), st)
    assert res is not None, "serve_tail_profile found no bench cache"
    check(res, st, "blobs", st["nprobes"])
    log(f"serve tail (a): recall {res['serve_exact']['recall']:.4f} (shipped "
        f"{BLOBS_SERVE_RECALL}; need within {RECALL_SLACK}); "
        f"{res['num_blocks']} blocks (path 1's B1 entry: {serve_blocks}); "
        f"{time.perf_counter() - t_phase:.3f} s")
    assert abs(res["serve_exact"]["recall"] - BLOBS_SERVE_RECALL) <= RECALL_SLACK
    assert st["nprobes"] == NPROBES and res["num_blocks"] == serve_blocks
    # (a)'s tail is grouping and merge; (b)'s lies within the windows' noise
    # on the card (PERF.md, phase 12), so only (a) holds its sign
    assert st["ms"]["tail"] > 0, st["ms"]
    engine = st["engine"]
    q_dev = torch.from_numpy(st["queries"]).to(dev)
    name = "bintop2_blocks (serve tail, blobs)"
    entries = [_kernel_entry(name, want["bintop2_blocks"], measure_serve_scan(
        name, engine, q_dev, NPROBES, stp.VOTING_T, tag))]
    del engine, st
    torch.cuda.empty_cache()

    # ---- (b) the same split on path 4's hard engine ----
    t0 = time.perf_counter()
    engine, nprobes = hard["engine"], hard_out["nprobes"]
    batches = generate_queries("hard", TAIL_HARD_WINDOW * NQ, D,
                               SEED + 2).reshape(TAIL_HARD_WINDOW, NQ, D)
    kernels.reset_launches()
    st = {}
    res = stp.decompose(engine, hard["points"], hard["queries"], hard["kth"],
                        batches, K, nprobes, HARD_VOTING_T, "min_dist",
                        QUERY_BLOCK, stp.REPS, st)
    check(res, st, "hard", nprobes)
    log(f"serve tail (b): recall {res['serve_exact']['recall']:.4f} (path "
        f"4's {hard_out['recall_at_10']:.4f}); "
        f"{time.perf_counter() - t0:.3f} s")
    assert res["serve_exact"]["recall"] == hard_out["recall_at_10"]
    assert res["num_blocks"] == -(-NQ * nprobes // QUERY_BLOCK) + SHARDS + 1
    q_dev = torch.from_numpy(hard["queries"]).to(dev)
    name = "bintop2_blocks (serve tail, hard)"
    entries.append(_kernel_entry(name, want["bintop2_blocks"],
                                 measure_serve_scan(
        name, engine, q_dev, nprobes, HARD_VOTING_T, tag,
        atol=term_atol(q_dev, engine.shard_points))))
    kernels.reset_launches()  # the comparisons' launches do not count
    log(f"serve tail phase {time.perf_counter() - t_phase:.3f} s {tag}")
    return entries


def mips_smoke_phase(dev, scratch: str, tag: str) -> list:
    """``cli.mips_smoke`` at the script's size (module docstring, path 12
    (c)), the launches counted stage by stage. Returns the ``kernels``
    entries of B2 at the ground truth and of B1 at the curve and at the
    serve, each held against its plain version at the shape of its one
    launch."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.cli import mips_smoke as ms

    t_phase = time.perf_counter()
    work = os.path.join(scratch, "mips_smoke")
    os.makedirs(work)
    out_csv = os.path.join(work, "mips_smoke.csv")
    argv = [str(MIPS_SMOKE_N), str(MIPS_SMOKE_SHARDS), "--out", out_csv,
            "--device", str(dev)]
    log("mips smoke (c): python -m gpann_tpu_torch.cli.mips_smoke "
        + " ".join(argv))
    launches = {}

    def on_stage(name: str) -> None:
        torch.cuda.synchronize()
        launches[name] = dict(kernels.LAUNCHES)
        kernels.reset_launches()

    state = {}
    kernels.reset_launches()
    summary = ms.run(ms.parse_args(argv), state, on_stage)
    log(f"mips smoke: {time.perf_counter() - t_phase:.3f} s; launches by "
        f"stage {launches}")
    # the ground truth is one launch of B2 (1024 queries over the base), the
    # curve one of B1 (every query at every probe), the serve one of B1;
    # the partition, the router and the engine's build launch nothing
    want = {name: {"binmin_scan": 0, "bintop2_blocks": 0} for name in
            ("data", "ground truth", "partition", "router", "engine",
             "curve", "serve")}
    want["ground truth"]["binmin_scan"] = 1
    want["curve"]["bintop2_blocks"] = want["serve"]["bintop2_blocks"] = 1
    assert launches == want, launches
    with open(out_csv) as f, open(MIPS_SMOKE_CSV) as g:
        rows, shipped_rows = f.read().split(), g.read().split()
    assert rows[0] == shipped_rows[0] == ms.CSV_HEADER
    assert [r.rsplit(",", 1)[0] for r in rows] == [
        r.rsplit(",", 1)[0] for r in shipped_rows]
    curve = np.asarray(summary["curve"], np.float64)
    shipped = np.array([float(r.rsplit(",", 1)[1]) for r in shipped_rows[1:]])
    np.testing.assert_allclose(
        [float(r.rsplit(",", 1)[1]) for r in rows[1:]], curve, atol=5e-5)
    log("mips smoke curve, card against the shipped CSV (device not "
        "recorded):\n" + "\n".join(
            f"  {p + 1:2d}: {c:.4f} {r:.4f} {c - r:+.4f}"
            for p, (c, r) in enumerate(zip(curve, shipped))))
    worst = float((shipped - curve).max())
    log(f"mips smoke: balance {summary['balance']:.4f} (need <= {1 + EPS}); "
        f"curve - shipped >= {-worst:.4f} (need >= -{MIPS_SMOKE_CSV_SLACK}); "
        f"last prefix {curve[-1]:.4f} (need >= {MIPS_SMOKE_LAST_MIN}); "
        f"probes at {ms.TARGET} {summary['nprobes']} (shipped "
        f"{_probes_at(shipped, ms.TARGET)}); serve recall "
        f"{summary['recall']:.4f} {tag}")
    assert summary["balance"] <= 1 + EPS
    _assert_monotone(list(curve), "mips smoke curve")
    assert curve[-1] >= MIPS_SMOKE_LAST_MIN
    assert worst <= MIPS_SMOKE_CSV_SLACK
    assert summary["nprobes"] <= _probes_at(shipped, ms.TARGET)
    assert summary["recall"] >= ms.TARGET

    # each launch's shape against the plain version
    engine = state["engine"]
    q_dev = torch.from_numpy(state["queries"]).to(dev)
    base = torch.tensor(state["points"], device=dev)
    log(f"mips smoke: kernel vs plain at rtol {RTOL}, atol 1e-6 of the "
        "largest |q|^2 + |x|^2")
    name = "binmin_scan (mips smoke GT)"
    entries = [_kernel_entry(name, launches["ground truth"]["binmin_scan"],
                             measure_base_scan(
        name, ", MIPS", q_dev, base, tag, id_rows=256,
        atol=term_atol(q_dev, base), metric="mips"))]
    del base
    atol = term_atol(q_dev, engine.shard_points)
    for what, nprobes in (("curve", MIPS_SMOKE_SHARDS),
                          ("serve", summary["nprobes"])):
        name = f"bintop2_blocks (mips smoke {what})"
        entries.append(_kernel_entry(
            name, launches[what]["bintop2_blocks"],
            measure_serve_scan(name, engine, q_dev, nprobes, ms.VOTING_T,
                               tag, atol=atol)))
    del engine, state
    kernels.reset_launches()  # the comparisons' launches do not count
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    log(f"mips smoke phase {time.perf_counter() - t_phase:.3f} s {tag}")
    return entries


def _read_pq_csv(path: str) -> dict:
    """``{(method, type): curve}`` of a partition-quality CSV."""
    curves = {}
    with open(path) as f:
        assert f.readline().strip().split(",")[:4] == [
            "method", "num probes", "recall", "type"]
        for line in f:
            method, probe, recall, rtype = line.strip().split(",")[:4]
            curves.setdefault((method, rtype), []).append(
                (int(probe), float(recall)))
    return {key: np.array([r for _, r in sorted(c)])
            for key, c in curves.items()}


def partition_quality_phase(dev, scratch: str, tag: str) -> list:
    """``cli.partition_quality`` at the script's size, then every other
    partitioning method through ``cli.partition`` on its base (module
    docstring, path 11), the launches counted stage by stage. Returns the
    ``kernels`` entry of B2 at the ground truth, held against its plain
    version at the shape of its one launch."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.cli import partition as partition_cli
    from gpann_tpu_torch.cli import partition_quality as pq
    from gpann_tpu_torch.core.distances import chunked_topk_neighbors
    from gpann_tpu_torch.core.metis_io import read_clusters
    from gpann_tpu_torch.core.partition import (clusters_to_cover,
                                                clusters_to_partition)
    from gpann_tpu_torch.core.pointset import write_points
    from gpann_tpu_torch.eval.recall import oracle_recall
    from gpann_tpu_torch.gp.partitioning import random_partition

    t_phase = time.perf_counter()
    work = os.path.join(scratch, "pq")
    os.makedirs(work)
    out_csv = os.path.join(work, pq.default_out(PQ_KIND))
    argv = [str(PQ_N), str(PQ_SHARDS), PQ_KIND, "--out", out_csv, "--device",
            str(dev)]
    log("partition quality (a): python -m gpann_tpu_torch.cli."
        "partition_quality " + " ".join(argv))
    launches = {}

    def on_stage(name: str) -> None:
        torch.cuda.synchronize()
        launches[name] = dict(kernels.LAUNCHES)
        kernels.reset_launches()

    state = {}
    kernels.reset_launches()
    summary = pq.run(pq.parse_args(argv), state, on_stage)
    secs_a = time.perf_counter() - t_phase
    log(f"partition quality (a): {secs_a:.3f} s; launches by stage "
        f"{launches}")
    log("partition quality summary (the CLI's JSON): " + json.dumps(summary))
    # the ground truth is one launch of B2 (1024 queries, one block, over the
    # whole base); partitions and routers launch nothing
    want = {name: {"binmin_scan": 0, "bintop2_blocks": 0} for name in
            ["data", "ground truth"]
            + [f"{m} {step}" for m in pq.METHODS
               for step in ("partition",) + pq.ROUTED_TYPES]}
    want["ground truth"]["binmin_scan"] = 1
    assert launches == want, launches

    n, cap = PQ_N, int((1 + EPS) * np.ceil(PQ_N / PQ_SHARDS))
    gt_ids = state["gt_ids"]
    got = _read_pq_csv(out_csv)
    assert len(got) == len(pq.METHODS) * 3
    for method in pq.METHODS:
        clusters = state[method]["clusters"]
        sizes = np.array([len(c) for c in clusters])
        ids = np.sort(np.concatenate(clusters))
        log(f"partition quality {method}: sizes {sizes.min()}..{sizes.max()} "
            f"(cap {cap}), build {summary[method]['build_s']:.3f} s, device "
            f"peak {(summary[method]['peak_bytes'] or 0) / 2**30:.2f} GiB "
            f"{tag}")
        assert len(clusters) == PQ_SHARDS
        assert np.array_equal(ids, np.arange(n)), f"{method}: not a partition"
        if method == "Random":
            assert sizes.max() - sizes.min() <= 1, sizes
        else:
            assert sizes.max() <= cap, (method, sizes)
        oracle = state[method]["oracle"]
        _assert_monotone(list(oracle), f"{method} oracle curve")
        assert abs(oracle[-1] - 1.0) <= 1e-12, (method, oracle)
        # the CSV holds each value to four places
        assert np.abs(got[(method, "oracle")] - oracle).max() <= 5.001e-5
        for rtype in pq.ROUTED_TYPES:
            curve = state[method][rtype]["curve"]
            over = float((curve - oracle).max())
            log(f"partition quality {method} {rtype}: " + " ".join(
                f"{p + 1}:{r:.4f}" for p, r in enumerate(curve[:8]))
                + f"; routed - oracle <= {over:.5f} (need <= "
                f"{PQ_ORACLE_SLACK}) {tag}")
            _assert_monotone(list(curve), f"{method} {rtype} curve")
            assert over <= PQ_ORACLE_SLACK, (method, rtype, over)
            assert np.abs(got[(method, rtype)] - curve).max() <= 5.001e-5

    # the script's own claims (validate_partition_quality.py:3-5)
    at1 = {(m, t): float(got[(m, t)][0]) for m, t in got}
    log("partition quality @1 (oracle / tree-routed / centroid-routed): "
        + "; ".join(f"{m} {at1[(m, 'oracle')]:.4f} / {at1[(m, 'routed')]:.4f}"
                    f" / {at1[(m, 'routed-centroid')]:.4f}"
                    for m in pq.METHODS) + f" {tag}")
    better = max(("GP", "BalancedKMeans"),
                 key=lambda m: at1[(m, "routed-centroid")])
    log(f"partition quality: under the centroid router {better} leads at one "
        "probe (logged, not held: GP's shards are not centroid-shaped)")
    assert at1[("GP", "oracle")] > at1[("BalancedKMeans", "oracle")], at1
    assert at1[("GP", "routed")] > at1[("BalancedKMeans", "routed")], at1
    random_at1 = at1[("Random", "oracle")]
    for method in ("GP", "BalancedKMeans"):
        assert at1[(method, "oracle")] >= random_at1 + PQ_RANDOM_MARGIN, at1

    # against the TPU's CSV of the same experiment
    ref = _read_pq_csv(PQ_CSV)
    for key in sorted(got):
        log(f"partition quality {key[0]} {key[1]}, card (card - TPU CSV): "
            + " ".join(f"{p + 1}:{x:.4f} ({x - y:+.4f})"
                       for p, (x, y) in enumerate(zip(got[key], ref[key])))
            + f" {tag}")
    gap = float(np.abs(got[("Random", "oracle")]
                       - ref[("Random", "oracle")]).max())
    log(f"partition quality Random oracle within {gap:.4f} of the TPU CSV "
        f"(need <= {PQ_RANDOM_CSV_TOL})")
    assert gap <= PQ_RANDOM_CSV_TOL, gap
    for method in ("GP", "BalancedKMeans"):
        for rtype in ("oracle", "routed"):
            assert got[(method, rtype)][0] >= (
                ref[(method, rtype)][0] - PQ_CSV_SLACK), (
                method, rtype, got[(method, rtype)][0], ref[(method, rtype)][0])

    # B2 at the ground truth's shape against its plain version
    pts = state["points"]
    q_dev = torch.from_numpy(state["queries"]).to(dev)
    base = torch.from_numpy(pts).to(dev)
    name = "binmin_scan (partition-quality GT)"
    log(f"partition quality: kernel vs plain at rtol {RTOL}, atol 1e-6 of the "
        "largest |q|^2 + |x|^2")
    entries = [_kernel_entry(
        name, launches["ground truth"]["binmin_scan"],
        measure_base_scan(name, ", hard", q_dev, base, tag, id_rows=256,
                          atol=term_atol(q_dev, base)))]
    del base
    torch.cuda.empty_cache()
    kernels.reset_launches()  # the comparison's launches do not count

    # ---- (b) every other method through cli.partition ----
    t_b = time.perf_counter()
    base_f = os.path.join(work, "base.fbin")
    write_points(base_f, pts)
    prefix_gt = {n: gt_ids}

    def gt_of(rows: int) -> np.ndarray:
        """Ground truth of the queries over the first ``rows`` points: the
        phase's, or an exact fp32 top-k (plain PyTorch, no kernel)."""
        if rows not in prefix_gt:
            prefix_gt[rows] = chunked_topk_neighbors(
                state["queries"], pts[:rows], K, device=dev)[1]
        return prefix_gt[rows]

    def random_at_1(rows: int) -> float:
        return float(oracle_recall(gt_of(rows), partition=random_partition(
            rows, PQ_SHARDS, SEED), num_shards=PQ_SHARDS)[0])

    runs = [(m, PQ_METHODS_N, 0.0) for m in PQ_METHODS] + [
        (m, PQ_OVERLAP_N, PQ_OVERLAP) for m in PQ_OVERLAP_METHODS]
    for method, rows, overlap in runs:
        prefix = os.path.join(work, f"p{rows}")
        cli_argv = [base_f, prefix, str(PQ_SHARDS), method, str(overlap),
                    "l2", str(rows)]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        assert partition_cli.main(cli_argv + ["--device", str(dev)]) == 0
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        used = dict(kernels.LAUNCHES)
        # the CLI names every method that starts with "O" by its overlap,
        # OurPyramid's partition too (partition.cpp:46-61)
        suffix = f".k={PQ_SHARDS}.{method}" + (
            f".o={float(overlap)}" if method.startswith("O") else "")
        clusters = read_clusters(prefix + suffix)
        sizes = np.array([len(c) for c in clusters])
        covered = np.unique(np.concatenate(clusters))
        if overlap:
            oracle = oracle_recall(gt_of(rows), cover=clusters_to_cover(
                clusters, rows), num_shards=len(clusters))
            bound = int((1 + EPS) * rows / PQ_SHARDS)
        else:
            oracle = oracle_recall(gt_of(rows), partition=clusters_to_partition(
                clusters, rows), num_shards=len(clusters))
            bound = int((1 + EPS) * np.ceil(rows / PQ_SHARDS))
        floor = random_at_1(rows) + PQ_RANDOM_MARGIN
        log(f"partition quality (b) {method} on {rows} rows"
            + (f", overlap {overlap}" if overlap else "")
            + f": {secs:.3f} s, device peak {peak:.2f} GiB, {len(clusters)} "
            f"clusters, sizes {sizes.min()}..{sizes.max()} (bound {bound}"
            + (", none for FlatKMeans" if method == "FlatKMeans" else "")
            + f"), {sizes.sum()} assignments, {len(covered)} covered, oracle "
            + " ".join(f"{p}:{oracle[p - 1]:.4f}" for p in (1, 2, 4))
            + f" (Random + {PQ_RANDOM_MARGIN}: {floor:.4f}), launches {used} "
            f"{tag}")
        assert all(v == 0 for v in used.values()), (method, used)
        assert len(covered) == rows and covered[-1] == rows - 1, method
        _assert_monotone(list(oracle), f"{method} oracle curve")
        if overlap:  # OGPS, OBKM, ORKM may keep more than k clusters
            assert sizes.max() <= bound, (method, sizes)
            assert sizes.sum() <= rows + int(overlap * rows), method
        else:
            assert sizes.sum() == rows, method  # every id once
            if method != "FlatKMeans":  # no balance guarantee
                assert sizes.max() <= bound, (method, sizes)
            assert oracle[0] >= floor, (method, oracle[0], floor)
    kernels.reset_launches()
    shutil.rmtree(work)
    log(f"partition quality phase {time.perf_counter() - t_phase:.3f} s "
        f"((a) {secs_a:.3f}, (b) {time.perf_counter() - t_b:.3f}) {tag}")
    return entries


def analysis_phase(dev, pts: np.ndarray, q: np.ndarray, qa_files: dict,
                   scratch: str, tag: str) -> dict:
    """The three analysis CLIs once each (module docstring, path 6): graph
    quality and approximation losses on a prefix of the points, extract
    recall (oracle mode) on path 3's routes. Returns the kernel launches."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.cli import analyze_approximation_losses as losses_cli
    from gpann_tpu_torch.cli import extract_recall
    from gpann_tpu_torch.cli import graph_quality_benchmark as gq_cli
    from gpann_tpu_torch.cli import partition as partition_cli
    from gpann_tpu_torch.core.pointset import write_points

    path = lambda name: os.path.join(scratch, name)  # noqa: E731
    dev_arg = ["--device", str(dev)]
    prefix = min(QA_PREFIX, len(pts))
    method = "BalancedKMeans"
    kernels.reset_launches()
    write_points(path("an_base1B.fbin"), pts[:prefix])
    write_points(path("an_query.fbin"), q[:QA_NQ])
    assert partition_cli.main([path("an_base1B.fbin"), path("an.partition"),
                               str(SHARDS), method] + dev_arg) == 0
    part_f = path(f"an.partition.k={SHARDS}.{method}")

    # ---- graph quality: one configuration of the grid ----
    t0 = time.perf_counter()
    for name, grid in GQ_GRID.items():
        setattr(gq_cli, name, grid)
    assert gq_cli.main([path("an_base1B.fbin"), path("an_query.fbin"), str(K),
                        str(SHARDS), path("gq.csv")] + dev_arg) == 0
    with open(path("gq.csv")) as f:
        assert f.readline().strip() == (
            "reps,fanout,max_cluster_size,degree,graph_recall,"
            "first_shard_oracle_recall")
        rows = [line.strip().split(",") for line in f]
    assert len(rows) == 1 and len(rows[0]) == 6, rows
    grecall, first = float(rows[0][4]), float(rows[0][5])
    assert 0.0 <= grecall <= 1.0 and 0.0 <= first <= 1.0
    log(f"graph quality on {prefix} rows, (reps, fanout, cluster size, degree) "
        f"{tuple(rows[0][:4])}: graph recall {grecall:.4f}, first-shard oracle "
        f"recall {first:.4f}; {time.perf_counter() - t0:.3f} s {tag}")

    # ---- approximation losses ----
    t0 = time.perf_counter()
    assert losses_cli.main([path("an_base1B.fbin"), path("an_query.fbin"),
                            path("an_ground-truth.bin"), str(K), part_f, method,
                            path("losses.csv")] + dev_arg) == 0
    curves = {}
    with open(path("losses.csv")) as f:
        assert f.readline().strip() == "partitioning,num probes,recall,type"
        for line in f:
            _, probe, recall, kind = line.strip().split(",")
            curves.setdefault(kind, []).append((int(probe), float(recall)))
    assert set(curves) == {"brute-force-routing", "kmeans-tree-sample",
                           "uniform-sample", "single-center"}, set(curves)
    for kind, curve in curves.items():
        recalls = [r for _, r in sorted(curve)]
        assert len(recalls) == SHARDS and 0.0 <= recalls[0] <= recalls[-1] <= 1.0
        _assert_monotone(recalls, kind)
        log(f"approximation losses {kind}: recall@10 " + " ".join(
            f"{p + 1}:{recalls[p]:.4f}" for p in (0, 1, 3, SHARDS - 1)
            if p < SHARDS))
    log(f"approximation losses: {time.perf_counter() - t0:.3f} s {tag}")

    # ---- extract recall: the oracle curves of path 3's routes ----
    t0 = time.perf_counter()
    data, outp = path("extract_in"), path("extract_out")
    os.makedirs(data)
    os.makedirs(outp)
    cover_name = os.path.basename(qa_files["cover"])   # bench.k=32.OGP.o=0.2
    sfx = cover_name.split(".OGP", 1)[1]
    os.symlink(qa_files["gt"], os.path.join(data, "bench_ground-truth.bin"))
    os.symlink(qa_files["cover"],
               os.path.join(data, f"bench.partition.k={SHARDS}.OGP{sfx}"))
    os.symlink(qa_files["routes"], os.path.join(outp, f"{cover_name}.routes"))
    assert extract_recall.main([data, outp, "--datasets", "bench:l2",
                                "--methods", "OGP", "--shards", str(SHARDS),
                                "--overlap", str(QA_OVERLAP), "--mode",
                                "oracle"] + dev_arg) == 0
    by_route = {}
    with open(os.path.join(outp, f"bench.OGP.k={SHARDS}{sfx}.oracle_recall")) as f:
        f.readline()
        for line in f:
            c = line.strip().split(",")
            by_route.setdefault(tuple(c[3:]), []).append((int(c[1]), float(c[2])))
    assert by_route
    for key, curve in by_route.items():
        recalls = [r for _, r in sorted(curve)]
        assert 0.0 <= recalls[0] and recalls[-1] <= 1.0, key
        _assert_monotone(recalls, key)
    log(f"extract recall (oracle mode): {len(by_route)} curves, each monotone "
        f"in probes and inside [0, 1]; {time.perf_counter() - t0:.3f} s {tag}")
    launches = dict(kernels.LAUNCHES)
    log(f"launches on the analysis path: {launches}")
    assert launches["binmin_scan"] > 0, launches
    return launches


def _multirank_steps(engine, q: np.ndarray, dev, cfg: dict) -> dict:
    """One batch through ``engine.serve_device`` as it is, twice: once
    alone, for its wall milliseconds (a synchronisation at the end), then
    with a recorder installed for its split by the spans that
    ``serve_device`` records (``dist.mesh.SERVE_STEPS``): per step, summed
    over the microbatches, the host milliseconds between the spans' edges
    and the stream milliseconds between their CUDA events (nan off the
    card), and the seconds the recorded call took in all (the barrier and
    the recorder's drain included). The ranks meet at a barrier before each
    batch (outside the steps), so that no rank's first exchange waits for
    another's start."""
    import torch.distributed as dist

    from gpann_tpu_torch.core import profiling
    from gpann_tpu_torch.dist.mesh import SERVE_STEPS

    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    qd = torch.from_numpy(q).to(dev)

    def batch():
        engine.serve_device(qd, cfg["k"], cfg["nprobes"],
                            voting_t=cfg["voting_t"],
                            microbatch=cfg["microbatch"])
        sync()

    sync()
    dist.barrier()
    t0 = time.perf_counter()
    batch()
    out = {"wall": (time.perf_counter() - t0) * 1e3}
    t0 = time.perf_counter()
    dist.barrier()
    with profiling.recording(profiling.Recorder()) as rec:
        batch()
    spans = rec.drain().spans
    out["record_s"] = time.perf_counter() - t0
    for step in SERVE_STEPS:
        mine = [sp for sp in spans if sp.name == step]
        assert mine, step
        out[step] = (sum(sp.end_ns - sp.start_ns for sp in mine) / 1e6,
                     sum(sp.stream_ms for sp in mine) if cuda
                     else float("nan"))
    return out


def multirank_rank(scratch: str, dp: int, voting_impl: str, device: str) -> dict:
    """One rank of the multi-rank phase, in a process of its own (started by
    ``run_ranks``; all ranks on ``device``): builds its part of the
    serving engine from the memory-mapped points (only its own shards),
    serves the queries, searches the check queries on the given probes,
    times one batch and splits it by step (:func:`_multirank_steps`) and
    runs two sharded Lloyd rounds. Its
    inputs and sizes come from ``mr_inputs.npz``, which the phase writes."""
    from gpann_tpu_torch import kernels
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.dist import (DistributedServingEngine, shard_mesh,
                                      sharded_lloyd_round)

    dev = torch.device(device)
    mesh = shard_mesh(dp=dp)
    pts = np.load(os.path.join(scratch, "mr_points.npy"), mmap_mode="r")
    inp = dict(np.load(os.path.join(scratch, "mr_inputs.npz")))
    cfg = {key: int(inp[key]) for key in ("shards", "k", "nprobes", "voting_t",
                                          "microbatch", "lloyd_n", "lloyd_k")}
    q, k = inp["queries"], cfg["k"]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (
        lambda: None)
    t0 = time.perf_counter()
    engine = DistributedServingEngine(
        pts, partition_to_clusters(inp["assign"], cfg["shards"]),
        inp["routing_points"], inp["routing_labels"], mesh=mesh,
        voting_impl=voting_impl, device=dev, backend="gloo")
    sync()
    build_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    d, i = engine.serve(q, k, cfg["nprobes"], voting_t=cfg["voting_t"],
                        microbatch=cfg["microbatch"])
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cd, ci = engine.search_probed(q[: len(inp["check_probes"])],
                                  inp["check_probes"], k)
    steps = _multirank_steps(engine, q, dev, cfg)
    step = sharded_lloyd_round(mesh, cfg["lloyd_k"], device=dev,
                               backend="gloo")
    rows = np.array_split(np.arange(cfg["lloyd_n"]), mesh.world)[mesh.rank]
    mine = np.array(pts[rows[0] : rows[-1] + 1])  # a writable copy
    lloyd = [tuple(t.cpu().numpy() for t in step(mine, inp["lloyd_init"]))
             for _ in range(2)]
    return dict(rank=mesh.rank, mesh=mesh.shape, build_s=build_s,
                serve_s=serve_s, shards=int(engine.shard_points.shape[0]),
                capacity=engine.capacity, d=d, i=i, check_d=cd, check_i=ci,
                steps=steps, lloyd=lloyd, launches=launches)


def multirank_phase(dev, pts: np.ndarray, q: np.ndarray, art: dict,
                    kth: np.ndarray, serve_recall: float, scratch: str,
                    tag: str) -> dict:
    """The multi-rank engines (module docstring, path 7): 2 ranks (dp 1 x
    shard 2, exact voting), then 4 (dp 2 x shard 2, binned voting), all
    sharing the card over gloo, then ``cli.distributed_bench`` through
    ``torch.distributed.run``. Returns the ``kernels`` entry of B2 at the
    shape of the ranks' routing (one microbatch against the routing points)
    with the launches of the ranks' serves."""
    import chip_smoke as this  # the ranks import their function by module
    from gpann_tpu_torch.cluster.kmeans import _nearest64, random_sample
    from gpann_tpu_torch.core.distances import sq_norms
    from gpann_tpu_torch.core.metis_io import write_clusters
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.core.pointset import write_points
    from gpann_tpu_torch.dist.launch import free_port, run_ranks
    from gpann_tpu_torch.dist.mesh import SERVE_STEPS
    from gpann_tpu_torch.eval.recall import recall_from_ids
    from gpann_tpu_torch.search.ivf import IVFIndex
    from gpann_tpu_torch.search.serve import _probe_rank

    t_phase = time.perf_counter()
    path = lambda name: os.path.join(scratch, name)  # noqa: E731
    assign = art["assign"].astype(np.int32)
    clusters = partition_to_clusters(assign, SHARDS)
    rp = np.asarray(art["routing_points"], np.float32)
    t0 = time.perf_counter()
    np.save(path("mr_points.npy"), pts)
    check_q = q[:MR_CHECK_NQ]
    probes = _probe_rank(
        torch.from_numpy(check_q).to(dev), torch.from_numpy(rp).to(dev),
        torch.from_numpy(art["routing_labels"].astype(np.int64)).to(dev),
        torch.from_numpy((rp.astype(np.float64) ** 2).sum(1).astype(
            np.float32)).to(dev), s=SHARDS, voting_t=VOTING_T,
        rule="min_dist", spann_eps=0.6, nprobes=MR_CHECK_NPROBES,
        metric="l2", voting_impl="exact").cpu().numpy()
    lloyd_init = random_sample(pts[:MR_LLOYD_N], MR_LLOYD_K, seed=SEED)
    np.savez(path("mr_inputs.npz"), queries=q, assign=assign,
             routing_points=rp, routing_labels=art["routing_labels"],
             check_probes=probes, lloyd_init=lloyd_init, shards=SHARDS, k=K,
             nprobes=NPROBES, voting_t=VOTING_T, microbatch=MR_MICROBATCH,
             lloyd_n=MR_LLOYD_N, lloyd_k=MR_LLOYD_K)
    log(f"multi-rank: inputs written in {time.perf_counter() - t0:.3f} s")

    # the references: one process, the same probes / prefix
    ivf = IVFIndex(pts, clusters, device=dev)
    want_d, want_i = ivf.search_probed(check_q, probes, K)
    del ivf
    p64 = torch.from_numpy(pts[:MR_LLOYD_N]).to(dev).double()
    want_assign = _nearest64(p64, sq_norms(p64),
                             torch.from_numpy(lloyd_init).to(dev),
                             "l2").cpu().numpy()
    del p64
    torch.cuda.empty_cache()

    launches = {"binmin_scan": 0, "bintop2_blocks": 0}
    for world, dp, voting in MR_RUNS:
        t0 = time.perf_counter()
        outs = run_ranks(this.multirank_rank, world,
                         (scratch, dp, voting, str(dev)), timeout=MR_TIMEOUT)
        secs = time.perf_counter() - t0
        what = f"multi-rank {world} ranks (dp {dp} x shard {world // dp}, " \
               f"voting {voting})"
        first = outs[0]
        for out in outs:
            assert out["mesh"] == {"dp": dp, "shard": world // dp}
            for key in ("d", "i", "check_d", "check_i"):
                np.testing.assert_array_equal(out[key], first[key], key)
            for c, a in out["lloyd"]:
                np.testing.assert_array_equal(c, first["lloyd"][0][0])
                np.testing.assert_array_equal(a, first["lloyd"][0][1])
        d, i = first["d"], first["i"]
        assert d.shape == (NQ, K) and np.isfinite(d).all()
        assert ((i >= 0) & (i < N)).all()
        recall = recall_from_ids(pts, q, i, kth, K)
        log(f"{what}: {secs:.3f} s; recall@10 nprobes={NPROBES} {recall:.5f} "
            f"(resident engine {serve_recall:.5f}; need within {RECALL_SLACK})")
        assert abs(recall - serve_recall) <= RECALL_SLACK
        np.testing.assert_allclose(first["check_d"], want_d, rtol=RTOL,
                                   atol=ATOL)
        assert (np.sort(first["check_i"], 1) == np.sort(want_i, 1)).all()
        log(f"{what}: {MR_CHECK_NQ} queries at {MR_CHECK_NPROBES} probes "
            f"against IVFIndex.search_probed: distances within rtol {RTOL}, "
            f"ids equal as sets")
        (c, a), _ = first["lloyd"]
        np.testing.assert_array_equal(a, want_assign)
        log(f"{what}: sharded Lloyd round (k {MR_LLOYD_K}, {MR_LLOYD_N} "
            f"points) equal on every rank and in two calls, assignment equal "
            f"to one process's; {int((np.bincount(a, minlength=MR_LLOYD_K) > 0).sum())} "
            f"clusters kept members")
        for out in outs:
            st = out["steps"]
            log(f"{what} rank {out['rank']}: {out['shards']} shards, capacity "
                f"{out['capacity']}, built in {out['build_s']:.3f} s, serve "
                f"{out['serve_s']:.3f} s; one {NQ}-query serve_device batch "
                f"{st['wall']:.3f} ms wall; recorded, host / stream ms by "
                f"step: " + ", ".join(
                    f"{step} {st[step][0]:.3f} / {st[step][1]:.3f}"
                    for step in SERVE_STEPS)
                + f" (the recorded call {st['record_s']:.3f} s in all); "
                f"launches {out['launches']} {tag}")
            for name in launches:
                launches[name] += out["launches"][name]
        if voting == "binned":
            assert all(o["launches"]["binmin_scan"] > 0 for o in outs)
    # the ranks' scans are plain; their only kernel is B2 in the routing
    assert launches["bintop2_blocks"] == 0 and launches["binmin_scan"] > 0, \
        launches

    # B2 against its plain version at the shape of one rank's routing step
    qs = torch.from_numpy(q[:MR_MICROBATCH]).to(dev)
    rp_dev = torch.from_numpy(rp).to(dev)
    entry = _kernel_entry(
        "binmin_scan (multi-rank route)", launches["binmin_scan"],
        measure_base_scan("binmin_scan (multi-rank route)",
                          ", one microbatch against the routing points", qs,
                          rp_dev, tag, atol=term_atol(qs, rp_dev)))
    del qs, rp_dev

    # ---- cli.distributed_bench through the launcher ----
    t0 = time.perf_counter()
    write_points(path("mr_base.fbin"), pts[:MR_BENCH_N])
    write_points(path("mr_query.fbin"), q[:MR_BENCH_NQ])
    write_clusters(path("mr_part"), partition_to_clusters(
        assign[:MR_BENCH_N], SHARDS))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
         "-m", "gpann_tpu_torch.cli.distributed_bench", path("mr_base.fbin"),
         path("mr_query.fbin"), str(K), path("mr_part"), str(NPROBES),
         "--distributed", "--device", dev.type, "--backend", "gloo"],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=MR_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"distributed_bench exited with {proc.returncode}:"
                           f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().split("\n")
    for line in lines:
        log(f"distributed_bench: {line}")
    assert len(lines) == 5 and lines[0].startswith(f"2 ranks ({dev.type})"), lines
    log(f"distributed_bench on {MR_BENCH_N} points, {MR_BENCH_NQ} queries, "
        f"2 ranks: "
        f"{time.perf_counter() - t0:.3f} s {tag}")
    log(f"multi-rank phase {time.perf_counter() - t_phase:.3f} s {tag}")
    return entry


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
    assert not torch.backends.cuda.matmul.allow_tf32
    # ids are checked on the first 256 queries: the gather is 12 MB a row
    stats = {
        "binmin_scan": measure_base_scan("binmin_scan", "", q_dev, base, tag,
                                         id_rows=256, reps=3),
        "bintop2_blocks": measure_serve_scan("bintop2_blocks", engine, q_dev,
                                             NPROBES, VOTING_T, tag),
    }
    serve_blocks = int(engine.scan_inputs(
        q_dev, NPROBES, voting_t=VOTING_T, query_block=QUERY_BLOCK)[1].shape[0])

    brute_ms = cuda_ms(lambda: bs.fused_topk(q_dev, base, N, K), reps=3)
    log(f"brute fused_topk {brute_ms:.3f} ms/batch of {NQ} "
        f"({NQ / brute_ms * 1e3:.1f} QPS) {tag}")
    serve_ms = cuda_ms(lambda: engine.serve_device(
        q_dev, K, NPROBES, voting_t=VOTING_T, query_block=QUERY_BLOCK), reps=10)
    log(f"serve {serve_ms:.3f} ms/batch of {NQ} ({NQ / serve_ms * 1e3:.1f} QPS), "
        f"nprobes={NPROBES}, {brute_ms / serve_ms:.2f}x brute {tag}")
    if profile_only:
        profile_batch(lambda: engine.serve_device(
            q_dev, K, NPROBES, voting_t=VOTING_T, query_block=QUERY_BLOCK),
            "serve", tag, rows=14)
        return 0

    # ---- cold build: the port builds the artifacts itself ----
    shipped = {key: art[key] for key in ("gt_ids", "gt_dists", "routing_points")}
    shipped["assign"] = art["assign"].astype(np.int32)
    shipped["curve"] = ref_curve
    shipped["first_probe"] = engine.probe_order(q_dev, 1, voting_t=VOTING_T)
    del engine, base
    torch.cuda.empty_cache()
    build_launches = cold_build(dev, pts, q, shipped, tag)
    torch.cuda.empty_cache()

    hard_art = dict(np.load(HARD_ARTIFACT))
    hard_art["assign"] = hard_art["assign"].astype(np.int32)
    hard_art["curve"] = hard_art["curve"].astype(np.float64)
    scratch = tempfile.mkdtemp(prefix="gpann_smoke_")
    try:
        # ---- query attribution through the port's CLIs ----
        qa_launches, qa_files = query_attribution(dev, pts, q, shipped, tag,
                                                  scratch)
        os.remove(os.path.join(scratch, "base.fbin"))
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")

        # ---- the bench, both configs; the streamed engine ----
        bench_launches, hard, hard_out, b1_hard = bench_phase(
            dev, pts, q, hard_art, os.path.join(scratch, "cache"), tag)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")
        stream_launches, b2_shard = streamed_phase(
            dev, hard, hard_out, hard_art, os.path.join(scratch, "store"), tag)
        shutil.rmtree(os.path.join(scratch, "store"))
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")

        # ---- the served batch split, blobs and hard ----
        tail_entries = tail_phase(dev, hard, hard_out,
                                  os.path.join(scratch, "cache"),
                                  serve_blocks, tag)
        del hard["engine"]
        torch.cuda.empty_cache()
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")

        # ---- MIPS on the hard base: the overlap pipeline, scale_bench ----
        mips_entries = mips_phase(
            dev, hard, os.path.join(scratch, "mips"), tag)
        del hard
        shutil.rmtree(os.path.join(scratch, "mips"))
        shutil.rmtree(os.path.join(scratch, "cache"))
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")

        # ---- scale_bench and the analysis CLIs ----
        scale_launches, bkm_curve = scale_phase(
            dev, os.path.join(scratch, "scale"), tag)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")
        gp_entries = scale_gp_phase(dev, os.path.join(scratch, "scale"),
                                    bkm_curve, tag)
        shutil.rmtree(os.path.join(scratch, "scale"))
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")
        analysis_launches = analysis_phase(dev, pts, q, qa_files, scratch, tag)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")
        fid_entries = fidelity_phase(dev, scratch, tag)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")
        pq_entries = partition_quality_phase(dev, scratch, tag)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")
        mips_smoke_entries = mips_smoke_phase(dev, scratch, tag)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")

        # ---- the multi-rank engines, ranks sharing the card ----
        b2_route = multirank_phase(dev, pts, q, art, kth, serve_recall,
                                   scratch, tag)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # launches: paths 1-6's runs for the two entry points at path 1's
    # shapes; the paths' own for the entries at their shapes (path 7's B2
    # at the routing shape only; paths 8, 9, 10, 11 and 12's, each at the
    # shape of the launches it counts)
    paths = (launches, build_launches, qa_launches, bench_launches,
             stream_launches, scale_launches, analysis_launches)
    print(json.dumps({"kernels": [
        _kernel_entry(name, sum(p[name] for p in paths), stats[name])
        for name in ("binmin_scan", "bintop2_blocks")]
        + [b2_shard, b1_hard, b2_route] + mips_entries + gp_entries
        + fid_entries + pq_entries + tail_entries + mips_smoke_entries}),
          flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--profile"]):
        raise SystemExit(__doc__)
    sys.exit(main(profile_only=sys.argv[1:] == ["--profile"]))
