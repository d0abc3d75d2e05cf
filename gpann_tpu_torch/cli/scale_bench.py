"""Scale demonstration of the streamed path: partition + route + serve a
base that stays on the host (counterpart of ``gpann_tpu/cli/scale_bench.py``).

The reference's 1B-scale choreography keeps only owned shards per rank and
streams points from disk (``src/distributed_query_benchmark.h:48-84``); the
coordinator never holds the base. This CLI is the single-device analog:

1. chunk-generate the base straight into a disk memmap (eval/synth.py), or
   regenerate it on the fly (``--base virtual``),
2. partition with :func:`streaming_capacity_partition` (Lloyd on an in-RAM
   subsample + ONE streamed admission pass; balance <= (1+eps)ceil(n/k)), or
   fused with the shard-major relayout (``--layout shard-major``),
3. ground truth via :func:`streaming_topk_neighbors` (chunked exact scan),
4. train the k-means-tree router on a subsample (the reference subsamples
   for Pyramid at scale, partitioning.cpp:271-276),
5. stream shard-at-a-time through the device with
   :class:`~gpann_tpu_torch.search.streamed.StreamedShardEngine` and report
   the full recall-vs-nprobes curve from ONE pass over the base.

Every stage artifact is cached under ``GPANN_CACHE_DIR`` (default
``~/.cache/gpann_tpu``) with its build seconds in a ``.time`` sidecar, so
reruns skip completed stages. Output: a CSV of curve points + a summary JSON
line, with the JAX CLI's header and keys.

Not carried over from the JAX CLI: ``--isolate-stages``, ``--shard-chunk``,
``--curve-partial`` and ``--until``. They run stages in child processes to
bound a host-memory leak of that package's device client, which PyTorch
does not have. ``--assign-chunks`` stays: an interrupted shard-major
partition stage is resumed by running the command again. ``--device`` is
added (default ``cuda``; raises without a GPU).

Usage:
    python -m gpann_tpu_torch.cli.scale_bench [--n 64000000] [--d 96]
        [--shards 64] [--nq 1024] [--kind hard]
        [--out exp_outputs/scale64m.csv] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

K = 10


def log(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--shards", type=int, default=64)
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--kind", default="hard", choices=("hard", "hard2", "blobs"))
    ap.add_argument("--dtype", default="f32", choices=("f32", "u8", "i8"),
                    help="base storage dtype; byte bases are widened to f32 "
                         "chunk-by-chunk on the fly (points_io.cpp:114-124 "
                         "semantics): 250Mx96 u8 = 24 GB on disk")
    ap.add_argument("--metric", default="l2", choices=("l2", "mips"),
                    help="distance at runtime (the reference needs two "
                         "compile trees, CMakeLists.txt:54-59; T2I-1B is "
                         "MIPS). Threads through partition, GT, router and "
                         "the streamed engine; caches are metric-tagged")
    ap.add_argument("--seed", type=int, default=555)
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--train-sample", type=int, default=4_000_000)
    ap.add_argument("--method", default="bkm", choices=("bkm", "gp"),
                    help="bkm = streamed balanced k-means; gp = subsample-GP"
                         " (kNN graph + LP partition on --gp-subsample points,"
                         " capacity stream-assignment via per-part aggregates"
                         ", partitioning.cpp:305-356 with GP as the coarse"
                         " partitioner)")
    ap.add_argument("--gp-subsample", type=int, default=2_000_000)
    ap.add_argument("--gp-aggregates", type=int, default=4096)
    ap.add_argument("--scan-mode", default="binned",
                    choices=("binned", "exact"),
                    help="shard scan: binned = the bin-top-2 scan (CUDA "
                         "kernel on a GPU); exact = fp32 matmul + top-k")
    ap.add_argument("--sub-nprobe", type=int, default=0,
                    help="in-shard sub-cluster pruning: gather/upload only "
                         "each probing query's t closest sub-clusters of "
                         "every probed shard (0 = whole shard). Cuts "
                         "streamed GB; builds (and caches) a one-pass "
                         "sub-cluster artifact")
    ap.add_argument("--sub-size", type=int, default=65536,
                    help="target points per sub-cluster for --sub-nprobe")
    ap.add_argument("--max-nprobes", type=int, default=0,
                    help="evaluate the recall curve only up to this many "
                         "probes (0 = all shards). With --sub-nprobe this is "
                         "the small-batch serving scenario where in-shard "
                         "pruning actually cuts streamed bytes: only shards "
                         "probed by some query are touched, and only their "
                         "probing queries' closest sub-clusters upload")
    ap.add_argument("--base", default="disk", choices=("disk", "virtual"),
                    help="virtual = zero-disk chunk-regenerating base "
                         "(eval/synth.py::VirtualPoints); at 1B x 96 u8 the "
                         "materialized base alone is 96 GB; the virtual "
                         "base + --layout shard-major writes the base to "
                         "disk exactly once, already in shard order")
    ap.add_argument("--layout", default="rows",
                    choices=("rows", "shard-major"),
                    help="shard-major: fuse the capacity assignment with an "
                         "on-disk relayout (search/relayout.py) so the "
                         "curve pass reads each shard as ONE contiguous "
                         "slice (inverted_index.h:20-41, "
                         "distributed_query_benchmark.h:48-84) instead of "
                         "fancy-indexing scattered rows")
    ap.add_argument("--assign-chunks", type=int, default=0,
                    help="shard-major only: max chunks the partition stage "
                         "processes per invocation (0 = all); the stage "
                         "is checkpointed, run the command again until "
                         "it completes")
    ap.add_argument("--out", default="exp_outputs/scale64m.csv")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every stage (cuda, cuda:N, or cpu "
                         "when asked for)")
    args = ap.parse_args(argv)

    from gpann_tpu_torch.cli import resolve_device
    from gpann_tpu_torch.cluster.streaming import (
        capacity_stream_assign, streaming_capacity_partition)
    from gpann_tpu_torch.core.distances import streaming_topk_neighbors
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.eval import kth_neighbor_distance
    from gpann_tpu_torch.eval.synth import dataset_cached, generate_queries
    from gpann_tpu_torch.route import KMeansTreeRouter, KMeansTreeRouterOptions
    from gpann_tpu_torch.search.streamed import StreamedShardEngine

    device = resolve_device(args.device)
    # GPANN_CACHE_DIR overrides the stage-artifact/store location: a large
    # run should keep its store + stage npzs on a path that is durable
    cache = os.environ.get("GPANN_CACHE_DIR") or os.path.expanduser(
        "~/.cache/gpann_tpu")
    os.makedirs(cache, exist_ok=True)  # virtual bases never touch dataset_cached
    # data + GT caches are method-independent; partition/router are not
    dsuf = "" if args.dtype == "f32" else f"_{args.dtype}"
    if args.metric != "l2":
        dsuf += f"_{args.metric}"
    tag = (f"scale_{args.kind}_{args.seed}_{args.n}_{args.d}_"
           f"{args.shards}{dsuf}")
    mtag = tag if args.method == "bkm" else f"{tag}_{args.method}"
    nprobes_eval = args.max_nprobes if args.max_nprobes > 0 else args.shards
    t_all = time.time()

    store_dir = os.path.join(cache, f"{mtag}_store")
    shard_major = args.layout == "shard-major"

    def _stamp(path: str, seconds: float) -> None:
        with open(path + ".time", "w") as f:
            json.dump({"seconds": seconds}, f)

    def _stamp_add(path: str, seconds: float) -> None:
        """Accumulate build time across resumed invocations of one stage."""
        prev = 0.0
        try:
            with open(path + ".time") as f:
                prev = float(json.load(f)["seconds"])
        except Exception:
            pass
        _stamp(path, prev + seconds)

    def _cached_time(path: str) -> float:
        """Original build time of a cached stage artifact (NaN for caches
        from before timing sidecars existed): cache hits must NOT report
        0.0 build cost."""
        try:
            with open(path + ".time") as f:
                return float(json.load(f)["seconds"])
        except Exception:
            return float("nan")

    t0 = time.time()
    if args.base == "virtual":
        from gpann_tpu_torch.eval.synth import VirtualPoints

        pts = VirtualPoints(args.kind, args.n, args.d, args.seed,
                            dtype=args.dtype)
        pts_path = "<virtual>"
    else:
        pts, pts_path = dataset_cached(args.kind, args.n, args.d, args.seed,
                                       dtype=args.dtype)
    queries = generate_queries(args.kind, args.nq, args.d, args.seed,
                               dtype=args.dtype)
    t_data = time.time() - t0
    log(f"base ready: {pts.shape} at {pts_path} ({t_data:.0f}s)")

    aggs_path = os.path.join(cache, f"{mtag}_aggs.npz")

    def _ensure_aggs():
        """Subsample-GP representatives (steps 1-3 of gp/scale.py), cached."""
        if os.path.exists(aggs_path):
            z = np.load(aggs_path)
            return z["aggs"], z["labels"]
        from gpann_tpu_torch.gp.scale import subsample_gp_aggregates

        t0 = time.time()
        aggs, agg_lbl, _, _ = subsample_gp_aggregates(
            pts, k=args.shards, eps=args.eps, seed=args.seed,
            metric=args.metric, num_subsample=args.gp_subsample,
            num_aggregate=args.gp_aggregates, device=device,
        )
        np.savez(aggs_path, aggs=aggs, labels=agg_lbl)
        _stamp(aggs_path, time.time() - t0)
        if device.type == "cuda":
            import torch

            log(f"GP aggregates of a {args.gp_subsample}-point subsample "
                f"({time.time() - t0:.0f}s): device memory peak "
                f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
        return aggs, agg_lbl

    def _bkm_reps():
        """Lloyd centroids on an in-RAM subsample (train_sample path of
        streaming_capacity_partition); labels = identity."""
        from gpann_tpu_torch.cluster.kmeans import kmeans as _lloyd

        rng = np.random.default_rng(args.seed)
        if getattr(pts, "iid_rows", False):
            sample = np.asarray(pts[: args.train_sample], np.float32)
        else:
            idx = np.sort(rng.choice(
                args.n, size=min(args.train_sample, args.n), replace=False))
            sample = np.asarray(pts[idx], np.float32)
        cents, _ = _lloyd(sample, k=args.shards, metric=args.metric,
                          seed=args.seed, device=device)
        return cents, np.arange(args.shards)

    store = None
    if shard_major:
        from gpann_tpu_torch.search.relayout import (
            ShardMajorStore, capacity_assign_to_store)

        if not ShardMajorStore.exists(store_dir):
            t0 = time.time()
            aggs, agg_lbl = (_ensure_aggs() if args.method == "gp"
                             else _bkm_reps())
            complete = capacity_assign_to_store(
                pts, aggs, agg_lbl, args.shards, store_dir, eps=args.eps,
                metric=args.metric,
                max_chunks=(args.assign_chunks or None), log=log,
                device=device,
            )
            _stamp_add(store_dir, time.time() - t0)
            if not complete:
                log("partition stage checkpointed (incomplete); re-invoke")
                return 0
        store = ShardMajorStore(store_dir)
        sizes = np.asarray(store.sizes)
        t_part = _cached_time(store_dir)
    else:
        part_path = os.path.join(cache, f"{mtag}_part.npy")
        t0 = time.time()
        if os.path.exists(part_path):
            part = np.load(part_path)
            t_part = _cached_time(part_path)
        else:
            if args.method == "gp":
                aggs, agg_lbl = _ensure_aggs()
                part = capacity_stream_assign(
                    pts, aggs, agg_lbl, args.shards, eps=args.eps,
                    metric=args.metric, device=device,
                )
            else:
                part = streaming_capacity_partition(
                    pts, k=args.shards, eps=args.eps, seed=args.seed,
                    metric=args.metric, train_sample=args.train_sample,
                    device=device,
                )
            np.save(part_path, part)
            t_part = time.time() - t0
            _stamp(part_path, t_part)
        sizes = np.bincount(part, minlength=args.shards)
    cap = (1.0 + args.eps) * np.ceil(args.n / args.shards)
    balance = float(sizes.max() / np.ceil(args.n / args.shards))
    assert sizes.max() <= cap, (sizes.max(), cap)
    log(f"partition: sizes [{sizes.min()}..{sizes.max()}] "
        f"balance={balance:.4f} (cap ratio {1 + args.eps}) ({t_part:.0f}s)")

    gt_path = os.path.join(cache, f"{tag}_gt.npz")
    t0 = time.time()
    g = np.load(gt_path) if os.path.exists(gt_path) else None
    if g is not None and "queries" in g and len(g["queries"]) >= args.nq:
        # the query set is part of the GT artifact: reuse the SAVED queries
        # so a cached GT stays consistent even if the synthetic generator
        # evolves between runs. A smaller --nq evaluates a prefix of the
        # cached query set (the cache is nq-agnostic by tag).
        gt_i, gt_d, queries = (g["ids"][: args.nq], g["dists"][: args.nq],
                               g["queries"][: args.nq])
        t_gt = _cached_time(gt_path)
    else:
        if g is not None:
            log("GT cache lacks its query set (pre-versioning artifact): "
                "recomputing GT for the current generator's queries")
        if store is not None:
            # sequential contiguous reads over the shard-major layout;
            # returned positions map back to original ids via the sidecar.
            # Bigger base chunks than the rows path: less per-chunk overhead
            gt_d, pos = streaming_topk_neighbors(
                queries, store.concat_view(), K, metric=args.metric,
                base_chunk=1 << 22, device=device)
            gt_i = store.orig_ids(pos)
        else:
            gt_d, gt_i = streaming_topk_neighbors(queries, pts, K,
                                                  metric=args.metric,
                                                  device=device)
        np.savez(gt_path, ids=gt_i, dists=gt_d, queries=queries)
        t_gt = time.time() - t0
        _stamp(gt_path, t_gt)
    kth = kth_neighbor_distance(gt_d, K)
    log(f"ground truth ready ({t_gt:.0f}s)")

    rt_path = os.path.join(cache, f"{mtag}_router.npz")
    t0 = time.time()
    if os.path.exists(rt_path):
        r = np.load(rt_path)
        rp, rl = r["rp"], r["rl"]
        t_router = _cached_time(rt_path)
    else:
        if store is not None:
            sub_pts, sub_lbl = store.sample(args.train_sample,
                                            seed=args.seed + 1)
            sub_clusters = partition_to_clusters(sub_lbl, args.shards)
        else:
            rng = np.random.default_rng(args.seed + 1)
            sub = np.sort(rng.choice(args.n,
                                     size=min(args.train_sample, args.n),
                                     replace=False))
            sub_pts = np.asarray(pts[sub], np.float32)
            sub_clusters = partition_to_clusters(part[sub], args.shards)
        opts = KMeansTreeRouterOptions(num_centroids=32, budget=40_000)
        kmtr = KMeansTreeRouter(metric=args.metric, device=device).train(
            sub_pts, sub_clusters, opts, seed=args.seed)
        rp, rl = kmtr.extract_points()
        np.savez(rt_path, rp=rp, rl=rl)
        t_router = time.time() - t0
        _stamp(rt_path, t_router)
    log(f"router ready ({len(rp)} routing points) ({t_router:.0f}s)")

    if store is not None:
        engine = StreamedShardEngine(None, None, rp, rl,
                                     metric=args.metric,
                                     scan_mode=args.scan_mode, store=store,
                                     device=device)
    else:
        clusters = partition_to_clusters(part, args.shards)
        engine = StreamedShardEngine(pts, clusters, rp, rl,
                                     metric=args.metric,
                                     scan_mode=args.scan_mode, device=device)

    sub_np = args.sub_nprobe if args.sub_nprobe > 0 else None
    if sub_np is not None and store is not None:
        # sub-cluster-major relayout of the store (one pass, idempotent;
        # sidecar in the store dir is the cache)
        t0 = time.time()
        if engine.sub_slices is None:
            engine.build_subclusters_store(target_sub_size=args.sub_size,
                                           seed=args.seed, log=log)
            _stamp(os.path.join(store_dir, "subclusters.npz"),
                   time.time() - t0)
            t_subc = time.time() - t0
        else:
            t_subc = _cached_time(os.path.join(store_dir, "subclusters.npz"))
        n_sub = sum(len(c) for c in engine.sub_centroids)
        log(f"sub-cluster-major store: {n_sub} sub-clusters across "
            f"{args.shards} shards ({t_subc:.0f}s)")
    elif sub_np is not None:
        sc_path = os.path.join(cache, f"{mtag}_subc{args.sub_size}.npz")
        t0 = time.time()
        if os.path.exists(sc_path):
            engine.load_subclusters(dict(np.load(sc_path)))
            t_subc = _cached_time(sc_path)
        else:
            art = engine.build_subclusters(target_sub_size=args.sub_size,
                                           seed=args.seed)
            np.savez(sc_path, **art)
            t_subc = time.time() - t0
            _stamp(sc_path, t_subc)
        n_sub = sum(len(s) for s in engine.sub_members)
        log(f"sub-clusters ready: {n_sub} across {args.shards} shards "
            f"(target {args.sub_size} pts each) ({t_subc:.0f}s)")

    t0 = time.time()
    curve, stats = engine.recall_curve(queries, K, kth, verbose=False,
                                       max_nprobes=nprobes_eval,
                                       sub_nprobe=sub_np)
    gb = stats["bytes_uploaded"] / 1e9
    t_curve = time.time() - t0
    log(f"curve pass: {t_curve:.0f}s ({gb:.1f} GB streamed, "
        f"route {stats['route_s']:.1f}s gather {stats['gather_s']:.1f}s "
        f"scan {stats['scan_s']:.1f}s)")
    log("recall curve: "
        + " ".join(f"{p+1}:{r:.4f}" for p, r in enumerate(curve)))

    ok = np.nonzero(curve >= 0.95)[0]
    nprobes = int(ok[0] + 1) if len(ok) else nprobes_eval

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("n,d,shards,kind,dtype,metric,method,nprobes,recall,"
                "balance,curve_pass_s,gb_streamed,partition_s,gt_s,"
                "router_s,sub_nprobe\n")
        for p, r in enumerate(curve):
            f.write(f"{args.n},{args.d},{args.shards},{args.kind},"
                    f"{args.dtype},{args.metric},{args.method},{p+1},"
                    f"{r:.6f},{balance:.4f},{t_curve:.1f},{gb:.2f},"
                    f"{t_part:.1f},{t_gt:.1f},{t_router:.1f},"
                    f"{args.sub_nprobe}\n")
    summary = {
        "n": args.n, "shards": args.shards, "kind": args.kind,
        "dtype": args.dtype, "metric": args.metric,
        "method": args.method,
        "balance": round(balance, 4),
        "nprobes_at_95": nprobes,
        "recall_at_nprobes": round(float(curve[nprobes - 1]), 4),
        "curve_pass_s": round(t_curve, 1), "gb_streamed": round(gb, 1),
        "sub_nprobe": args.sub_nprobe,
        "total_s": round(time.time() - t_all, 1),
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
