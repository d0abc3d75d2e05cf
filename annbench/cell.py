"""One run of one cell: set-up, the measured window, the per-layer readers,
the judgement against the plain reference, and the result line.

The program under test is the engine that the configuration's ``serving``
names (``annbench/engines/<serving>.py``), built from the regenerated base
and the shipped partition and routing points, and driven through its public
entry: a closed loop with one batch in flight, the next submitted once the
previous batch's ids are on the host. The window serves a pool of distinct
batches drawn for it alone; the warm-up serves another pool, drawn from
another seed.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from annbench import datagen, judge, spec
from annbench.spec import ROOT, Cell, engine_module, quantity, reader
from annbench.trace import WINDOW_SPAN, Trace, spans

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gpann_tpu")
SAMPLE_STREAM = 0x1D6E   # second word of the judged sample's numpy seed
WARMUP_STREAM = 1 << 40  # added to --seed for the warm-up pool's generator
BREAKDOWN_SECONDS = 2.0  # the host-annotated window that labels idle gaps


def log(msg: str) -> None:
    print(f"# annbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``gpann_tpu_torch`` is neither)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN_MODULES))


class Setup(NamedTuple):
    base: np.ndarray            # [n, d] float32, host
    shard_of: np.ndarray        # [n] shard of each row (shipped partition)
    routing_points: np.ndarray
    routing_labels: np.ndarray
    engine: object              # what the engine module built
    pool: torch.Tensor          # [P, m, d] the window's batches on the device


class Window(NamedTuple):
    latencies_s: List[float]
    ids: List[np.ndarray]       # served ids of each batch, in order
    dists: List[np.ndarray]
    pool_index: List[int]       # pool batch of each served batch
    seconds: float              # first submission to the last ids on the host


def check_base(cfg: dict, base: np.ndarray, check_q: np.ndarray,
               art: dict) -> float:
    """Widest relative gap between the shipped ``gt_dists`` of the first
    ``check_slice`` shipped queries and their distances recomputed by the
    configuration's reference (``exact_distances``, float64, on the host)
    from the regenerated base and the shipped ``gt_ids``, over the
    reference's ``dist_scale`` of each; raises above ``check_rtol``."""
    m = cfg["check_slice"]
    reference = spec.reference_module(cfg["metric"])
    q, x = torch.as_tensor(check_q[:m]), torch.as_tensor(base)
    ids = torch.as_tensor(art["gt_ids"][:m].astype(np.int64))
    want = art["gt_dists"][:m].astype(np.float64)
    got = reference.exact_distances(q, x, ids).numpy()
    scale = reference.dist_scale(q, x, ids, torch.as_tensor(want)).numpy()
    gap = float(np.max(np.abs(got - want) / np.maximum(scale, 1e-12)))
    if not gap <= cfg["check_rtol"]:
        raise RuntimeError(
            f"regenerated base does not match {cfg['artifact']}: shipped "
            f"gt_dists of {m} queries off by {gap:.3e} > {cfg['check_rtol']}")
    return gap


def pool_batches(traffic: dict, seconds: float) -> int:
    return max(1, int(np.ceil(traffic["pool_batches_per_s"] * seconds)))


def setup(cell: Cell, seed: int, seconds: float, device: torch.device,
          artifact: Optional[dict] = None) -> Setup:
    """Everything before the window. ``artifact`` replaces the shipped file
    (tests at small sizes). The engine is closed here if set-up fails after
    building it; otherwise the caller closes it."""
    cfg, traffic = cell.config, cell.traffic
    module = engine_module(cfg["serving"])
    n, d = cfg["num_points"], cfg["dim"]
    t = time.perf_counter()
    base, check_q = datagen.base_and_check_queries(
        cfg["data"], n, d, cfg["check_queries"], cfg["base_seed"])
    log(f"base {base.shape} regenerated in {time.perf_counter() - t:.3f} s")
    if artifact is None:
        with np.load(ROOT / cfg["artifact"]) as f:
            artifact = {key: f[key] for key in f.files}
    if artifact["assign"].shape != (n,):
        raise RuntimeError(f"partition has {artifact['assign'].shape} rows, "
                           f"the base {n}")
    gap = check_base(cfg, base, check_q, artifact)
    log(f"base matches the shipped gt_dists ({cfg['check_slice']} queries, "
        f"widest relative gap {gap:.3e})")
    shard_of = np.asarray(artifact["assign"])
    routing_points = np.asarray(artifact["routing_points"])
    routing_labels = np.asarray(artifact["routing_labels"])
    t = time.perf_counter()
    engine = module.build(base, shard_of, routing_points, routing_labels,
                          cfg, device)
    log(f"engine {cfg['serving']!r} built in {time.perf_counter() - t:.3f} s")
    try:
        pool = _warm_up(engine, cfg, traffic, seed, seconds, device)
    except BaseException:
        module.close(engine)
        raise
    return Setup(base, shard_of, routing_points, routing_labels, engine,
                 pool)


def _warm_up(engine, cfg: dict, traffic: dict, seed: int, seconds: float,
             device: torch.device) -> torch.Tensor:
    """Draws the window's pool, serves the warm-up, returns the pool."""
    d = cfg["dim"]
    num = pool_batches(traffic, seconds)
    pool = datagen.device_batches(cfg["data"], d, cfg["base_seed"], num,
                                  traffic["batch"], seed, device)
    log(f"query pool: {num} batches of {traffic['batch']}, "
        f"{pool.numel() * 4} bytes on {device}")
    # the warm-up serves batches of its own, so the window serves none twice
    warm_pool = datagen.device_batches(
        cfg["data"], d, cfg["base_seed"], traffic["warmup_batches"],
        traffic["batch"], int(seed) + WARMUP_STREAM, device)
    # the first batch builds the kernel library in a fresh checkout; then
    # serving warms up over seconds, not over a few batches: a window right
    # after a short warm-up read 5-8% slower than the next one in one process
    t = time.perf_counter()
    serve(engine, cfg, warm_pool[0])
    warm = closed_loop(engine, cfg, warm_pool, traffic["warmup_seconds"])
    log(f"warmed up with {len(warm.ids)} batches in "
        f"{time.perf_counter() - t:.3f} s")
    return pool


def serve(engine, cfg: dict, queries: torch.Tensor):
    return engine_module(cfg["serving"]).serve(engine, cfg, queries)


def closed_loop(engine, cfg: dict, pool: torch.Tensor,
                seconds: float) -> Window:
    """Serve pool batches in turn, one in flight, until ``seconds`` have
    passed; the batch that crosses the end is the last. A program that
    outruns the pool is served its batches again (:func:`reused`)."""
    lat, ids, dists, index = [], [], [], []
    start = time.perf_counter()
    end = start + seconds
    i, now = 0, start
    while now < end:
        b = i % pool.shape[0]
        t = time.perf_counter()
        d, idx = serve(engine, cfg, pool[b])
        now = time.perf_counter()
        lat.append(now - t)
        ids.append(idx)
        dists.append(d)
        index.append(b)
        i += 1
    return Window(lat, ids, dists, index, now - start)


def reused(win: Window, pool: torch.Tensor) -> int:
    """Batches of the window that repeat an earlier batch of it."""
    return max(0, len(win.ids) - pool.shape[0])


class Sample(NamedTuple):
    queries: torch.Tensor       # [S, d] host
    ids: torch.Tensor           # [S, k] served ids, host
    dists: torch.Tensor         # [S, k] served distances, host


def draw_sample(win: Window, pool: torch.Tensor, size: int,
                seed: int) -> Sample:
    """``size`` served queries drawn from ``seed`` across the whole window."""
    m = pool.shape[1]
    total = len(win.ids) * m
    rng = np.random.default_rng([int(seed), SAMPLE_STREAM])
    flat = np.sort(rng.choice(total, size=min(size, total), replace=False))
    b, j = flat // m, flat % m
    pb = torch.as_tensor(np.asarray(win.pool_index)[b], device=pool.device)
    q = pool[pb, torch.as_tensor(j, device=pool.device)].cpu()
    ids = torch.as_tensor(np.stack([win.ids[x][y] for x, y in zip(b, j)]))
    dists = torch.as_tensor(np.stack([win.dists[x][y] for x, y in zip(b, j)]))
    return Sample(q, ids.long(), dists)


class Truth(NamedTuple):
    """The reference's inputs on the device, made from the benchmark's own
    data (never from the engine)."""
    base: torch.Tensor
    shard_of: torch.Tensor
    routing_points: torch.Tensor
    routing_labels: torch.Tensor


def truth(s: Setup, device) -> Truth:
    return Truth(torch.as_tensor(s.base, device=device),
                 torch.as_tensor(s.shard_of.astype(np.int64), device=device),
                 torch.as_tensor(s.routing_points, device=device),
                 torch.as_tensor(s.routing_labels.astype(np.int64),
                                 device=device))


def compare(cfg: dict, tr: Truth, queries: torch.Tensor, ids: torch.Tensor,
            dists: torch.Tensor, precision: str = "fp32") -> Dict[str, float]:
    """recall_at_10 and the judged numbers of answers (``ids``, ``dists``)
    to ``queries``, against the reference of the configuration's
    ``metric`` (``"l2"`` where it names none). ``precision="tf32"`` judges
    the reference's own answers a precision lower instead (the control) and
    ignores ``ids`` and ``dists``."""
    reference = spec.reference_module(cfg.get("metric", "l2"))
    dev = tr.base.device
    q = queries.to(dev)
    k = cfg["k"]
    args = (q, tr.base, tr.shard_of, tr.routing_points, tr.routing_labels,
            cfg["num_shards"], cfg["voting_t"], cfg["nprobes"], k)
    exact = reference.reference_answers(*args)
    if precision != "fp32":
        low = reference.reference_answers(*args, precision=precision)
        ids, dists = low.routed.ids, low.routed.dists
    ids, dists = ids.to(dev), dists.to(dev)
    served = reference.exact_distances(q, tr.base, ids)
    kth_whole = exact.whole.dists[:, k - 1]
    kth_routed = exact.routed.dists[:, k - 1]
    scale = reference.dist_scale(q, tr.base, exact.whole.ids[:, k - 1 : k],
                                 exact.whole.dists[:, k - 1 : k])[:, 0]
    return {
        "recall_at_10": judge.recall(ids, served, kth_whole, k),
        "routed_miss": 1.0 - judge.recall(ids, served, kth_routed, k),
        "dist_err": judge.dist_err(dists, served, scale),
    }


class Ctx(NamedTuple):
    """What a per-layer reader may read (``annbench/metrics/<name>.py``)."""
    engine: object
    pool: torch.Tensor
    config: dict
    traffic: dict
    served: List[int]           # pool batch of each batch of the window
    trace: Optional[Trace]
    device: torch.device
    kind: str
    grouping: Callable          # pool index -> (live_q, sizes, row_off) numpy,
                                # or None where the engine scans no blocks


def grouping_of(engine, cfg: dict, pool: torch.Tensor) -> Callable:
    """Memoised grouping of a pool batch (the engine module's
    ``grouping``)."""
    memo: Dict[int, Optional[tuple]] = {}
    module = engine_module(cfg["serving"])

    def get(i: int):
        if i not in memo:
            memo[i] = module.grouping(engine, cfg, pool[i])
        return memo[i]
    return get


def device_kind(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def profiler(device: torch.device, host: bool):
    """A ``torch.profiler`` of the card, and with ``host`` of the host's
    operators too; ``None`` where there is nothing to profile."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts) if acts else None


def traced_window(engine, cfg: dict, pool: torch.Tensor, seconds: float,
                  device: torch.device):
    """The measured window under a profile of the card alone, whose host
    runs at its own pace: (window, device-only trace)."""
    prof = profiler(device, host=False)
    with prof if prof is not None else contextlib.nullcontext():
        win = closed_loop(engine, cfg, pool, seconds)
    return win, Trace.device_only(spans(prof)[0] if prof else [],
                                  win.seconds)


def annotated_window(engine, cfg: dict, pool: torch.Tensor, seconds: float,
                     device: torch.device):
    """A short window under a profile of host and card, read only for the
    labels of the idle gaps: (window, annotated trace). Recording every host
    operator slows the host, so its gaps are longer than the measured
    window's."""
    from torch.profiler import record_function

    with profiler(device, host=True) as prof:
        with record_function(WINDOW_SPAN):
            win = closed_loop(engine, cfg, pool, seconds)
    return win, Trace.annotated(*spans(prof))


def window_metrics(win: Window, m: int) -> Dict[str, float]:
    """``qps``: every query answered in the window over the whole window;
    ``batch_p95_ms``: the 95th percentile of all its batches' latencies
    (numpy's linear interpolation)."""
    return {"qps": len(win.ids) * m / win.seconds,
            "batch_p95_ms": float(np.percentile(
                np.asarray(win.latencies_s), 95)) * 1e3}


def _measure(cell: Cell, s: Setup, seconds: float, trace: bool,
             device: torch.device):
    """The window, and with ``trace`` the per-layer readers and the
    breakdown: ``(window, device info, metrics, breakdown)``."""
    cfg = cell.config
    if trace:
        win, tr_obj = traced_window(s.engine, cfg, s.pool, seconds, device)
    else:
        win = closed_loop(s.engine, cfg, s.pool, seconds)
    kind = device_kind(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    m = cell.traffic["batch"]
    log(f"window{' (card profiled)' if trace else ''}: {len(win.ids)} "
        f"batches of {m} in {win.seconds:.6f} s, "
        f"{win.seconds / len(win.ids) * 1e3:.4f} ms a batch, 95th "
        f"percentile {window_metrics(win, m)['batch_p95_ms']:.4f} ms")
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}

    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        ctx = Ctx(s.engine, s.pool, cfg, cell.traffic, win.pool_index,
                  tr_obj, device, kind, grouping_of(s.engine, cfg, s.pool))
        for entry in cell.per_layer:
            value = reader(entry["name"])(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
        dev_info["busy_s"] = tr_obj.busy_s()
        dev_info["window_s"] = tr_obj.window_s
        short, labelled = annotated_window(s.engine, cfg, s.pool, min(
            BREAKDOWN_SECONDS, seconds), device)
        log(f"annotated window (host and card profiled, idle gaps only): "
            f"{len(short.ids)} batches in {short.seconds:.6f} s, "
            f"{short.seconds / len(short.ids) * 1e3:.4f} ms a batch")
        breakdown = {"device_ops": tr_obj.top_device_ops(),
                     "idle_gaps": labelled.idle_gaps()}
        del ctx, tr_obj, short, labelled
    return win, dev_info, metrics, breakdown


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t0: float, artifact: Optional[dict] = None,
             limits: Optional[dict] = None) -> dict:
    """One run; returns the result line's dict (``checks`` last).

    ``t0`` is the ``time.perf_counter()`` of the process's start. ``device``
    is the card in every run of the benchmark's command; the tests pass the
    CPU with a small ``artifact`` and their ``limits``."""
    device = torch.device(device)
    cfg = cell.config
    limits = cell.limits if limits is None else limits
    s = setup(cell, seed, seconds, device, artifact)
    setup_s = time.perf_counter() - t0
    try:
        win, dev_info, metrics, breakdown = _measure(cell, s, seconds, trace,
                                                     device)
    finally:
        engine_module(cfg["serving"]).close(s.engine)
    m = cell.traffic["batch"]
    repeats = reused(win, s.pool)
    if repeats:
        log(f"the program outran the query pool: {repeats} of "
            f"{len(win.ids)} batches served again; raise the traffic's "
            f"pool_batches_per_s")

    sample = draw_sample(win, s.pool, cell.traffic["judged_queries"], seed)
    invalid = judge.invalid_lists(win.ids, cfg["num_points"])
    tr = truth(s, device)
    del s   # the program's state goes before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values = compare(cfg, tr, sample.queries, sample.ids, sample.dists)
    log(f"reference over {sample.ids.shape[0]} judged queries in "
        f"{time.perf_counter() - t:.3f} s")
    del tr
    values["invalid_lists"] = float(invalid)

    if not trace:
        e2e = window_metrics(win, m)
        e2e.update(recall_at_10=values["recall_at_10"], setup_s=setup_s)
        # a metric named <quantity>.<regime> reads its quantity: cells that
        # spread alike share a name, and with it a bound
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": e2e[quantity(entry["name"])],
                                      "unit": entry["unit"]}
    checks = judge.checks(values, limits)
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": len(win.ids) * m, "failed": invalid,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["reused_batches"] = repeats
    result["checks"] = {name: {"value": c["value"], "limit": c["limit"]}
                        for name, c in checks.items()}
    return result
