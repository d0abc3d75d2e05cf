"""The stream window: one more closed-loop window of a traced run, served
with the program's recorder installed (``gpann_tpu_torch.core.profiling``)
and no profiler, for the per-layer metrics of the streamed engine's pass
(``metrics/stream_gather_ms.py``, ``stream_upload_ms.py``,
``stream_scan_ms.py``).

``StreamedShardEngine.search`` records one ``stream.pass`` span a batch
and, inside it, ``stream.route``, then for each block of each probed shard
``stream.gather`` (the fill of a page-locked staging buffer with the
block's rows from the store, over the engine's reader threads),
``stream.upload`` (the enqueue of the block's asynchronous copy to the card,
and the host's wait, if any, for the other staging buffer's copy) and
``stream.scan`` (from the compute stream's wait on that copy: kernel B2 or
the exact scan, phase 2 and the enqueue of the results' copy to the host,
which the pass takes two blocks later, outside every step), and last
``stream.merge``. Host times come from the spans' ``time.time_ns()``
edges, stream times from their CUDA events: neither needs a profile. The
window is served once a process, the first time a reader asks, and kept on
the engine; a program without these spans, or a run without a CUDA card,
gives no window and its readers nothing.

Each run logs the mean pass, each span's mean host ms and stream ms a pass,
the host ms a pass outside every step, and the counters.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from annbench.cell import closed_loop, log

STREAM_SECONDS = 6.0
PASS = "stream.pass"
STEPS = ("stream.route", "stream.gather", "stream.upload", "stream.scan",
         "stream.merge")
_MEMO = "_annbench_stream_window"


def window(ctx) -> Optional[dict]:
    """The stream window's quantities (:func:`summarise`) for ``ctx``'s
    engine; None off a CUDA card or where the program records no pass."""
    if ctx.device.type != "cuda":
        return None
    if not hasattr(ctx.engine, _MEMO):
        setattr(ctx.engine, _MEMO, _serve(ctx))
    return getattr(ctx.engine, _MEMO)


def _serve(ctx) -> Optional[dict]:
    try:
        from gpann_tpu_torch.core.profiling import Recorder, recording
    except ImportError:
        log("stream window: the program has no recorder; its readers are "
            "left out")
        return None
    rec = Recorder()
    with recording(rec):
        win = closed_loop(ctx.engine, ctx.config, ctx.pool, STREAM_SECONDS)
    drained = rec.drain()
    out = summarise(drained.spans, drained.counters)
    if out is None:
        log("stream window: the program recorded no complete pass")
        return None
    log(f"stream window (recorder on): {out['passes']} passes, "
        f"{out['pass_ms']:.3f} ms a pass; on the host's clock "
        f"{win.seconds / len(win.ids) * 1e3:.3f} ms a batch")
    log("stream window ms a pass, host / stream: " + ", ".join(
        f"{name} {out['host_ms'][name]!r} / {out['stream_ms'][name]!r}"
        for name in STEPS) + f"; outside every step {out['outside_ms']!r}")
    log("stream window counters: " + ", ".join(
        f"{name} {value}" for name, value in sorted(out["counters"].items())))
    return out


def _mean(values: List[Optional[float]], passes: int) -> Optional[float]:
    if None in values:
        return None
    return sum(values) / passes


def summarise(program: List, counters: Dict[str, int]) -> Optional[dict]:
    """The window's quantities from the program's drained spans (each with
    ``name``, ``batch``, ``start_ns``, ``end_ns``, ``stream_ms``) and
    counters; None without a complete pass (a batch with ``stream.pass``).
    Each span's ms a pass is the sum over the passes' spans of that name
    over the passes; stream ms are None where a span has no events (no
    card)."""
    by_batch: Dict[int, list] = {}
    for s in program:
        by_batch.setdefault(s.batch, []).append(s)
    passes = [spans for _, spans in sorted(by_batch.items())
              if any(s.name == PASS for s in spans)]
    if not passes:
        return None
    n = len(passes)
    host_ms, stream_ms = {}, {}
    for name in (PASS,) + STEPS:
        spans = [s for p in passes for s in p if s.name == name]
        host_ms[name] = sum((s.end_ns - s.start_ns) * 1e-6
                            for s in spans) / n
        stream_ms[name] = _mean([s.stream_ms for s in spans], n)
    return {"passes": n, "pass_ms": host_ms[PASS], "host_ms": host_ms,
            "stream_ms": stream_ms,
            "outside_ms": host_ms[PASS] - sum(host_ms[s] for s in STEPS),
            "counters": dict(counters),
            "stream_gather_ms": host_ms["stream.gather"],
            "stream_upload_ms": host_ms["stream.upload"],
            "stream_scan_ms": stream_ms["stream.scan"]}
