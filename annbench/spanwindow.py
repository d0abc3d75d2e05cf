"""The span window: one more closed-loop window of a traced run, served with
the program's recorder installed (``gpann_tpu_torch.core.profiling``) under
a profile of the card alone, for the per-layer metrics of the serve
engine's steps (``metrics/host_dispatch_ms.py``, ``dispatch_idle_pct.py``,
``route_step_ms.py``, ``group_step_ms.py``, ``phase2_step_ms.py``,
``merge_step_ms.py``, ``b1_padding_counted_pct.py``).

The program stamps its spans with ``time.time_ns()``, the clock of the
profiler's events; the card's kernels, copies and sets are moved onto that
clock batch by batch (:func:`align`), so spans and card work lie on one
timeline. The window runs from the first ``serve.batch`` start to the last
``serve.readback`` end. It is served once a process, the first time a
reader asks, and kept on the engine; a program without a recorder, an
engine that records no batch (the streamed one), or a run without a CUDA
card, gives no window and its readers nothing.

Each run logs the window's ms a batch, its idle seconds by the innermost
program span open at each idle gap's middle (``OUTSIDE`` where none is), and
the clock check: each batch's ``bintop2`` kernel (paired counting back from
the last) starts after its ``scan.b1`` span starts and ends before its
``serve.readback`` span ends; the count of batches that break it should be
0, and is logged on the profiler's own card timestamps too.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from annbench.cell import closed_loop, log, profiler, serve
from annbench.trace import BETWEEN_OPS, Span, Trace, spans

SPAN_SECONDS = 5.0
OUTSIDE = "outside serve"
B1_KERNEL = "bintop2"
COPY = "Memcpy DtoH"     # the read-back's copies, as the profiler names them
# metric quantity -> the span whose stream ms it averages over the batches
STEPS = {"route_step_ms": "serve.route", "group_step_ms": "serve.group",
         "phase2_step_ms": "scan.phase2", "merge_step_ms": "serve.merge"}
_MEMO = "_annbench_span_window"


def window(ctx) -> Optional[dict]:
    """The span window's quantities (:func:`summarise`) for ``ctx``'s
    engine; None off a CUDA card or where the program records nothing."""
    if ctx.device.type != "cuda":
        return None
    if not hasattr(ctx.engine, _MEMO):
        setattr(ctx.engine, _MEMO, _serve(ctx))
    return getattr(ctx.engine, _MEMO)


def _serve(ctx) -> Optional[dict]:
    try:
        from gpann_tpu_torch.core.profiling import Recorder, recording
    except ImportError:
        log("span window: the program has no recorder; its readers are "
            "left out")
        return None
    rec = Recorder()
    with profiler(ctx.device, host=False) as prof:
        # a batch before the window: a profile can miss the operations of
        # its first milliseconds (a quarter second of serving here instead
        # slowed the window's host inside the B1 launch by ~2.8 ms a batch)
        serve(ctx.engine, ctx.config, ctx.pool[-1])
        with recording(rec):
            win = closed_loop(ctx.engine, ctx.config, ctx.pool, SPAN_SECONDS)
    drained = rec.drain()
    out = summarise(drained.spans, drained.counters, spans(prof)[0])
    if out is None:
        log("span window: the program recorded no complete batch")
        return None
    log(f"span window (recorder on, card profiled): {out['batches']} "
        f"batches in {out['window_s']:.6f} s on the shared clock, "
        f"{out['ms_a_batch']:.4f} ms a batch; on the host's clock "
        f"{win.seconds / len(win.ids) * 1e3:.4f} ms a batch")
    table = ", ".join(f"{name} {s:.6f}" for name, s in out["idle_by_span"])
    log(f"span window idle s by innermost span: {table}; sum "
        f"{sum(s for _, s in out['idle_by_span']):.6f} of idle "
        f"{out['idle_s']:.6f} s")
    log(f"span window clock check: {out['clock_breaks']} of "
        f"{out['batches']} batches break it ({out['b1_kernels']} "
        f"{B1_KERNEL} kernels); on the profiler's own card timestamps "
        f"{out['raw_clock_breaks']}; batches' card spans moved by "
        f"{out['shifts_ns']!r} ns (least, most)")
    log("span window: " + ", ".join(
        f"{k} {out[k]!r}" for k in ("host_dispatch_ms", "dispatch_idle_pct",
                                    *STEPS, "b1_padding_counted_pct")))
    return out


def _covered(seg: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Length of the union of ``seg`` ([r, 2], sorted, disjoint) before
    each time of ``t``."""
    if not len(seg):
        return np.zeros(len(t), np.int64)
    lengths = seg[:, 1] - seg[:, 0]
    before = np.concatenate([[0], np.cumsum(lengths)])
    j = np.searchsorted(seg[:, 0], t, side="right")   # segments started by t
    last = np.maximum(j - 1, 0)
    part = np.clip(t - seg[last, 0], 0, lengths[last])
    return np.where(j > 0, before[last] + part, 0)


def align(device: List[Span], batches: List[dict]):
    """The card's spans moved onto the host's clock: ``(spans, shifts)``,
    ``shifts`` the least and the most that a batch's spans were moved (ns),
    or ``(device, None)`` where no batch's read-back can be found.

    A profile's card timestamps cannot be laid on ``time.time_ns()`` as
    they come: in the first profile of a process they stay within a few
    hundred microseconds of it, but the span window's profile, the second
    of a traced run, strayed by tens of milliseconds, for seconds at a rate
    9,000 parts per million off (an H100 under torch 2.11; ``PERF.md``). The
    program's CUDA events keep the card's own clock, and at a batch's start
    and at its read-back's end, where the card waits for the host, they lie
    within microseconds of the host's clock: a least-squares line through
    those pairs puts any event on the host's clock.

    Batch i's ``bintop2`` kernel is the i-th counting back from the last;
    the first copies to the host after it, before the next batch's kernel,
    are its read-back's, and the batch's operations end with them (a batch
    whose kernel or copies the profile lost is moved with the next). Each batch's operations (after the
    previous batch's read-back, up to its own) are moved as late as two
    bounds allow: the operation before the copies ends by the host-clock
    time of the ``serve.readback`` span's first event (which the stream
    reaches between the two), and the last copy ends by the span's end,
    when the host has its ids. Where the card was busy up to the event, or
    the host left as the copy ended, the batch lands within microseconds of
    its place."""
    ops = sorted(device, key=lambda s: s.start)
    n = len(batches)
    kernels = [j for j, s in enumerate(ops) if B1_KERNEL in s.name][-n:]
    kernels = [None] * (n - len(kernels)) + kernels + [len(ops)]
    if any(b[name].stream_at_ms is None for b in batches
           for name in ("serve.batch", "serve.readback")):
        return device, None
    # the card's clock (ms after the recorder's first event) onto the host's
    ms = [b["serve.batch"].stream_at_ms for b in batches] + [
        b["serve.readback"].stream_at_ms + b["serve.readback"].stream_ms
        for b in batches]
    ns = [b["serve.batch"].start_ns for b in batches] + [
        b["serve.readback"].end_ns for b in batches]
    h0 = ns[0]
    rate, icpt = np.polyfit(ms, np.subtract(ns, h0), 1)
    moved, shifts, done = [], [], 0
    for i, b in enumerate(batches):
        j, stop = kernels[i], kernels[i + 1]
        first = None if j is None else next(
            (c for c in range(j + 1, stop) if ops[c].name.startswith(COPY)),
            None)
        if first is None:   # a batch the profile lost: the next one's spans
            continue
        last = first
        while last + 1 < stop and ops[last + 1].name.startswith(COPY):
            last += 1
        event = h0 + icpt + rate * b["serve.readback"].stream_at_ms
        shift = int(round(min(event - ops[first - 1].end,
                              b["serve.readback"].end_ns - ops[last].end)))
        shifts.append(shift)
        moved += [Span(s.name, s.start + shift, s.end + shift)
                  for s in ops[done:last + 1]]
        done = last + 1
    if not shifts:
        return device, None
    moved += [Span(s.name, s.start + shifts[-1], s.end + shifts[-1])
              for s in ops[done:]]
    return moved, (min(shifts), max(shifts))


def _clock_breaks(device: List[Span], batches: List[dict]) -> int:
    """Batches whose ``bintop2`` kernel (paired counting back from the
    last) is missing, starts before their ``scan.b1`` span or ends after
    their ``serve.readback`` span."""
    kernels = sorted((s for s in device if B1_KERNEL in s.name),
                     key=lambda s: s.start)[-len(batches):]
    kernels = [None] * (len(batches) - len(kernels)) + kernels
    breaks = 0
    for k, b in zip(kernels, batches):
        ok = (k is not None and "scan.b1" in b
              and k.start >= b["scan.b1"].start_ns
              and k.end <= b["serve.readback"].end_ns)
        breaks += not ok
    return breaks


def summarise(program: List, counters: Dict[str, int],
              device: List[Span]) -> Optional[dict]:
    """The window's quantities from the program's drained spans (each with
    ``name``, ``batch``, ``start_ns``, ``end_ns``, ``stream_ms``), its
    counters and the card's spans; None without a complete batch (one with
    ``serve.batch`` and ``serve.readback``)."""
    by_batch: Dict[int, dict] = {}
    for s in program:
        by_batch.setdefault(s.batch, {})[s.name] = s
    batches = [b for _, b in sorted(by_batch.items())
               if "serve.batch" in b and "serve.readback" in b]
    if not batches:
        return None
    lo = min(b["serve.batch"].start_ns for b in batches)
    hi = max(b["serve.readback"].end_ns for b in batches)
    raw_breaks = _clock_breaks(device, batches)
    device, shifts = align(device, batches)
    inside = [Span(s.name, s.start_ns, s.end_ns) for b in batches
              for s in b.values()]
    tr = Trace(device, inside, lo, hi)
    idle_s = tr.window_s - tr.busy_s()
    labels = len({s.name for s in inside}) + 1
    idle_by_span = [[OUTSIDE if name == BETWEEN_OPS else name, s]
                    for name, s in tr.idle_gaps(n=labels)]

    start = np.array([b["serve.batch"].start_ns for b in batches], np.int64)
    sent = np.array([b["serve.readback"].start_ns for b in batches],
                    np.int64)
    seg = tr._busy_segments()
    busy_in = _covered(seg, sent) - _covered(seg, start)
    dispatch_idle = float((sent - start).sum() - busy_in.sum())

    out = {"batches": len(batches), "window_s": tr.window_s,
           "ms_a_batch": tr.window_s * 1e3 / len(batches),
           "idle_s": idle_s, "idle_by_span": idle_by_span,
           "clock_breaks": _clock_breaks(device, batches),
           "raw_clock_breaks": raw_breaks, "shifts_ns": shifts,
           "b1_kernels": sum(B1_KERNEL in s.name for s in device),
           "host_dispatch_ms": float((sent - start).mean()) * 1e-6,
           "dispatch_idle_pct": 100.0 * dispatch_idle / (hi - lo)}
    for quantity, name in STEPS.items():
        ms = [b[name].stream_ms for b in batches if name in b]
        out[quantity] = (float(np.mean(ms)) if ms and None not in ms
                         else None)
    real = counters.get("b1.rows_real")
    scanned = counters.get("b1.rows_scanned")
    out["b1_padding_counted_pct"] = (100.0 * (1.0 - real / scanned)
                                     if real is not None and scanned
                                     else None)
    return out
