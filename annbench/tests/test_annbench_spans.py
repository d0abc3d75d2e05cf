"""The span window's readers on the CPU: their arithmetic on hand-made
program spans and card spans (``annbench/spanwindow.py``), the counted
padding against the benchmark's own on the same batches, and the entries of
``BENCHMARK.json`` that they read for."""

import json
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from annbench import spanwindow
from annbench.roofline import padding_pct
from annbench.spec import ROOT, reader
from annbench.trace import Span

QUANTITIES = {
    # quantity: (unit, source, layer)
    "host_dispatch_ms": ("ms", "program_span", "serve engine, host dispatch"),
    "dispatch_idle_pct": ("%", "program_span", "serve engine, host dispatch"),
    "route_step_ms": ("ms", "program_span", "serve engine, routing"),
    "group_step_ms": ("ms", "program_span", "serve engine, grouping"),
    "phase2_step_ms": ("ms", "program_span", "serve engine, scan phase 2"),
    "merge_step_ms": ("ms", "program_span", "serve engine, merge"),
    "b1_padding_counted_pct": ("%", "program_counter",
                               "serve engine, grouping"),
}


class P(NamedTuple):
    """A drained program span, as ``gpann_tpu_torch.core.profiling.Span``."""
    name: str
    batch: int
    start_ns: int
    end_ns: int
    stream_ms: Optional[float] = None
    stream_at_ms: Optional[float] = None


def _card_ms(t):
    """The card's event clock at host time ``t`` ns: 0.1% fast, 7 us on."""
    return (t * 1.001 + 7000) / 1e6


def _batch(b, t0, route_ms, group_ms, phase2_ms, merge_ms):
    """One batch at ``t0`` ns: the engine's span tree, a step a 100 ns or
    more, the batch ending 1000 ns (batch 0) or 900 ns (batch 1) later; the
    spans' events complete as the host records them."""
    end = t0 + (1000 if b == 0 else 900)
    spans = [("serve.batch", t0, end, 9.0),
             ("serve.route", t0 + 5, t0 + 200, route_ms),
             ("serve.group", t0 + 200, t0 + 300, group_ms),
             ("serve.scan", t0 + 300, t0 + 600, 3.0),
             ("scan.b1", t0 + 350, t0 + 450, 1.0),
             ("scan.phase2", t0 + 450, t0 + 600, phase2_ms),
             ("serve.merge", t0 + 600, t0 + 700, merge_ms),
             ("serve.readback", t0 + 700, end,
              _card_ms(end) - _card_ms(t0 + 700))]
    return [P(name, b, start, stop, ms, _card_ms(start))
            for name, start, stop, ms in spans]


PROGRAM = (_batch(0, 0, 0.5, 0.1, 1.0, 0.25)
           + _batch(1, 1100, 0.7, 0.3, 2.0, 0.75))
# four operations a batch, the last (the read-back's copy) ending as the
# host leaves the read-back: the profiler's timestamps need no moving
DEVICE = [Span("gemm", 20, 180), Span("bintop2_kernel<false>", 380, 640),
          Span("topk", 650, 690), Span("Memcpy DtoH", 720, 1000),
          Span("gemm", 1120, 1300),
          # batch 1's B1 starts 10 ns before its scan.b1 span: a clock fault
          Span("bintop2_kernel<false>", 1440, 1600),
          Span("topk", 1610, 1650), Span("Memcpy DtoH", 1820, 2000)]
COUNTERS = {"b1.rows_real": 84, "b1.rows_scanned": 128}


def test_idle_goes_to_the_innermost_open_span_or_outside_serve():
    out = spanwindow.summarise(PROGRAM, COUNTERS, DEVICE)
    assert out["batches"] == 2 and out["window_s"] == pytest.approx(2e-6)
    assert out["ms_a_batch"] == pytest.approx(1e-3)
    # gaps [0,20] [180,380] [640,650] [690,720] [1000,1120] [1300,1440]
    # [1600,1610] [1650,1820], each put down to the span open at its middle
    idle = {name: s for name, s in out["idle_by_span"]}
    assert idle == pytest.approx({
        "serve.route": 20e-9, "serve.group": 340e-9, "scan.phase2": 10e-9,
        "serve.merge": 180e-9, "serve.readback": 30e-9,
        spanwindow.OUTSIDE: 120e-9})
    assert sum(idle.values()) == pytest.approx(out["idle_s"])
    assert out["idle_s"] == pytest.approx(700e-9)
    assert out["shifts_ns"] == (0, 0)


def test_dispatch_idle_is_the_idle_time_inside_each_batch_before_readback():
    out = spanwindow.summarise(PROGRAM, COUNTERS, DEVICE)
    # [0,700): 20 + 200 + 10 + 10; [1100,1800): 20 + 140 + 10 + 150
    assert out["dispatch_idle_pct"] == pytest.approx(100 * 560 / 2000)
    assert out["host_dispatch_ms"] == pytest.approx(700e-6)
    busy = spanwindow.summarise(PROGRAM, COUNTERS,
                                [Span("k", -10, 3000)])
    assert busy["dispatch_idle_pct"] == 0.0 and busy["idle_s"] == 0.0
    assert busy["idle_by_span"] == []


def test_the_clock_check_counts_a_kernel_that_starts_before_its_span():
    assert spanwindow.summarise(PROGRAM, COUNTERS, DEVICE)["clock_breaks"] == 1
    fixed = [s._replace(start=1460) if s.start == 1440 else s
             for s in DEVICE]
    out = spanwindow.summarise(PROGRAM, COUNTERS, fixed)
    assert out["clock_breaks"] == 0 and out["b1_kernels"] == 2
    # a batch whose kernel the profile lost breaks it too (kernels pair with
    # batches counting back from the last; its spans move with the next
    # batch's)
    one = [s for s in fixed if s.start != 380]
    out = spanwindow.summarise(PROGRAM, COUNTERS, one)
    assert out["clock_breaks"] == 1 and out["shifts_ns"] == (0, 0)
    late = [s._replace(end=2001) if s.start == 1460 else s for s in fixed]
    assert spanwindow._clock_breaks(late, _readbacks()) == 1
    assert spanwindow._clock_breaks(fixed, _readbacks()) == 0


def _jumped(spans, shifts=(-400, 3000)):
    """The spans as a profile whose card timestamps stray by ``shifts[b]``
    ns in batch b (a profile's timestamps can jump by milliseconds; these
    keep the operations' order)."""
    return [s._replace(start=s.start + shifts[s.start > 1050],
                       end=s.end + shifts[s.start > 1050]) for s in spans]


def _readbacks():
    return [{s.name: s for s in PROGRAM if s.batch == b} for b in (0, 1)]


def test_the_cards_spans_are_moved_onto_the_host_clock():
    moved, shifts = spanwindow.align(_jumped(DEVICE), _readbacks())
    assert moved == DEVICE and shifts == (-3000, 400)
    out = spanwindow.summarise(PROGRAM, COUNTERS, _jumped(DEVICE))
    assert out["idle_s"] == pytest.approx(700e-9)
    # jumped, both B1 kernels miss their spans; on the host's clock only
    # batch 1's early start is left
    assert out["raw_clock_breaks"] == 2 and out["clock_breaks"] == 1
    # a profile that missed the first operation still splits into batches
    moved, _ = spanwindow.align(_jumped(DEVICE[1:]), _readbacks())
    assert moved == DEVICE[1:]
    # the host's exit bounds a run whose copy came late after the event
    late = [s._replace(start=s.start + 40, end=s.end + 40)
            if s.start >= 1820 else s for s in DEVICE]
    moved, shifts = spanwindow.align(late, _readbacks())
    assert shifts == (-40, 0) and moved[-1] == DEVICE[-1]
    # and the event bounds one whose host left late (the card busy up to
    # the event at 1800, the copy done at 1900, the host out at 2000)
    busy = [s._replace(end=1800) if s.start == 1610 else
            s._replace(end=1900) if s.start == 1820 else s for s in DEVICE]
    slow = [s._replace(start=s.start - 300, end=s.end - 300)
            if s.start >= 1100 else s for s in busy]
    moved, shifts = spanwindow.align(slow, _readbacks())
    assert shifts == (0, 300) and moved == busy
    # a batch whose copies the profile lost moves with the next
    lost = [s._replace(start=s.start + 50, end=s.end + 50) for s in DEVICE
            if s.start != 720]
    moved, shifts = spanwindow.align(lost, _readbacks())
    assert shifts == (-50, -50) and moved == DEVICE[:3] + DEVICE[4:]
    # no copy ends a run, or no card events: nothing is moved
    no_copy = [s for s in DEVICE if s.name != "Memcpy DtoH"]
    assert spanwindow.align(no_copy, _readbacks()) == (no_copy, None)
    cpu = [{k: v._replace(stream_at_ms=None) for k, v in b.items()}
           for b in _readbacks()]
    assert spanwindow.align(DEVICE, cpu) == (DEVICE, None)


def test_step_means_and_the_counted_padding():
    out = spanwindow.summarise(PROGRAM, COUNTERS, DEVICE)
    assert out["route_step_ms"] == pytest.approx(0.6)
    assert out["group_step_ms"] == pytest.approx(0.2)
    assert out["phase2_step_ms"] == pytest.approx(1.5)
    assert out["merge_step_ms"] == pytest.approx(0.5)
    assert out["b1_padding_counted_pct"] == pytest.approx(100 * 44 / 128)
    # no stream times (a CPU run), no counters (the exact scan)
    cpu = spanwindow.summarise(
        [s._replace(stream_ms=None, stream_at_ms=None) for s in PROGRAM], {},
        DEVICE)
    assert cpu["route_step_ms"] is None
    assert cpu["b1_padding_counted_pct"] is None
    # a batch without its read-back is left out of the window
    assert spanwindow.summarise(PROGRAM[:-1], {}, DEVICE)["batches"] == 1
    assert spanwindow.summarise([], {}, DEVICE) is None


def test_counted_padding_equals_the_benchmarks_on_the_same_batches():
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.core.profiling import Recorder, recording
    from gpann_tpu_torch.search.serve import ServingEngine

    rng = np.random.default_rng(5)
    pts = rng.standard_normal((40_000, 16)).astype(np.float32)
    assign = rng.integers(0, 4, size=len(pts))
    sample = rng.choice(len(pts), size=600, replace=False)
    eng = ServingEngine(pts, partition_to_clusters(assign, 4), pts[sample],
                        assign[sample], scan_mode="binned", device="cpu")
    batches = rng.standard_normal((3, 40, 16)).astype(np.float32)
    rec = Recorder()
    with recording(rec):
        for q in batches:
            eng.serve(q, 10, 3, voting_t=8, query_block=16)
    drained = rec.drain()
    out = spanwindow.summarise(drained.spans, drained.counters, [])
    parts = [eng.scan_inputs(q, 3, voting_t=8, query_block=16)
             for q in batches]
    live_q = torch.cat([p[3] for p in parts]).numpy()
    sizes = torch.cat([p[2] for p in parts]).numpy()
    assert out["batches"] == 3
    assert out["b1_padding_counted_pct"] == pytest.approx(
        padding_pct(live_q, sizes, 16), abs=1e-12)


def test_the_readers_find_nothing_off_a_card():
    class Ctx(NamedTuple):
        device: torch.device
        engine: object

    ctx = Ctx(torch.device("cpu"), object())
    for q in QUANTITIES:
        assert reader(q)(ctx) is None
        assert reader(q + ".host_bound")(ctx) is None


def test_every_new_entry_has_a_reader_its_cells_and_its_end_to_end_metric():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in b["per_layer"]]
    first = min(names.index(q) for q in QUANTITIES)
    assert first >= names.index("device_idle_pct.host_bound") + 1
    entries = {m["name"]: m for m in b["per_layer"]}
    for q, (unit, source, layer) in QUANTITIES.items():
        for name, moves, cells in (
                (q, "qps", ["hard8m-b4096"]),
                (q + ".host_bound", "qps.host_bound",
                 ["blobs8m-b4096", "hard8m-b256"])):
            m = entries[name]
            assert (m["unit"], m["source"], m["layer"]) == (unit, source,
                                                            layer)
            assert m["moves"] == moves and m["workloads"] == cells
            assert m["better"] == "lower"
            assert (reader(name).__code__.co_filename
                    == str(ROOT / "annbench" / "metrics" / f"{q}.py"))
