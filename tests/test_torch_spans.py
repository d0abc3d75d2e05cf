"""Spans and counters recorded inside the serving engine
(``core/profiling.py``'s recorder at the call sites of ``search/serve.py``
and ``search/bin_scan.py``).

The engines are the small ones of ``tests/test_torch_serve.py``, built here
with the port's own constructor: 40k x 16 in 3 shards on the binned scan,
4000 x 16 in 8 shards on the exact scan. The file imports no JAX, so its
``gpu`` case also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import numpy as np
import pytest
import torch

from gpann_tpu_torch.core import profiling
from gpann_tpu_torch.core.partition import partition_to_clusters
from gpann_tpu_torch.core.profiling import Recorder, recording
from gpann_tpu_torch.search.serve import ServingEngine

K, NPROBES, VOTING_T, QB = 10, 2, 8, 16
STEPS = ("serve.route", "serve.group", "serve.scan", "serve.merge")
SCAN_STEPS = ("scan.b1", "scan.phase2")


def _engine(n, shards, scan_mode, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 16)).astype(np.float32)
    assign = rng.integers(0, shards, size=n)
    clusters = partition_to_clusters(assign, shards)
    sample = rng.choice(n, size=600, replace=False)
    eng = ServingEngine(pts, clusters, pts[sample], assign[sample],
                        scan_mode=scan_mode, device=device)
    queries = rng.standard_normal((3, 32, 16)).astype(np.float32)
    return eng, queries


@pytest.fixture(scope="module")
def binned():
    eng, queries = _engine(40_000, 3, "binned", 11)
    assert eng._binned(K)
    return eng, queries


@pytest.fixture(scope="module")
def exact():
    eng, queries = _engine(4000, 8, "exact", 555)
    return eng, queries


def _serve(eng, q):
    return eng.serve(q, K, NPROBES, voting_t=VOTING_T, query_block=QB)


def _by_name(spans):
    return {s.name: s for s in spans}


def _assert_tree(spans, steps, scan_steps):
    """One batch: a root ``serve.batch`` whose children are ``steps`` in
    order, ``serve.scan``'s children ``scan_steps``, each inside its parent."""
    names = _by_name(spans)
    assert len(names) == len(spans) == 1 + len(steps) + len(scan_steps)
    root = names["serve.batch"]
    assert root.parent == -1
    assert len({s.batch for s in spans}) == 1
    kids = [s for s in spans if s.parent == root.id]
    assert tuple(s.name for s in kids) == steps
    assert tuple(s.name for s in spans if s.parent == names["serve.scan"].id
                 ) == scan_steps
    for s in spans[1:]:
        parent = next(p for p in spans if p.id == s.parent)
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns


def test_off_serves_the_same_and_reads_no_clock(binned, monkeypatch):
    eng, queries = binned
    with recording(Recorder()):
        want = _serve(eng, queries[0])
    idle = Recorder()

    def boom(*a, **kw):
        raise AssertionError("the recorder was reached while off")
    for name in ("begin", "next", "end", "count"):
        monkeypatch.setattr(Recorder, name, boom)
    monkeypatch.setattr(profiling, "time", None)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert profiling.RECORDER is None
    d, i = _serve(eng, queries[0])
    np.testing.assert_array_equal(d, want[0])
    np.testing.assert_array_equal(i, want[1])
    monkeypatch.undo()
    assert idle.drain() == ([], {})


def test_a_binned_serve_records_the_tree(binned):
    eng, queries = binned
    rec = Recorder()
    with recording(rec):
        _serve(eng, queries[0])
    out = rec.drain()
    _assert_tree(out.spans, STEPS + ("serve.readback",), SCAN_STEPS)
    # no card: no events
    assert all(s.stream_ms is None and s.stream_at_ms is None
               for s in out.spans)
    assert set(out.counters) == {"b1.rows_real", "b1.rows_scanned"}


@pytest.mark.parametrize("entry", ["serve_device", "serve_scan",
                                   "recall_curve"])
def test_the_device_entries_record_no_readback(binned, entry):
    eng, queries = binned
    rec = Recorder()
    with recording(rec):
        if entry == "serve_device":
            eng.serve_device(queries[0], K, NPROBES, voting_t=VOTING_T,
                             query_block=QB)
        elif entry == "serve_scan":
            eng.serve_scan(queries[:2], K, NPROBES, voting_t=VOTING_T,
                           query_block=QB)
        else:
            eng.recall_curve(queries[0], K, np.ones(32, np.float32),
                             voting_t=VOTING_T, query_block=QB)
    spans = rec.drain().spans
    batches = sorted({s.batch for s in spans})
    assert len(batches) == (2 if entry == "serve_scan" else 1)
    for b in batches:
        _assert_tree([s for s in spans if s.batch == b], STEPS, SCAN_STEPS)


def test_the_exact_scan_records_a_scan_without_children(exact):
    eng, queries = exact
    assert not eng._binned(K)
    rec = Recorder()
    with recording(rec):
        _serve(eng, queries[0])
    out = rec.drain()
    _assert_tree(out.spans, STEPS + ("serve.readback",), ())
    assert out.counters == {}


def test_b1_counters_equal_the_scan_inputs_counts(binned):
    eng, queries = binned
    rec = Recorder()
    with recording(rec):
        for q in queries:
            _serve(eng, q)
    counters = rec.drain().counters
    real = scanned = 0
    for q in queries:
        _, _, sizes, live_q = eng.scan_inputs(q, NPROBES, voting_t=VOTING_T,
                                              query_block=QB)
        real += int(live_q[sizes > 0].sum())
        scanned += int((sizes > 0).sum()) * QB
    assert counters == {"b1.rows_real": real, "b1.rows_scanned": scanned}
    assert 0 < real < scanned


def test_spans_lie_on_the_profilers_clock(binned):
    from torch.profiler import ProfilerActivity, profile, record_function

    eng, queries = binned
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording(rec):
        sid = rec.begin("probe", torch.device("cpu"), root=True)
        with record_function("probe"):
            _serve(eng, queries[0])
        rec.end(sid, torch.device("cpu"))
    ours = _by_name(rec.drain().spans)["probe"]
    theirs = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "probe"]
    assert len(theirs) == 1
    start = theirs[0].start_ns()
    end = start + theirs[0].duration_ns()
    assert abs(start - ours.start_ns) < 1_000_000
    assert abs(end - ours.end_ns) < 1_000_000


def test_two_serves_two_batch_ids_and_drain_empties(binned):
    eng, queries = binned
    rec = Recorder()
    with recording(rec):
        _serve(eng, queries[0])
        _serve(eng, queries[1])
    assert profiling.RECORDER is None
    out = rec.drain()
    assert sorted({s.batch for s in out.spans}) == [0, 1]
    assert [s.name for s in out.spans].count("serve.readback") == 2
    assert rec.drain() == ([], {})


def test_a_span_never_ended_is_dropped():
    rec = Recorder()
    cpu = torch.device("cpu")
    rec.begin("serve.batch", cpu, root=True)
    rec.begin("serve.route", cpu)       # an exception: neither span ends
    root = rec.begin("serve.batch", cpu, root=True)
    step = rec.begin("serve.route", cpu)
    rec.end(step, cpu)
    rec.end(root, cpu)
    rec.count("n", 2)
    rec.count("n", torch.tensor(3))
    out = rec.drain()
    assert [(s.name, s.batch, s.parent) for s in out.spans] == [
        ("serve.batch", 1, -1), ("serve.route", 1, root)]
    assert out.counters == {"n": 5}


@pytest.mark.gpu
def test_steps_on_the_card_take_stream_time_within_their_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    eng, queries = _engine(40_000, 3, "binned", 11, device="cuda:0")
    _serve(eng, queries[0])              # builds the kernel library
    rec = Recorder()
    with recording(rec):
        for q in queries:
            _serve(eng, q)
    out = rec.drain()
    assert out.counters["b1.rows_scanned"] > out.counters["b1.rows_real"] > 0
    for b in range(3):
        spans = [s for s in out.spans if s.batch == b]
        _assert_tree(spans, STEPS + ("serve.readback",), SCAN_STEPS)
        assert all(s.stream_ms > 0 for s in spans)
        root = _by_name(spans)["serve.batch"]
        kids = [s for s in spans if s.parent == root.id]
        # each elapsed time is rounded to the events' ~0.5 us resolution
        assert (sum(s.stream_ms for s in kids)
                <= root.stream_ms + 1e-3 * len(kids))
        ats = [root.stream_at_ms] + [s.stream_at_ms for s in kids]
        assert ats == sorted(ats) and ats[0] >= 0
