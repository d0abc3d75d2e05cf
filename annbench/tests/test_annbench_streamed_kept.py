"""The streamed cell at a small size on the CPU: the engine whose store is
kept at a fixed path (``engines/streamed_kept.py``), the stream window and
its readers (``streamwindow.py``, ``metrics/stream_*.py``), B2's work count
(``roofline_b2.py``), and the faults that a streamed cell can have.

``tiny.py``'s cell with the streamed configuration's ``serving`` and
``engine`` set here; every store is kept in a temporary directory of the
test's own."""

import json
import os
import subprocess
import sys
import tempfile
import types
from typing import NamedTuple

import numpy as np
import pytest
import torch

from annbench import datagen, streamwindow
from annbench.cell import Ctx, run_cell, setup
from annbench.engines import streamed_kept
from annbench.roofline_b2 import b2_bytes, b2_ops, b2_work
from annbench.spec import ROOT, reader
from annbench.tests.test_annbench_drive import FAULTS
from annbench.tests.tiny import STREAMED_ENGINE, tiny_artifact, tiny_cell

CELL = "hard8m-streamed"
STREAM_METRICS = ("stream_gather_ms.host_bound", "stream_upload_ms.host_bound",
                  "stream_scan_ms.host_bound")


def kept_cell():
    cell = tiny_cell(CELL)
    return cell._replace(config=dict(cell.config, serving="streamed_kept",
                                     engine=dict(STREAMED_ENGINE)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the timed tests of the other files, run beside
    this one, must not find the host taken."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    cell = kept_cell()
    art = tiny_artifact(cell.config)
    cfg = cell.config
    base, _ = datagen.base_and_check_queries(
        cfg["data"], cfg["num_points"], cfg["dim"], cfg["check_queries"],
        cfg["base_seed"])
    return cell, art, base


@pytest.fixture(autouse=True)
def tmpdir_of_the_test(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def _build(tiny):
    cell, art, base = tiny
    return streamed_kept.build(base, art["assign"], art["routing_points"],
                               art["routing_labels"], cell.config, "cpu")


def _writes(monkeypatch):
    """The directories that the program's ``relayout_to_store`` writes."""
    from gpann_tpu_torch.search import relayout

    out, real = [], relayout.relayout_to_store

    def write(points, part, num_shards, out_dir, **kw):
        out.append(out_dir)
        return real(points, part, num_shards, out_dir, **kw)
    monkeypatch.setattr(relayout, "relayout_to_store", write)
    return out


def _served_ids(s, cell, art):
    q = torch.as_tensor(art["routing_points"][:32])
    return streamed_kept.serve(s, cell.config, q)[1]


def test_a_kept_cell_runs_correct_and_reports_its_metrics(tiny):
    cell, art, _ = tiny
    r = run_cell(cell, 2**31 + 91, 0.3, False, "cpu", 0.0, artifact=art)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] % 64 == 0 and r["attempted"] > 0
    # the rate is read per layer here (window_qps.streamed), not end to end
    assert set(r["metrics"]) == {"recall_at_10", "setup_s"}
    json.dumps(r, allow_nan=False)


def test_the_store_sits_at_its_key_and_a_second_build_reuses_it(
        tiny, monkeypatch, capfd, tmpdir_of_the_test):
    cell, art, _ = tiny
    writes = _writes(monkeypatch)
    first = _build(tiny)
    path = streamed_kept.store_path(cell.config, art["assign"])
    assert first.store_dir == path
    assert os.path.dirname(path) == str(tmpdir_of_the_test)
    name = os.path.basename(path)
    assert name.startswith("annbench-store-hard-8m-96d-32s-")
    assert len(name.rsplit("-", 1)[1]) == 16
    assert writes == [path + f".partial-{os.getpid()}"]
    stamps = {p: os.stat(os.path.join(path, p)).st_mtime_ns
              for p in os.listdir(path)}
    want = _served_ids(first, cell, art)
    streamed_kept.close(first)
    assert os.path.isdir(path)
    capfd.readouterr()
    second = _build(tiny)
    assert "store reused" in capfd.readouterr().err
    assert len(writes) == 1
    assert {p: os.stat(os.path.join(path, p)).st_mtime_ns
            for p in os.listdir(path)} == stamps
    np.testing.assert_array_equal(_served_ids(second, cell, art), want)
    assert os.listdir(tmpdir_of_the_test) == [name]
    # another partition is another store
    other = np.roll(art["assign"], 1)
    assert streamed_kept.store_path(cell.config, other) != path


def _dead_pid():
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


@pytest.mark.parametrize("fault", ["incomplete meta", "short shard file",
                                   "another partition's"])
def test_an_incomplete_store_at_the_path_is_never_served(tiny, monkeypatch,
                                                         fault):
    cell, art, _ = tiny
    s = _build(tiny)
    want = _served_ids(s, cell, art)
    path = s.store_dir
    if fault == "incomplete meta":
        meta = os.path.join(path, "meta.json")
        with open(meta) as f:
            m = json.load(f)
        m["complete"] = False
        with open(meta, "w") as f:
            json.dump(m, f)
    elif fault == "short shard file":
        shard = os.path.join(path, "shard_00001.bin")
        os.truncate(shard, os.path.getsize(shard) - 4)
    else:
        m_path = os.path.join(path, "meta.json")
        with open(m_path) as f:
            m = json.load(f)
        m["sizes"] = m["sizes"][1:] + m["sizes"][:1]
        with open(m_path, "w") as f:
            json.dump(m, f)
    writes = _writes(monkeypatch)
    again = _build(tiny)
    assert len(writes) == 1
    assert streamed_kept._open(path, art["assign"], cell.config["num_shards"],
                               cell.config["dim"]) is not None
    np.testing.assert_array_equal(_served_ids(again, cell, art), want)


def test_a_partial_directory_is_never_served_and_a_stale_one_goes(
        tiny, monkeypatch, tmpdir_of_the_test):
    cell, art, _ = tiny
    path = streamed_kept.store_path(cell.config, art["assign"])
    # a complete store under a partial name, left by a process that is gone
    stale = f"{path}.partial-{_dead_pid()}"
    streamed_kept._write(tiny[2], art["assign"], cell.config["num_shards"],
                         stale)
    assert os.path.isdir(stale)
    writes = _writes(monkeypatch)
    s = _build(tiny)
    assert len(writes) == 1 and s.store_dir == path
    assert not os.path.exists(stale)
    assert sorted(os.listdir(tmpdir_of_the_test)) == [os.path.basename(path)]


def test_a_write_that_fails_leaves_nothing_at_the_path(tiny, monkeypatch,
                                                       tmpdir_of_the_test):
    from gpann_tpu_torch.search import relayout

    real = relayout.relayout_to_store

    def half(points, part, num_shards, out_dir, **kw):
        real(points[: len(points) // 2], part[: len(part) // 2], num_shards,
             out_dir, **kw)
        raise OSError("disk full")
    monkeypatch.setattr(relayout, "relayout_to_store", half)
    with pytest.raises(OSError, match="disk full"):
        _build(tiny)
    assert os.listdir(tmpdir_of_the_test) == []
    # and a run that fails so writes nothing either
    with pytest.raises(OSError, match="disk full"):
        run_cell(tiny[0], 2**31 + 92, 0.2, False, "cpu", 0.0,
                 artifact=tiny[1])
    assert os.listdir(tmpdir_of_the_test) == []


def _ctx(tiny, seed=2**31 + 93):
    cell, art, _ = tiny
    s = setup(cell, seed, 0.2, torch.device("cpu"), art)
    return Ctx(s.engine, s.pool, cell.config, cell.traffic, [0, 1], None,
               torch.device("cpu"), "cpu", lambda i: None)


def test_a_traced_run_reports_nothing_the_cpu_cannot_read(tiny):
    cell, art, _ = tiny
    r = run_cell(cell, 2**31 + 94, 0.3, True, "cpu", 0.0, artifact=art)
    assert r["correct"] is True
    # no card: no stream window, no device trace
    assert r["metrics"] == {}
    assert {m["name"] for m in cell.per_layer} == {
        "window_qps.streamed", "device_idle_pct.streamed", *STREAM_METRICS,
        "b2_roofline.host_bound"}


def test_the_stream_window_reads_the_programs_spans(tiny, monkeypatch):
    monkeypatch.setattr(streamwindow, "STREAM_SECONDS", 0.2)
    ctx = _ctx(tiny)
    assert streamwindow.window(ctx) is None     # off a card
    out = streamwindow._serve(ctx)
    n = out["passes"]
    assert n >= 1
    assert out["stream_gather_ms"] > 0 and out["stream_upload_ms"] > 0
    assert out["stream_scan_ms"] is None        # no card, no events
    assert out["host_ms"]["stream.pass"] >= sum(
        out["host_ms"][s] for s in streamwindow.STEPS)
    c = out["counters"]
    shards = ctx.config["num_shards"]
    assert c["stream.blocks_binned"] + c.get("stream.blocks_exact", 0) \
        <= n * shards
    assert 0 < c["stream.bytes_read"] <= n * ctx.config["num_points"] \
        * ctx.config["dim"] * 4
    assert c["stream.bytes_uploaded"] == sum(
        p["bytes_uploaded"] for p in ctx.engine.passes[-n:])
    # a program without the spans (the parent's) gives no window
    from gpann_tpu_torch.search import streamed
    monkeypatch.setattr(streamed, "profiling",
                        types.SimpleNamespace(RECORDER=None))
    assert streamwindow._serve(ctx) is None


def test_the_stream_window_means_a_pass():
    class P(NamedTuple):
        name: str
        batch: int
        start_ns: int
        end_ns: int
        stream_ms: object = None

    spans = []
    for b, t in ((0, 0), (1, 10_000_000)):
        spans += [P("stream.pass", b, t, t + 9_000_000, 9.0),
                  P("stream.route", b, t, t + 1_000_000, 0.5),
                  P("stream.gather", b, t + 1_000_000, t + 3_000_000, 0.1),
                  P("stream.upload", b, t + 3_000_000, t + 4_000_000, 1.0),
                  P("stream.scan", b, t + 4_000_000, t + 5_000_000,
                    2.0 + b),
                  P("stream.gather", b, t + 5_000_000, t + 7_000_000, 0.1),
                  P("stream.merge", b, t + 8_000_000, t + 9_000_000, 0.2)]
    # a pass whose root never ended is left out
    spans.append(P("stream.gather", 2, 30_000_000, 31_000_000, 0.1))
    out = streamwindow.summarise(spans, {"stream.bytes_read": 8})
    assert out["passes"] == 2 and out["pass_ms"] == pytest.approx(9.0)
    assert out["stream_gather_ms"] == pytest.approx(4.0)
    assert out["stream_upload_ms"] == pytest.approx(1.0)
    assert out["stream_scan_ms"] == pytest.approx(2.5)
    assert out["outside_ms"] == pytest.approx(1.0)
    assert out["counters"] == {"stream.bytes_read": 8}
    cpu = streamwindow.summarise([s._replace(stream_ms=None) for s in spans],
                                 {})
    assert cpu["stream_scan_ms"] is None and cpu["stream_gather_ms"] == 4.0
    assert streamwindow.summarise(spans[-1:], {}) is None


def test_b2_work_counts_each_probed_shards_pairs(tiny):
    cell, art, _ = tiny
    s = _build(tiny)
    cfg = cell.config
    q = art["routing_points"][:48]
    mq, sizes = b2_work(s.engine, cfg, q)
    probes = s.engine.probe_order(q, cfg["nprobes"], voting_t=cfg["voting_t"],
                                  rule=cfg["rule"])
    pairs = np.bincount(probes[probes < 4].ravel(), minlength=4)
    assert pairs.sum() == 48 * 2
    assert (sizes == np.bincount(art["assign"], minlength=4)).all()
    # a shard too small for the binned scan takes the exact one: no B2
    binned = [s.engine.takes_binned(int(n), cfg["k"]) for n in sizes]
    assert (mq == np.where(binned, pairs, 0)).all() and mq.sum() > 0
    d = cfg["dim"]
    assert b2_ops(mq, sizes, d) == 2 * d * float((mq * sizes).sum())
    # hand-made: shard 0 (300 rows: 3 bins) for 2 queries, shard 2 for 1
    mq, sizes = np.array([2, 0, 1]), np.array([300, 50, 128])
    assert b2_ops(mq, sizes, 4) == 2 * 4 * (600 + 128)
    assert b2_bytes(mq, sizes, 4) == 4 * ((428 + 3) * 4 + 2 * 4 * 3 + 4)


def test_the_b2_reader_needs_a_streamed_engine_and_a_trace(tiny):
    class T:
        def kernel_s(self, name):
            return 1.0

    read = reader("b2_roofline.host_bound")
    ctx = _ctx(tiny)
    assert read(ctx) is None                             # no trace
    assert read(ctx._replace(trace=T(), engine=object())) is None
    # no peaks for a CPU: nothing, and no exception
    assert read(ctx._replace(trace=T())) is None
    assert read(ctx._replace(trace=T(), kind="NVIDIA H100 80GB HBM3")) > 0


@pytest.mark.parametrize("fault", sorted(
    f for f, (_, engines) in FAULTS.items() if "streamed" in engines))
def test_a_broken_streamed_path_is_not_correct(tiny, monkeypatch, fault):
    plant, _ = FAULTS[fault]
    plant(monkeypatch, "streamed")
    r = run_cell(tiny[0], 2**31 + 77, 0.3, False, "cpu", 0.0,
                 artifact=tiny[1])
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_cells_entries_and_readers():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in b["workloads"]}
    assert cells[CELL]["chips"] == 1
    entries = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    # the cell's rate spreads too widely for an end-to-end bound: it is
    # read per layer, and the cell's layers move its recall
    for name in ("qps.host_bound", "device_idle_pct.host_bound"):
        assert CELL not in entries[name]["workloads"]
    assert {m["name"] for m in b["end_to_end"]
            if CELL in m.get("workloads", [CELL])} == {"recall_at_10",
                                                       "setup_s"}
    for name in STREAM_METRICS + ("b2_roofline.host_bound",
                                  "window_qps.streamed",
                                  "device_idle_pct.streamed"):
        m = entries[name]
        assert m["workloads"] == [CELL] and m["moves"] == "recall_at_10"
        q = name.split(".")[0]
        assert (reader(name).__code__.co_filename
                == str(ROOT / "annbench" / "metrics" / f"{q}.py"))
    cfg = json.loads(
        (ROOT / "annbench" / "configs" / "hard-8m-96d-32s-streamed.json")
        .read_text())
    assert cfg["serving"] == "streamed_kept"
    assert cfg["engine"] == STREAMED_ENGINE
    limits = json.loads(
        (ROOT / "annbench" / "limits" / f"{CELL}.json").read_text())
    assert limits["limits"]["invalid_lists"] == 0


def test_the_window_rate_reads_the_traced_window_on_a_card(tiny):
    class T(NamedTuple):
        window_s: float

    read = reader("window_qps.streamed")
    ctx = _ctx(tiny)                                    # served [0, 1]
    assert read(ctx) is None                            # no trace
    assert read(ctx._replace(trace=T(2.0))) is None     # no card
    on_card = ctx._replace(trace=T(2.0), device=torch.device("cuda"))
    assert read(on_card) == 2 * ctx.traffic["batch"] / 2.0
    assert read(on_card._replace(served=[])) is None
