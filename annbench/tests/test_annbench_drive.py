"""A whole run of a cell at a small size on the CPU (the explicit device
argument that the benchmark's command never passes), served by each engine,
the command without a card, and the timed path broken underneath:
``correct`` must come out false for each fault that a serving cell can
have, with each engine that can have it."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from annbench.cell import run_cell
from annbench.spec import ROOT
from annbench.tests.tiny import tiny_artifact, tiny_cell


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell()
    return cell, tiny_artifact(cell.config)


def _run(tiny, trace=False, seed=2**31 + 77):
    cell, art = tiny
    return run_cell(cell, seed, 0.3, trace, "cpu", 0.0, artifact=art)


def test_a_sound_run_is_correct_and_reports_its_metrics(tiny):
    r = _run(tiny)
    assert list(r)[-2:] == ["reused_batches", "checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] % 64 == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert r["metrics"]["qps"]["unit"] == "queries/s"
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"routed_miss", "dist_err", "invalid_lists"}
    assert r["device"]["platform"] == "cpu"
    json.dumps(r, allow_nan=False)


def test_the_small_batch_cell_reports_its_own_names(tiny):
    cell = tiny_cell("hard8m-b256", batch=32)
    r = run_cell(cell, 5, 0.3, True, "cpu", 0.0, artifact=tiny[1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"b1_padding_pct.host_bound"}
    r = run_cell(cell, 5, 0.3, False, "cpu", 0.0, artifact=tiny[1])
    assert set(r["metrics"]) == {"qps.host_bound", "recall_at_10",
                                 "setup_s"}
    assert r["metrics"]["qps.host_bound"]["value"] == pytest.approx(
        r["attempted"] / 0.3, rel=0.5)


def test_the_blobs_cell_reads_each_quantity_under_its_regime_name():
    cell = tiny_cell("blobs8m-b4096", batch=32)
    art = tiny_artifact(cell.config)
    r = run_cell(cell, 6, 0.3, False, "cpu", 0.0, artifact=art)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"qps.host_bound", "recall_at_10", "setup_s"}
    assert r["metrics"]["qps.host_bound"]["unit"] == "queries/s"
    r = run_cell(cell, 6, 0.3, True, "cpu", 0.0, artifact=art)
    assert set(r["metrics"]) == {"b1_padding_pct.host_bound"}


def test_the_window_serves_no_warm_up_batch_and_reports_a_pool_it_outran(
        tiny, monkeypatch):
    from annbench import cell as cell_mod

    cell, art = tiny
    served = []
    real = cell_mod.serve

    def serve(engine, cfg, queries):
        served.append(queries.clone())
        return real(engine, cfg, queries)
    monkeypatch.setattr(cell_mod, "serve", serve)
    small = cell._replace(traffic=dict(cell.traffic, pool_batches_per_s=5))
    r = run_cell(small, 11, 0.4, False, "cpu", 0.0, artifact=art)
    pool = 2      # 5 batches a second over 0.4 s
    window = served[-r["attempted"] // 64:]
    warm = served[:-len(window)]
    assert warm and len(window) > pool
    assert r["reused_batches"] == len(window) - pool
    assert not any(torch.equal(w, x) for w in warm for x in window[:pool])
    assert torch.equal(window[0], window[pool])


def test_a_traced_run_reports_what_it_can_read_on_the_cpu(tiny):
    r = _run(tiny, trace=True)
    assert r["correct"] is True
    # no card: the device readers find nothing and stay out of the line
    assert set(r["metrics"]) == {"b1_padding_pct"}
    assert 0 < r["metrics"]["b1_padding_pct"]["value"] < 100
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_the_command_without_a_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "annbench.run", "--workload", "hard8m-b4096",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                             "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


# per engine: the program's module, its class and public entry (whose
# first two results are the batch's dists and ids), and the scan it calls
PROGRAM = {
    "resident": ("gpann_tpu_torch.search.serve", "ServingEngine", "serve",
                 "fused_topk_blocks"),
    "streamed": ("gpann_tpu_torch.search.streamed", "StreamedShardEngine",
                 "search", "fused_topk"),
}


def _entry(serving):
    module, cls, entry, _ = PROGRAM[serving]
    return getattr(importlib.import_module(module), cls), entry


def _stale(monkeypatch, serving):
    cls, entry = _entry(serving)
    real, last = getattr(cls, entry), {}

    def serve(self, *a, **kw):
        got = real(self, *a, **kw)
        out = last.get("prev", got)
        last["prev"] = got
        return out
    monkeypatch.setattr(cls, entry, serve)


def _half_left_out(monkeypatch, serving):
    cls, entry = _entry(serving)
    real = getattr(cls, entry)

    def serve(self, queries, *a, **kw):
        out = real(self, queries, *a, **kw)
        d, i = out[:2]
        h = len(i) // 2
        d[h:], i[h:] = np.inf, -1
        return out
    monkeypatch.setattr(cls, entry, serve)


def _scan_answer_altered(monkeypatch, serving):
    module, *_, scan_name = PROGRAM[serving]
    module = importlib.import_module(module)
    real = getattr(module, scan_name)

    def scan(*a, **kw):
        d, pos = real(*a, **kw)
        return d, torch.where(pos > 0, pos - 1, pos + 1)
    monkeypatch.setattr(module, scan_name, scan)


def _route_wrong(monkeypatch, serving):
    module = importlib.import_module(PROGRAM[serving][0])
    real = module._probe_rank

    def route(*a, s, nprobes, **kw):
        full = real(*a, s=s, nprobes=s, **kw)
        return full.flip(1)[:, :nprobes].contiguous()
    monkeypatch.setattr(module, "_probe_rank", route)


def _group_wrong(monkeypatch, serving):
    from gpann_tpu_torch.search import serve as serve_mod
    real = serve_mod._group

    def group(probes, s, qb):
        g = real(probes, s, qb)
        return g._replace(block_shard=(g.block_shard + 1) % s)
    monkeypatch.setattr(serve_mod, "_group", group)


# fault -> (planting function, the engines that can have it)
FAULTS = {"stale answer (state unchanged)": (_stale, PROGRAM),
          "half of the batch left out": (_half_left_out, PROGRAM),
          "scan ids altered where produced": (_scan_answer_altered, PROGRAM),
          "routing to the wrong shards": (_route_wrong, PROGRAM),
          "grouping onto the wrong shards": (_group_wrong, ("resident",))}


@pytest.mark.parametrize("serving, fault", [
    (serving, fault) for fault in sorted(FAULTS)
    for serving in FAULTS[fault][1]])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, serving,
                                            fault):
    plant, _ = FAULTS[fault]
    plant(monkeypatch, serving)
    cell = tiny_cell(serving=serving)
    r = run_cell(cell, 2**31 + 77, 0.3, False, "cpu", 0.0, artifact=tiny[1])
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_a_streamed_run_is_correct_and_reports_what_it_can_read(tiny):
    cell = tiny_cell(serving="streamed")
    r = run_cell(cell, 2**31 + 78, 0.3, False, "cpu", 0.0, artifact=tiny[1])
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] % 64 == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    # no blocks of grouped queries: the readers of B1's blocks find nothing
    r = run_cell(cell, 2**31 + 78, 0.3, True, "cpu", 0.0, artifact=tiny[1])
    assert r["correct"] is True and r["metrics"] == {}


def _stores(monkeypatch):
    """The store directories that the streamed engine's ``build`` makes."""
    from annbench.engines import streamed

    made, real = [], streamed.build

    def build(*a, **kw):
        s = real(*a, **kw)
        assert os.path.isdir(s.store_dir) and os.listdir(s.store_dir)
        made.append(s.store_dir)
        return s
    monkeypatch.setattr(streamed, "build", build)
    return made


def test_the_streamed_store_is_removed_when_the_run_ends(tiny, monkeypatch):
    made = _stores(monkeypatch)
    cell = tiny_cell(serving="streamed")
    r = run_cell(cell, 2**31 + 79, 0.2, False, "cpu", 0.0, artifact=tiny[1])
    assert r["correct"] is True
    assert len(made) == 1 and not os.path.exists(made[0])


@pytest.mark.parametrize("where", ["warm-up", "window"])
def test_the_streamed_store_is_removed_when_the_run_fails(tiny, monkeypatch,
                                                          where):
    from annbench import cell as cell_mod

    made = _stores(monkeypatch)
    real, calls = cell_mod.closed_loop, []

    def closed_loop(*a, **kw):
        calls.append(1)
        if where == "warm-up" or len(calls) > 1:
            raise RuntimeError("fault")
        return real(*a, **kw)
    monkeypatch.setattr(cell_mod, "closed_loop", closed_loop)
    with pytest.raises(RuntimeError, match="fault"):
        run_cell(tiny_cell(serving="streamed"), 2**31 + 80, 0.2, False,
                 "cpu", 0.0, artifact=tiny[1])
    assert len(made) == 1 and not os.path.exists(made[0])


def test_a_configuration_that_names_a_missing_engine_fails_before_set_up(
        tiny, monkeypatch):
    from annbench import datagen

    def base(*a, **kw):
        raise AssertionError("set-up began")
    monkeypatch.setattr(datagen, "base_and_check_queries", base)
    cell = tiny_cell()
    cell = cell._replace(config=dict(cell.config, serving="nowhere"))
    with pytest.raises(FileNotFoundError, match="'nowhere'"):
        run_cell(cell, 1, 0.2, False, "cpu", 0.0, artifact=tiny[1])
