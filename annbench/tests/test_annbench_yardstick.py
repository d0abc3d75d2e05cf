"""The yardstick on the CPU: the reference, the judged numbers, the window's
statistics, B1's work, the trace reader, BENCHMARK.json and the imports."""

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from annbench import judge, reference, roofline
from annbench.cell import Window, window_metrics
from annbench.spec import ROOT, load_cell, quantity, reader
from annbench.trace import WINDOW_SPAN, Span, Trace


def _data(n=3000, d=12, m=40, shards=5, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((m, d)).astype(np.float32)
    shard_of = rng.integers(0, shards, n)
    return base, q, shard_of


def _brute(base, q, k, rows=None):
    d2 = ((q[:, None, :].astype(np.float64) - base[None]) ** 2).sum(-1)
    if rows is not None:
        d2 = np.where(rows, d2, np.inf)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d2, ids, 1)


def test_reference_top10_equals_numpy_brute_force():
    base, q, shard_of = _data()
    probes = torch.tensor(np.stack([np.random.default_rng(i).permutation(5)[:2]
                                    for i in range(len(q))]))
    res = reference.search(torch.as_tensor(q), torch.as_tensor(base),
                           torch.as_tensor(shard_of), probes, 5, 10)
    ids, dists = _brute(base, q, 10)
    assert np.array_equal(res.whole.ids.numpy(), ids)
    np.testing.assert_allclose(res.whole.dists.numpy(), dists, rtol=1e-12)
    mask = (shard_of[None, :] == probes.numpy()[:, :1]) | (
        shard_of[None, :] == probes.numpy()[:, 1:2])
    rids, rdists = _brute(base, q, 10, mask)
    assert np.array_equal(res.routed.ids.numpy(), rids)
    np.testing.assert_allclose(res.routed.dists.numpy(), rdists, rtol=1e-12)


def test_route_is_min_dist_over_the_top_t_votes():
    rng = np.random.default_rng(5)
    rp = rng.standard_normal((200, 6)).astype(np.float32)
    labels = rng.integers(0, 7, 200)
    q = rng.standard_normal((30, 6)).astype(np.float32)
    got = reference.route(torch.as_tensor(q), torch.as_tensor(rp),
                          torch.as_tensor(labels), 7, 12, 4).numpy()
    for i in range(len(q)):
        d2 = ((rp.astype(np.float64) - q[i]) ** 2).sum(1)
        top = np.argsort(d2)[:12]
        best = {}
        for j in top:
            best[labels[j]] = min(best.get(labels[j], np.inf), d2[j])
        order = sorted(range(7), key=lambda s: (best.get(s, np.inf), s))
        assert list(got[i]) == order[:4]


def test_route_and_search_agree_with_the_program_on_small_data():
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.search.serve import ServingEngine

    base, q, shard_of = _data(n=40_000, d=16, m=64, shards=4, seed=9)
    sub = np.arange(0, len(base), 20)
    engine = ServingEngine(base, partition_to_clusters(shard_of, 4),
                           base[sub], shard_of[sub], scan_mode="binned",
                           voting_impl="approx", scan_phase2="approx",
                           device="cpu")
    probes = engine.probe_order(q, 2, voting_t=30)
    want = reference.route(torch.as_tensor(q), torch.as_tensor(base[sub]),
                           torch.as_tensor(shard_of[sub]), 4, 30, 2)
    assert np.array_equal(probes, want.numpy())
    dists, ids = engine.serve(q, 10, 2, voting_t=30, query_block=128)
    res = reference.search(torch.as_tensor(q), torch.as_tensor(base),
                           torch.as_tensor(shard_of), want, 4, 10)
    exact = reference.exact_distances(torch.as_tensor(q),
                                      torch.as_tensor(base),
                                      torch.as_tensor(ids).long())
    kth = res.routed.dists[:, 9]
    # the binned scan keeps two rows of each 128-row bin: with ~80 bins a
    # shard, three of a query's ten may share one
    assert judge.recall(torch.as_tensor(ids).long(), exact, kth, 10) >= 0.99
    assert judge.dist_err(torch.as_tensor(dists), exact, kth) < 1e-5


def test_tf32_control_rounds_its_products():
    x = torch.tensor([[1.0 + 2.0 ** -12]])
    assert reference._round_tf32(x).item() == 1.0
    base, q, shard_of = _data(n=2000, d=32, m=20)
    probes = torch.zeros((20, 1), dtype=torch.int64)
    hi = reference.search(torch.as_tensor(q), torch.as_tensor(base),
                          torch.as_tensor(shard_of), probes, 5, 10)
    lo = reference.search(torch.as_tensor(q), torch.as_tensor(base),
                          torch.as_tensor(shard_of), probes, 5, 10,
                          precision="tf32")
    exact = reference.exact_distances(torch.as_tensor(q),
                                      torch.as_tensor(base), lo.whole.ids)
    assert judge.dist_err(lo.whole.dists, exact, hi.whole.dists[:, 9]) > 1e-4


def test_recall_tie_rule_duplicates_and_invalid_ids():
    kth = torch.tensor([10.0, 10.0])
    ids = torch.tensor([[1, 2, 3], [4, 4, -1]])
    # 10.0009 lies within 10 + 1e-5 + 1e-4 * 10; 10.002 does not
    exact = torch.tensor([[1.0, 10.0009, 10.002], [5.0, 5.0, np.inf]],
                         dtype=torch.float64)
    assert judge.recall(ids, exact, kth, 3) == pytest.approx(3 / 6)
    # at most k hits a query
    ids = torch.tensor([[1, 2, 3]])
    exact = torch.tensor([[1.0, 2.0, 3.0]], dtype=torch.float64)
    assert judge.recall(ids, exact, torch.tensor([9.0]), 2) == 1.0


def test_dist_err_and_invalid_lists():
    exact = torch.tensor([[4.0, 8.0, np.inf]], dtype=torch.float64)
    served = torch.tensor([[4.0, 8.5, 1.0]])
    assert judge.dist_err(served, exact, torch.tensor([10.0])) == \
        pytest.approx(0.05)
    ids = [np.array([[0, 1, 2], [3, 3, 4]]), np.array([[5, 6, 9], [-1, 0, 1]])]
    assert judge.invalid_lists(ids, 9) == 3
    c = judge.checks({"a": 0.1, "b": 2.0}, {"a": 0.2, "b": 1.0})
    assert c["a"]["ok"] and not c["b"]["ok"]
    with pytest.raises(KeyError):
        judge.checks({"a": 0.1}, {"a": 0.2, "c": 0.0})


def test_window_metrics_take_all_batches_and_all_time():
    lat = [0.001 * (i + 1) for i in range(100)]    # 1 .. 100 ms
    win = Window(lat, [None] * 100, [None] * 100, list(range(100)), 12.5)
    got = window_metrics(win, 256)
    assert got["qps"] == pytest.approx(100 * 256 / 12.5)
    assert got["batch_p95_ms"] == pytest.approx(95.05)


def test_b1_ops_bytes_and_padding_from_a_hand_made_grouping():
    # 4 blocks of 128 rows: two of shard 0 (size 1000), one of shard 1
    # (size 300), one skipped (size 0)
    live_q = np.array([128, 20, 50, 0])
    sizes = np.array([1000, 1000, 300, 0])
    row_off = np.array([0, 0, 1024, 2048])
    d = 96
    assert roofline.b1_ops(live_q, sizes, d) == 2 * d * (148 * 1000 + 50 * 300)
    words = (1000 + 300 + 198) * d + 4 * (148 * 8 + 50 * 3)
    assert roofline.b1_bytes(live_q, sizes, row_off, d) == 4 * words
    assert roofline.padding_pct(live_q, sizes, 128) == pytest.approx(
        100 * (384 - 198) / 384)
    ops, nbytes = 495e12 * 1e-3, 3.35e12 * 2e-3
    assert roofline.roofline_pct(ops, nbytes, 4e-3,
                                 "NVIDIA H100 80GB HBM3") == pytest.approx(50)
    assert roofline.roofline_pct(ops, nbytes, 4e-3, "cpu") is None


def test_trace_busy_union_kernel_time_and_gaps():
    device = [Span("bintop2_kernel<1>", 100, 300), Span("copy", 250, 400),
              Span("bintop2_kernel<1>", 600, 700), Span("outside", 5000, 6000)]
    host = [Span(WINDOW_SPAN, 0, 1000), Span("aten::item", 420, 580),
            Span("cudaMemcpyAsync", 430, 560)]
    tr = Trace.annotated(device, host)
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s() == pytest.approx(400e-9)
    assert tr.kernel_s("bintop2") == pytest.approx(300e-9)
    assert tr.kernel_s("nothing") is None
    gaps = dict(map(tuple, tr.idle_gaps()))
    assert gaps["cudaMemcpyAsync"] == pytest.approx(200e-9)
    assert gaps["host: between operators"] == pytest.approx(400e-9)
    assert tr.top_device_ops()[0] == ["bintop2_kernel<1>", pytest.approx(3e-7)]


def test_a_device_only_trace_spans_the_host_window_from_its_first_span():
    device = [Span("bintop2_kernel<1>", 1000, 1300), Span("copy", 1200, 1400),
              Span("topk", 2000, 2100)]
    tr = Trace.device_only(device, 2e-6)
    assert tr.window_s == pytest.approx(2e-6)
    assert tr.busy_s() == pytest.approx(500e-9)
    assert tr.kernel_s("bintop2") == pytest.approx(300e-9)
    assert Trace.device_only([], 1.0).busy_s() == 0.0


def test_a_regime_name_reads_its_quantity():
    assert quantity("qps.host_bound") == "qps" and quantity("qps") == "qps"
    assert (reader("route_ms.host_bound").__code__.co_filename
            == reader("route_ms").__code__.co_filename)
    with pytest.raises(FileNotFoundError):
        reader("no_such_metric.host_bound")


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_units_and_files():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["annbench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(key) for key in c["reduced"])
    metrics = b["end_to_end"] + b["per_layer"]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert quantity(m["name"]) in ("qps", "batch_p95_ms", "recall_at_10",
                                       "setup_s")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert reader(m["name"]) is not None
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    pairs = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
    all_names = names + [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in metrics]
    assert len(all_names) == len(set(all_names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


FORBIDDEN = "{'jax', 'jaxlib', 'flax', 'gpann_tpu'}"


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')"
         "[0] for m in sys.modules}))"], cwd=ROOT, capture_output=True,
        text=True, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_path_imports_no_jax_and_reference_nothing_of_the_program():
    loaded = _loaded_after(
        "from annbench.tests.tiny import tiny_cell, tiny_artifact\n"
        "from annbench.cell import run_cell\n"
        "import annbench.run, annbench.control\n"
        "c = tiny_cell()\n"
        "run_cell(c, 3, 0.2, True, 'cpu', 0.0, artifact=tiny_artifact("
        "c.config))")
    assert "gpann_tpu_torch" in loaded
    assert not loaded & eval(FORBIDDEN)
    ref = _loaded_after("import annbench.reference, annbench.judge")
    assert not ref & (eval(FORBIDDEN) | {"gpann_tpu_torch"})
