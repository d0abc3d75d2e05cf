"""Spans and counters recorded inside the streamed engine
(``core/profiling.py``'s recorder at the call sites of
``search/streamed.py``), and the streamed engine against the benchmark's
plain reference (``annbench/reference``, judged by ``annbench.cell.compare``
with the limits of the streamed cell).

The engines serve a shard-major store of a seeded ``hard`` base, 200,000 x
96 in 8 shards by the nearest of 8 base points (10 to 45,511 rows), routed
by every 10th point. The shards hold hundreds of 128-row bins, so the
binned scan's cut to two rows a bin costs as little recall as in the
streamed cell, whose shards hold ~1,950 bins, and its limits apply. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_streamed_spans.py -q
"""

import numpy as np
import pytest
import torch

from annbench.cell import Truth, compare
from annbench.judge import invalid_lists
from gpann_tpu_torch.core import profiling
from gpann_tpu_torch.core.profiling import Recorder, recording
from gpann_tpu_torch.eval.synth import generate, generate_queries
from gpann_tpu_torch.search.relayout import relayout_to_store
from gpann_tpu_torch.search.streamed import StreamedShardEngine

N, D, S, K, NPROBES, VOTING_T = 200_000, 96, 8, 10, 3, 60
# the streamed cell's limits (annbench/limits/hard8m-streamed.json)
LIMITS = {"routed_miss": 1e-3, "dist_err": 1e-4, "invalid_lists": 0}
STEPS = ("stream.upload", "stream.scan")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = generate("hard", N, D, seed=21)
    queries = generate_queries("hard", 256, D, seed=21)
    rng = np.random.default_rng(21)
    centres = base[rng.choice(N, S, replace=False)]
    shard_of = ((centres ** 2).sum(1)[None] - 2 * base @ centres.T).argmin(1)
    store = relayout_to_store(base, shard_of, S,
                              str(tmp_path_factory.mktemp("store")))
    sub = np.arange(0, N, 10)
    return base, queries, shard_of, store, base[sub], shard_of[sub]


def _engine(data, scan_mode, max_scan_rows=None):
    _, _, _, store, rp, rl = data
    return StreamedShardEngine(None, None, rp, rl, store=store,
                               scan_mode=scan_mode, voting_impl="approx",
                               max_scan_rows=max_scan_rows, device="cpu")


def _search(eng, queries, **kw):
    return eng.search(queries, K, NPROBES, voting_t=VOTING_T, **kw)


def _recorded(eng, queries, **kw):
    rec = Recorder()
    with recording(rec):
        out = _search(eng, queries, **kw)
    return out, rec.drain()


@pytest.mark.parametrize("scan_mode", ["binned", "exact"])
def test_a_pass_records_its_tree(data, scan_mode):
    eng = _engine(data, scan_mode)
    queries = data[1][:32]
    _, out = _recorded(eng, queries)
    probed = np.unique(eng.probe_order(queries, NPROBES, VOTING_T))
    probed = probed[probed < S]
    assert 0 < len(probed) <= S
    spans = out.spans
    root = spans[0]
    assert root.name == "stream.pass" and root.parent == -1
    assert {s.batch for s in spans} == {root.batch}
    kids = [s for s in spans if s.parent == root.id]
    assert len(kids) == len(spans) - 1
    names = [s.name for s in kids]
    want = (["stream.route"]
            + ["stream.gather", *STEPS] * len(probed) + ["stream.merge"])
    assert names == want
    for s in kids:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    # no card: no events
    assert all(s.stream_ms is None for s in spans)


@pytest.mark.parametrize("scan_mode, max_scan_rows", [
    ("binned", None), ("exact", None), ("binned", 2560)])
def test_counters_count_the_pass(data, scan_mode, max_scan_rows):
    eng = _engine(data, scan_mode, max_scan_rows)
    queries = data[1][:64]
    (_, _, stats), out = _recorded(eng, queries)
    probes = eng.probe_order(queries, NPROBES, VOTING_T)
    read = pair_rows = binned = exact = 0
    for b in range(S):
        mq = int((probes == b).sum())
        if not mq:
            continue
        rows, _, _ = eng.shard_block(b, queries[:mq])
        read += rows.nbytes
        size = len(rows)
        limit = max_scan_rows or size
        for lo in range(0, size, limit):
            block = min(limit, size - lo)
            if eng.takes_binned(block, K):
                binned += 1
                pair_rows += mq * block
            else:
                exact += 1
    c = out.counters
    assert c["stream.bytes_uploaded"] == stats["bytes_uploaded"]
    assert c["stream.bytes_read"] == read
    assert c.get("stream.blocks_binned", 0) == binned
    assert c.get("stream.blocks_exact", 0) == exact
    assert c.get("stream.b2_pair_rows", 0) == pair_rows
    assert binned + exact == stats["blocks_scanned"]
    assert (binned > 0) == (scan_mode == "binned")
    if max_scan_rows:
        assert stats["blocks_scanned"] > stats["shards_scanned"]
        names = [s.name for s in out.spans]
        assert names.count("stream.scan") == names.count("stream.upload") \
            == binned + exact


@pytest.mark.parametrize("source", ["store", "in-memory"])
def test_fill_parts_count_the_readers(data, source, monkeypatch):
    """``stream.fill_parts`` adds the readers of each block of a store
    (three here) and one for each block of an in-memory base, whose fill
    stays on the calling thread; ``stream.gather`` stays one span a
    block, around the whole fill."""
    from gpann_tpu_torch.core.partition import partition_to_clusters
    from gpann_tpu_torch.search import streamed

    monkeypatch.setattr(streamed, "_READERS", 3)
    if source == "store":
        eng = _engine(data, "binned", max_scan_rows=2560)
    else:
        base, _, shard_of, _, rp, rl = data
        eng = StreamedShardEngine(base, partition_to_clusters(shard_of, S),
                                  rp, rl, voting_impl="approx",
                                  max_scan_rows=2560, device="cpu")
    (_, _, stats), out = _recorded(eng, data[1][:64])
    c = out.counters
    readers = 3 if source == "store" else 1
    assert (eng._stage.pool is None) == (readers == 1)
    assert stats["blocks_scanned"] > stats["shards_scanned"]
    assert c["stream.fill_parts"] == readers * c["stream.blocks_staged"] \
        == readers * stats["blocks_scanned"]
    names = [s.name for s in out.spans]
    assert names.count("stream.gather") == stats["blocks_scanned"]


@pytest.mark.parametrize("scan_mode", ["binned", "exact"])
def test_off_and_on_give_identical_answers(data, scan_mode, monkeypatch):
    eng = _engine(data, scan_mode)
    queries = data[1][:64]
    (want_d, want_i, _), _ = _recorded(eng, queries)

    def boom(*a, **kw):
        raise AssertionError("the recorder was reached while off")
    for name in ("begin", "next", "end", "count"):
        monkeypatch.setattr(Recorder, name, boom)
    assert profiling.RECORDER is None
    d, i, _ = _search(eng, queries)
    monkeypatch.undo()
    np.testing.assert_array_equal(d, want_d)
    np.testing.assert_array_equal(i, want_i)


def test_given_probes_skip_routing_and_tables_skip_the_merge(data):
    eng = _engine(data, "binned")
    queries = data[1][:32]
    probes = eng.probe_order(queries, NPROBES, VOTING_T)
    _, out = _recorded(eng, queries, probes=probes)
    names = [s.name for s in out.spans]
    assert "stream.route" not in names and names[-1] == "stream.merge"
    _, out = _recorded(eng, queries, return_tables=True)
    names = [s.name for s in out.spans]
    assert names[:2] == ["stream.pass", "stream.route"]
    assert "stream.merge" not in names and names[-1] == "stream.scan"
    assert len({s.batch for s in out.spans}) == 1


@pytest.mark.parametrize("scan_mode", ["binned", "exact"])
def test_the_port_matches_the_plain_reference(data, scan_mode):
    base, queries, shard_of, _, rp, rl = data
    eng = _engine(data, scan_mode)
    d, i, _ = _search(eng, queries)
    cfg = {"k": K, "num_shards": S, "voting_t": VOTING_T,
           "nprobes": NPROBES}
    tr = Truth(torch.from_numpy(base), torch.from_numpy(shard_of),
               torch.from_numpy(rp), torch.from_numpy(rl))
    values = compare(cfg, tr, torch.from_numpy(queries),
                     torch.from_numpy(i), torch.from_numpy(d))
    values["invalid_lists"] = invalid_lists([i], N)
    for name, limit in LIMITS.items():
        assert values[name] <= limit, (name, values[name])
    assert values["recall_at_10"] > 0.8
