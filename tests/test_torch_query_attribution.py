"""Parity of the port's query-attribution slice with the JAX package:
``eval/combination.py`` and the four CLIs ``query_attribution``,
``small_scale_queries``, ``oracle_recall`` and ``convert``.

The data is ``tests/test_cli.py``'s (1500 x 12 points in 6 blobs, 20
queries, seed 555), clustered two ways: the JAX CLI's BalancedKMeans
partition and the port CLI's OKM cover (overlap 0.2). Each CLI of each
package runs on the same files, the port's with ``--device cpu``:

- CSV rows are equal with the timing columns masked (query attribution:
  routing time and the four QPS columns, 6 and 9-12; small scale: the three
  latencies, 4-6); with both packages' timers replaced by one constant, all
  four output files are equal byte for byte;
- ``.routes`` files are equal apart from the routing-time field, the
  ``.searches`` hit lines are equal, the oracle CSV and the convert output
  are equal byte for byte;
- the combination functions give equal rows on shared inputs, and each
  package reads the other's ``.routes`` / ``.searches`` files and writes
  them back unchanged.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpann_tpu.cli import convert as jconvert
from gpann_tpu.cli import oracle_recall as joracle
from gpann_tpu.cli import partition as jpartition
from gpann_tpu.cli import query_attribution as jqa
from gpann_tpu.cli import small_scale_queries as jssq
from gpann_tpu.core import write_points
from gpann_tpu.eval import combination as jc
from gpann_tpu.route import sweep as jsweep
from gpann_tpu.search import shard_sweep as jss
from gpann_tpu_torch.cli import convert as tconvert
from gpann_tpu_torch.cli import oracle_recall as toracle
from gpann_tpu_torch.cli import partition as tpartition
from gpann_tpu_torch.cli import query_attribution as tqa
from gpann_tpu_torch.cli import small_scale_queries as tssq
from gpann_tpu_torch.core.metis_io import read_clusters
from gpann_tpu_torch.core.partition import (clusters_to_cover,
                                            clusters_to_cover_csr,
                                            cover_to_csr)
from gpann_tpu_torch.eval import combination as tc
from gpann_tpu_torch.route import sweep as tsweep
from gpann_tpu_torch.search import shard_sweep as tss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QA_TIMING_COLS = (6, 9, 10, 11, 12)
SSQ_TIMING_COLS = (4, 5, 6)
PARTS = ("part.k=4.BalancedKMeans", "part.k=4.OKM.o=0.2")
NEW_MODULES = (
    "gpann_tpu_torch.core.timer", "gpann_tpu_torch.core.profiling",
    "gpann_tpu_torch.eval.combination", "gpann_tpu_torch.search.ivf",
    "gpann_tpu_torch.search.two_level", "gpann_tpu_torch.search.shard_sweep",
    "gpann_tpu_torch.route.sweep", "gpann_tpu_torch.gp.overlap",
    "gpann_tpu_torch.cli.small_scale_queries",
    "gpann_tpu_torch.cli.query_attribution",
    "gpann_tpu_torch.cli.oracle_recall", "gpann_tpu_torch.cli.convert",
    # the bench and the streamed path
    "gpann_tpu_torch.native", "gpann_tpu_torch.eval.synth",
    "gpann_tpu_torch.search.relayout", "gpann_tpu_torch.search.streamed",
    "gpann_tpu_torch.cli.scale_bench", "gpann_tpu_torch.cli.bench",
    "gpann_tpu_torch.cli.graph_quality_benchmark",
    "gpann_tpu_torch.cli.analyze_approximation_losses",
    "gpann_tpu_torch.cli.extract_recall",
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host, and torch's default of one thread per core
    oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qa")
    rng = np.random.default_rng(555)
    centers = rng.standard_normal((6, 12)).astype(np.float32) * 4
    lbl = rng.integers(0, 6, size=1500)
    pts = (centers[lbl] + 0.4 * rng.standard_normal((1500, 12))).astype(np.float32)
    q = (centers[rng.integers(0, 6, size=20)]
         + 0.4 * rng.standard_normal((20, 12))).astype(np.float32)
    write_points(str(tmp / "base.fbin"), pts)
    write_points(str(tmp / "queries.fbin"), q)
    base = str(tmp / "base.fbin")
    assert jpartition.main([base, str(tmp / "part"), "4", "BalancedKMeans"]) == 0
    assert tpartition.main([base, str(tmp / "part"), "4", "OKM",
                            "--device", "cpu"]) == 0
    return tmp


def qa_args(tmp, part, gt, out):
    return [str(tmp / "base.fbin"), str(tmp / "queries.fbin"), str(tmp / gt),
            "10", str(tmp / part), "4", str(tmp / out), part.split(".")[2]]


@pytest.fixture(scope="module")
def qa_runs(data):
    """Both packages' query attribution on both clusterings; each computes
    and writes its own ground truth."""
    for i, part in enumerate(PARTS):
        assert jqa.main(qa_args(data, part, f"gt_j{i}.bin", f"j{i}")) == 0
        assert tqa.main(qa_args(data, part, f"gt_t{i}.bin", f"t{i}")
                        + ["--device", "cpu"]) == 0
    return data


def lines(path):
    with open(path) as f:
        return f.read().strip().split("\n")


def masked(path, cols):
    out = []
    for line in lines(path)[1:]:
        f = line.split(",")
        for c in cols:
            f[c] = "*"
        out.append(",".join(f))
    return out


@pytest.mark.parametrize("i", [0, 1], ids=["disjoint", "overlapping"])
def test_qa_csv_matches_with_timing_masked(qa_runs, i):
    want = masked(qa_runs / f"j{i}.csv", QA_TIMING_COLS)
    got = masked(qa_runs / f"t{i}.csv", QA_TIMING_COLS)
    assert lines(qa_runs / f"t{i}.csv")[0] == tc.CSV_HEADER
    assert len(got[0].split(",")) == 19
    assert got == want
    assert max(float(r.split(",")[8]) for r in got) == 1.0


@pytest.mark.parametrize("i", [0, 1], ids=["disjoint", "overlapping"])
def test_qa_routes_match_apart_from_routing_time(qa_runs, i):
    want, got = lines(qa_runs / f"j{i}.routes"), lines(qa_runs / f"t{i}.routes")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.split(" "), w.split(" ")
        if len(w) == 9:  # config header: field 4 is the routing time
            g[4] = w[4] = "*"
        assert g == w


@pytest.mark.parametrize("i", [0, 1], ids=["disjoint", "overlapping"])
def test_qa_searches_hit_lines_match(qa_runs, i):
    want = lines(qa_runs / f"j{i}.searches")
    got = lines(qa_runs / f"t{i}.searches")
    assert len(got) == len(want)
    searches = tc.deserialize_searches(str(qa_runs / f"t{i}.searches"))
    pos = 1
    for s in searches:
        num_shards, nq = s.time_query_in_shard.shape
        assert got[pos] == want[pos]  # "ef num_shards nq"
        hit_lines = slice(pos + 1 + num_shards, pos + 1 + num_shards + num_shards * nq)
        assert got[hit_lines] == want[hit_lines]
        pos += 1 + num_shards + num_shards * nq
    assert pos == len(got)


def test_qa_ground_truth_matches(qa_runs):
    from gpann_tpu_torch.core.pointset import read_ground_truth

    for i in (0, 1):
        wi, wd = read_ground_truth(str(qa_runs / f"gt_j{i}.bin"))
        gi, gd = read_ground_truth(str(qa_runs / f"gt_t{i}.bin"))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)


def test_qa_with_fixed_timers_writes_identical_files(data, monkeypatch):
    """With every timer of both packages returning 1 ms, the QA CLIs write
    identical .csv, .pareto, .routes and .searches files."""
    def fixed(fn, *args, reps=5, warmup=1, device=None):
        return 0.001, fn(*args)

    for mod in (jsweep, jss, tsweep, tss):
        monkeypatch.setattr(mod, "time_fn", fixed)
    part = PARTS[1]
    assert jqa.main(qa_args(data, part, "gt_j1.bin", "jf")) == 0
    assert tqa.main(qa_args(data, part, "gt_j1.bin", "tf")
                    + ["--device=cpu"]) == 0
    for ext in ("csv", "pareto", "routes", "searches"):
        assert ((data / f"tf.{ext}").read_bytes()
                == (data / f"jf.{ext}").read_bytes()), ext


def num_shards(tmp, i):
    return len(read_clusters(str(tmp / PARTS[i])))


@pytest.mark.parametrize("i", [0, 1], ids=["disjoint", "overlapping"])
def test_convert_cli_matches(qa_runs, i):
    args = [str(qa_runs / f"j{i}.routes"), str(qa_runs / f"j{i}.searches"),
            str(num_shards(qa_runs, i)), "4", "10"]
    assert jconvert.main(args + [str(qa_runs / f"jc{i}"), "X"]) == 0
    assert tconvert.main(args + [str(qa_runs / f"tc{i}"), "X"]) == 0
    for ext in ("csv", "pareto"):
        assert ((qa_runs / f"tc{i}.{ext}").read_bytes()
                == (qa_runs / f"jc{i}.{ext}").read_bytes())


@pytest.mark.parametrize("i", [0, 1], ids=["disjoint", "overlapping"])
def test_oracle_recall_cli_matches(qa_runs, i):
    args = [str(qa_runs / f"gt_j{i}.bin"), str(qa_runs / f"j{i}.routes"), "10",
            str(qa_runs / PARTS[i]), "M"]
    assert joracle.main(args + [str(qa_runs / f"jo{i}.csv")]) == 0
    assert toracle.main(args + [str(qa_runs / f"to{i}.csv")]) == 0
    got = (qa_runs / f"to{i}.csv").read_bytes()
    assert got == (qa_runs / f"jo{i}.csv").read_bytes()
    oracle = [r for r in got.decode().split("\n") if r.endswith(",oracle")]
    assert len(oracle) == num_shards(qa_runs, i) and float(oracle[-1].split(",")[2]) == 1.0


def test_oracle_cover_csr_and_curve(qa_runs):
    """The CLI's CSR cover equals ``cover_to_csr(clusters_to_cover(...))``
    and gives the JAX function's curves, which it takes as the per-point
    cover list."""
    clusters = read_clusters(str(qa_runs / PARTS[1]))
    s = len(clusters)
    cover = clusters_to_cover(clusters, n=1500)
    indptr, indices = clusters_to_cover_csr(clusters, 1500)
    wp, wi = cover_to_csr(cover)
    np.testing.assert_array_equal(indptr, wp)
    np.testing.assert_array_equal(indices, wi)
    gt = np.random.default_rng(5).integers(0, 1500, (20, 10))
    orders = [np.random.default_rng(q).permutation(s) for q in range(20)]
    want = joracle.recall_for_increasing_probes(orders, cover, gt, 10, s)
    assert toracle.recall_for_increasing_probes(
        orders, (indptr, indices), gt, 10, s) == want


@pytest.mark.parametrize("part", [PARTS[0], "missing.clusters"],
                         ids=["partitioned", "brute-force"])
def test_small_scale_queries_cli_matches(qa_runs, part):
    args = [str(qa_runs / "base.fbin"), str(qa_runs / "queries.fbin"),
            str(qa_runs / "gt_j0.bin"), "10", str(qa_runs / part)]
    assert jssq.main(args + [str(qa_runs / "js.csv"), "BalancedKMeans"]) == 0
    assert tssq.main(args + [str(qa_runs / "ts.csv"), "BalancedKMeans",
                             "--device", "cpu"]) == 0
    assert lines(qa_runs / "ts.csv")[0] == lines(qa_runs / "js.csv")[0]
    got = masked(qa_runs / "ts.csv", SSQ_TIMING_COLS)
    assert got == masked(qa_runs / "js.csv", SSQ_TIMING_COLS)
    assert len(got) == (1 if part.startswith("missing") else 2 * 2 * 4)
    # the largest probe count reaches recall 1.0
    assert all(float(r.split(",")[-1]) == 1.0 for r in got
               if r.split(",")[3] in ("1" if len(got) == 1 else "4"))


def test_cli_refuses_cuda_without_gpu(qa_runs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tqa.main(qa_args(qa_runs, PARTS[0], "gt_j0.bin", "never"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tssq.main([str(qa_runs / "base.fbin"), str(qa_runs / "queries.fbin"),
                   str(qa_runs / "gt_j0.bin"), "10", str(qa_runs / PARTS[0]),
                   str(qa_runs / "never.csv")])


@pytest.mark.parametrize("i", [0, 1], ids=["disjoint", "overlapping"])
def test_combination_rows_and_pareto_match(qa_runs, i):
    def rows(pkg):
        routes = pkg.deserialize_routes(str(qa_runs / f"j{i}.routes"))
        searches = pkg.deserialize_searches(str(qa_runs / f"j{i}.searches"))
        out = pkg.combine_routes_and_searches(
            routes, searches, 20, num_shards(qa_runs, i), 4, 10,
            partition_method="M",
            min_cluster_size=7, num_centroids=3, shard_query_name="Scan")
        return out, pkg.pareto_filter(out)

    (gr, gp), (wr, wp) = rows(tc), rows(jc)
    assert gr == wr and gp == wp and len(gp) >= 1


def test_attribution_and_replica_model_match():
    route = tc.RoutingConfig(buckets_to_probe=np.array([[0, 1], [1, -1]],
                                                       np.int32))
    hits = [[np.array([7]), np.array([3])], [np.array([7, 8]), np.array([])]]
    times = np.array([[0.5, 0.1], [0.25, 0.2]])
    for unique in (None, True, False):
        got = tc.attribute_recall_and_query_time(
            route, tc.ShardSearch(1, times, hits), 2, 2, 2, 2, unique)
        want = jc.attribute_recall_and_query_time(
            jc.RoutingConfig(buckets_to_probe=route.buckets_to_probe),
            jc.ShardSearch(1, times, hits), 2, 2, 2, 2, unique)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    work = np.array([10.0, 1.0, 3.0])
    assert (tc.replica_cost_model(work, 0.5, 100, 3, 4)
            == jc.replica_cost_model(work, 0.5, 100, 3, 4))


@pytest.mark.parametrize("kind", ["routes", "searches"])
def test_files_cross_package_round_trip(qa_runs, tmp_path, kind):
    """Each package reads the other's file and writes it back unchanged."""
    src = {"routes": qa_runs / "j1.routes", "searches": qa_runs / "t1.searches"}[kind]
    ser = f"serialize_{kind}"
    des = f"deserialize_{kind}"
    getattr(tc, ser)(getattr(tc, des)(str(src)), str(tmp_path / "a"))
    getattr(jc, ser)(getattr(jc, des)(str(tmp_path / "a")), str(tmp_path / "b"))
    assert (tmp_path / "a").read_bytes() == src.read_bytes()
    assert (tmp_path / "b").read_bytes() == src.read_bytes()


def test_new_modules_import_with_jax_blocked():
    """Every module of this slice imports with ``jax`` and ``gpann_tpu``
    unimportable (a None entry in sys.modules makes an import raise)."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'gpann_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {NEW_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and\n"
        "       (m.split('.')[0] in ('jax', 'jaxlib', 'gpann_tpu'))]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
