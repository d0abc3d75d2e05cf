"""Parity of the port's ``cli.scale_bench`` and of its three analysis CLIs
(``cli.graph_quality_benchmark``, ``cli.analyze_approximation_losses``,
``cli.extract_recall``) with the JAX package's.

Every CLI of each package runs on the same seeded inputs at toy sizes (the
sizes of ``tests/test_cli.py:133-189`` and ``tests/test_relayout.py``), the
port's with ``--device cpu``. Tolerances, per test: scale_bench CSV rows and
summaries equal apart from the seconds columns (and the streamed GB, which
the port counts unpadded) for the k-means partitioner on the rows layout;
curves within 0.016-0.022 on the shard-major layout with the exact scan and
0.03 with the binned scan (the port writes a chunk's rows in id order, so the
store's uniform sample, hence the router, is another; see
``SHARD_MAJOR_CURVE_ATOL``) and
within 0.02 for the graph partitioner (its label propagation is not
bit-identical between the packages); loss curves within 0.02; graph recall
within 0.05.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from gpann_tpu.cli import analyze_approximation_losses as jlosses
from gpann_tpu.cli import extract_recall as jextract
from gpann_tpu.cli import graph_quality_benchmark as jgq
from gpann_tpu.cli import scale_bench as jscale
from gpann_tpu.core import write_points
from gpann_tpu_torch.cli import analyze_approximation_losses as tlosses
from gpann_tpu_torch.cli import extract_recall as textract
from gpann_tpu_torch.cli import graph_quality_benchmark as tgq
from gpann_tpu_torch.cli import partition as tpartition
from gpann_tpu_torch.cli import scale_bench as tscale

SCALE_BASE = ["--n", "6000", "--d", "16", "--shards", "8", "--nq", "32",
              "--train-sample", "2000", "--scan-mode", "exact"]
# CSV: curve_pass_s, partition_s, gt_s, router_s; gb_streamed (the port
# counts the bytes really copied, the JAX CLI its padded blocks)
SCALE_SECONDS_COLS = (10, 12, 13, 14)
SCALE_GB_COL = 11
SCALE_HEADER = ("n,d,shards,kind,dtype,metric,method,nprobes,recall,"
                "balance,curve_pass_s,gb_streamed,partition_s,gt_s,"
                "router_s,sub_nprobe")
SUMMARY_KEYS = {"n", "shards", "kind", "dtype", "metric", "method",
                "balance", "nprobes_at_95", "recall_at_nprobes",
                "curve_pass_s", "gb_streamed", "sub_nprobe", "total_s"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host, and torch's default of one thread per core
    oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def run_scale(mod, cache, out, extra, device=()):
    """Run a scale_bench CLI until its CSV exists (a checkpointed partition
    stage returns early); returns (CSV rows, summary dict, calls)."""
    os.environ["GPANN_CACHE_DIR"] = str(cache)
    try:
        for calls in range(1, 20):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert mod.main(SCALE_BASE + extra + ["--out", str(out)]
                                + list(device)) == 0
            if os.path.exists(out):
                break
    finally:
        del os.environ["GPANN_CACHE_DIR"]
    lines = open(out).read().strip().split("\n")
    assert lines[0] == SCALE_HEADER
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(summary) == SUMMARY_KEYS
    return [line.split(",") for line in lines[1:]], summary, calls


def masked(rows, cols):
    return [[c for j, c in enumerate(r) if j not in cols] for r in rows]


SCALE_VARIANTS = {
    # rows layout, byte base, in-shard pruning from the cached artifact
    "rows-u8-subs": ["--dtype", "u8", "--sub-nprobe", "2", "--sub-size", "256"],
    # the choreography of the largest runs: regenerating byte base, fused
    # assign + relayout in 3-chunk invocations, pruning on the store
    "virtual-store-subs": ["--kind", "hard2", "--dtype", "u8", "--base",
                           "virtual", "--layout", "shard-major",
                           "--assign-chunks", "3", "--sub-nprobe", "2",
                           "--sub-size", "256"],
    # the same store, scanned by the bin-top-2 scan (two rows a bin)
    "virtual-store-subs-binned": ["--kind", "hard2", "--dtype", "u8", "--base",
                                  "virtual", "--layout", "shard-major",
                                  "--assign-chunks", "3", "--sub-nprobe", "2",
                                  "--sub-size", "256", "--scan-mode",
                                  "binned"],
    # a materialised base re-laid shard-major: store files byte-identical
    "store-exact": ["--layout", "shard-major"],
    "mips": ["--metric", "mips"],
    "max-nprobes": ["--kind", "blobs", "--max-nprobes", "3"],
}
# Recall-curve tolerances of the shard-major variants (recall comes in steps
# of 1/320 at 32 queries x k=10). The fused assign + relayout writes a
# chunk's rows in id order where the JAX CLI writes them in admission order
# (ROADMAP C7), and the router is trained on a sample of the store drawn by
# row position: the two CLIs train their routers on other points, so even
# the exact scan's curves differ. These are the smallest tolerances the
# exact variants meet (measured 0.015625 and 0.021875); the binned scan,
# which keeps two rows a 128-row bin, is held to 0.03.
SHARD_MAJOR_CURVE_ATOL = {"store-exact": 0.016, "virtual-store-subs": 0.022,
                          "virtual-store-subs-binned": 0.03}


@pytest.mark.parametrize("variant", sorted(SCALE_VARIANTS))
def test_scale_bench_matches_jax_cli(tmp_path, variant):
    extra = SCALE_VARIANTS[variant]
    jrows, jsum, jcalls = run_scale(jscale, tmp_path / "jc", tmp_path / "j.csv",
                                    extra)
    trows, tsum, tcalls = run_scale(tscale, tmp_path / "tc", tmp_path / "t.csv",
                                    extra, ["--device", "cpu"])
    skip = SCALE_SECONDS_COLS + (SCALE_GB_COL,)
    assert tcalls == jcalls
    for row in trows:
        assert float(row[SCALE_GB_COL]) >= 0
        for col in SCALE_SECONDS_COLS:
            assert np.isfinite(float(row[col]))
    if "shard-major" in extra:
        # same partition (balance), another row order inside the shards:
        # the router is trained on another sample of the same points
        skip += (8,)
        np.testing.assert_allclose([float(r[8]) for r in trows],
                                   [float(r[8]) for r in jrows],
                                   rtol=0, atol=SHARD_MAJOR_CURVE_ATOL[variant])
        assert tsum["balance"] == jsum["balance"]
    else:
        for key in SUMMARY_KEYS - {"curve_pass_s", "total_s", "gb_streamed"}:
            assert tsum[key] == jsum[key], key
    assert masked(trows, skip) == masked(jrows, skip)
    assert float(trows[0][9]) <= 1.05 + 1e-9
    assert float(trows[-1][8]) > 0.9


def test_scale_bench_reuses_the_jax_cli_caches(tmp_path):
    """One cache directory serves both CLIs: the port finds the JAX CLI's
    store, ground truth (with its queries), router and sub-cluster sidecar,
    rebuilds nothing and reports the stages' original seconds."""
    extra = SCALE_VARIANTS["virtual-store-subs"]
    jrows, _, _ = run_scale(jscale, tmp_path / "c", tmp_path / "j.csv", extra)
    before = {name: os.path.getmtime(tmp_path / "c" / name)
              for name in os.listdir(tmp_path / "c")}
    trows, _, calls = run_scale(tscale, tmp_path / "c", tmp_path / "t.csv",
                                extra, ["--device", "cpu"])
    assert calls == 1
    assert before == {name: os.path.getmtime(tmp_path / "c" / name)
                      for name in os.listdir(tmp_path / "c")}
    skip = (10, SCALE_GB_COL)  # this pass's seconds and GB
    assert masked(trows, skip) == masked(jrows, skip)
    # and without pruning on the same caches: the exact curve ends at 1.0
    full, _, _ = run_scale(tscale, tmp_path / "c", tmp_path / "f.csv",
                           extra[:-4], ["--device", "cpu"])
    assert float(full[-1][8]) == 1.0
    assert [r[12:15] for r in full] == [r[12:15] for r in jrows]


def test_scale_bench_gp_method_close_to_jax_cli(tmp_path):
    extra = ["--dtype", "u8", "--method", "gp", "--gp-subsample", "2000",
             "--gp-aggregates", "64"]
    jrows, jsum, _ = run_scale(jscale, tmp_path / "jc", tmp_path / "j.csv",
                               extra)
    trows, tsum, _ = run_scale(tscale, tmp_path / "tc", tmp_path / "t.csv",
                               extra, ["--device", "cpu"])
    np.testing.assert_allclose([float(r[8]) for r in trows],
                               [float(r[8]) for r in jrows], atol=0.02)
    assert tsum["balance"] <= 1.05 and tsum["method"] == "gp"
    assert os.path.exists(tmp_path / "tc" / "scale_hard_555_6000_16_8_u8_gp_aggs.npz")


# The GP pipeline in the layout of the large runs (README.md:384-458): a
# regenerated byte base, the fused assign + relayout in 3-chunk invocations,
# whole shards and pruned small batches. The kNN graphs, LP partitions and
# balances of the two packages are equal on byte data (ROADMAP C12); the
# curves still differ a little because the router is trained on a sample of
# the store drawn by row position, and the two stores order a chunk's rows
# differently (C7, C10): 1 of the 320 neighbours, 0.003125, at 3 probes.
# At this size every shard is under the binned scan's guard of 4k
# candidates, so both CLIs take the exact scan; the port's binned scan of a
# GP store is held against its exact scan by the store test below (and on
# the card by tests/test_torch_gpu_streamed.py).
GP_ARGS = ["--dtype", "u8", "--method", "gp", "--gp-subsample", "2000",
           "--gp-aggregates", "64"]
GP_STORE = ["--kind", "hard2", "--base", "virtual", "--layout", "shard-major",
            "--assign-chunks", "3"]
GP_SUBS = ["--sub-nprobe", "2", "--sub-size", "256", "--max-nprobes", "3"]


@pytest.mark.parametrize("subs", [False, True], ids=["whole", "subs"])
def test_scale_bench_gp_shard_major_close_to_jax_cli(tmp_path, subs):
    extra = GP_ARGS + GP_STORE + (GP_SUBS if subs else [])
    jrows, jsum, jcalls = run_scale(jscale, tmp_path / "jc", tmp_path / "j.csv",
                                    extra)
    trows, tsum, tcalls = run_scale(tscale, tmp_path / "tc", tmp_path / "t.csv",
                                    extra, ["--device", "cpu"])
    assert tcalls == jcalls
    assert len(trows) == len(jrows) == (3 if subs else 8)
    np.testing.assert_allclose([float(r[8]) for r in trows],
                               [float(r[8]) for r in jrows], atol=0.01)
    assert tsum["balance"] == jsum["balance"] <= 1.05
    assert tsum["method"] == "gp" and tsum["sub_nprobe"] == (2 if subs else 0)
    assert (tmp_path / "tc" / "scale_hard2_555_6000_16_8_u8_gp_store"
            / "meta.json").exists()
    if not subs:
        assert float(trows[-1][8]) == 1.0


def test_scale_bench_gp_store_ids_and_binned_recall(tmp_path):
    """The port's GP store at 200k x 32 u8, 8 shards of ~25k rows (over the
    binned guard): every id of ``range(n)`` once, no shard above the
    capacity of ``capacity_assign_to_store``, and the binned scan's curve
    within 0.002 of the exact scan's on the same store, router and queries
    (the check of chip_smoke.py's path 9 at 16M on the card)."""
    from gpann_tpu_torch.search.relayout import ShardMajorStore

    n, shards = 200_000, 8
    extra = GP_STORE + ["--dtype", "u8", "--method", "gp", "--gp-subsample",
                        "20000", "--gp-aggregates", "512", "--n", str(n),
                        "--d", "32", "--nq", "256", "--train-sample", "20000"]
    curves = {}
    for mode in ("binned", "exact"):
        rows, summary, _ = run_scale(tscale, tmp_path / "c",
                                     tmp_path / f"{mode}.csv",
                                     extra + ["--scan-mode", mode],
                                     ["--device", "cpu"])
        assert summary["balance"] <= 1.05
        curves[mode] = np.asarray([float(r[8]) for r in rows])
    store = ShardMajorStore(str(tmp_path / "c" /
                                f"scale_hard2_555_{n}_32_{shards}_u8_gp_store"))
    assert store.sizes.max() <= int(1.05 * np.ceil(n / shards))
    assert store.sizes.min() > 4 * 10 * 128 // 2  # binned, not the guard
    ids = np.concatenate([store.shard_ids(b) for b in range(shards)])
    np.testing.assert_array_equal(np.sort(ids), np.arange(n))
    np.testing.assert_allclose(curves["binned"], curves["exact"], rtol=0,
                               atol=0.002)
    assert curves["binned"][-1] >= 0.999


@pytest.mark.parametrize("flag", ["--isolate-stages", "--shard-chunk=4",
                                  "--curve-partial=0:4:x.npz",
                                  "--until=partition"])
def test_scale_bench_has_no_child_process_flags(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        tscale.main(SCALE_BASE + [flag, "--device", "cpu"])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_scale_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("has a CUDA GPU")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tscale.main(SCALE_BASE)


# -- the three analysis CLIs ---------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``tests/test_cli.py``'s data (1500 x 12 points in 6 blobs, 20
    queries), under the names ``extract_recall`` expects, with the port
    CLI's BalancedKMeans partition."""
    tmp = tmp_path_factory.mktemp("analysis")
    rng = np.random.default_rng(555)
    centers = rng.standard_normal((6, 12)).astype(np.float32) * 5
    pts = (centers[rng.integers(0, 6, 1500)]
           + 0.5 * rng.standard_normal((1500, 12))).astype(np.float32)
    q = (centers[rng.integers(0, 6, 20)]
         + 0.5 * rng.standard_normal((20, 12))).astype(np.float32)
    write_points(str(tmp / "deep_base1B.fbin"), pts)
    write_points(str(tmp / "deep_query.fbin"), q)
    assert tpartition.main([str(tmp / "deep_base1B.fbin"),
                            str(tmp / "deep.partition"), "4", "BalancedKMeans",
                            "--device", "cpu"]) == 0
    return tmp


def loss_curves(path):
    lines = open(path).read().strip().split("\n")
    assert lines[0] == "partitioning,num probes,recall,type"
    curves = {}
    for line in lines[1:]:
        method, probe, recall, kind = line.split(",")
        assert method == "BalancedKMeans"
        curves.setdefault(kind, []).append((int(probe), float(recall)))
    return {k: [r for _, r in sorted(v)] for k, v in curves.items()}


def test_analyze_approximation_losses_matches_jax_cli(data):
    argv = [str(data / "deep_base1B.fbin"), str(data / "deep_query.fbin"),
            str(data / "deep_ground-truth.bin"), "10",
            str(data / "deep.partition.k=4.BalancedKMeans"), "BalancedKMeans"]
    assert jlosses.main(argv + [str(data / "j_losses.csv")]) == 0
    assert tlosses.main(argv + [str(data / "t_losses.csv"),
                                "--device", "cpu"]) == 0
    want, got = (loss_curves(data / f"{p}_losses.csv") for p in "jt")
    assert set(got) == {"brute-force-routing", "kmeans-tree-sample",
                        "uniform-sample", "single-center"} == set(want)
    for kind, curve in got.items():
        assert len(curve) == 4 and curve == sorted(curve), kind
        assert curve[-1] == 1.0
        np.testing.assert_allclose(curve, want[kind], atol=0.02)
    assert tlosses.main(argv) == 2  # usage


def test_extract_recall_matches_jax_cli(data, tmp_path):
    argv = [str(data), "--methods", "BalancedKMeans", "--shards", "4",
            "--mode", "losses"]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert jextract.main([argv[0], str(tmp_path / "j")] + argv[1:]) == 0
    assert textract.main([argv[0], str(tmp_path / "t")] + argv[1:]
                         + ["--device", "cpu"]) == 0
    name = "deep.BalancedKMeans.k=4.single-center-routes.csv"
    assert os.listdir(tmp_path / "t") == [name] == os.listdir(tmp_path / "j")
    want, got = (loss_curves(tmp_path / p / name) for p in "jt")
    for kind, curve in got.items():
        np.testing.assert_allclose(curve, want[kind], atol=0.02)


def test_extract_recall_oracle_mode(data, tmp_path):
    """``--mode oracle`` re-analyses saved routes on the host."""
    from gpann_tpu_torch.cli import query_attribution as tqa

    part = str(data / "deep.partition.k=4.BalancedKMeans")
    out = tmp_path / "deep.k=4.BalancedKMeans"
    assert tqa.main([str(data / "deep_base1B.fbin"),
                     str(data / "deep_query.fbin"),
                     str(data / "deep_ground-truth.bin"), "10", part, "4",
                     str(out), "BalancedKMeans", "--device", "cpu"]) == 0
    assert textract.main([str(data), str(tmp_path), "--methods",
                          "BalancedKMeans", "--shards", "4", "--mode",
                          "oracle", "--device", "cpu"]) == 0
    lines = open(tmp_path / "deep.BalancedKMeans.k=4.oracle_recall"
                 ).read().strip().split("\n")
    oracle = [float(l.split(",")[2]) for l in lines[1:]
              if l.endswith(",oracle")]
    assert len(oracle) == 4 and oracle == sorted(oracle) and oracle[-1] == 1.0


def test_graph_quality_benchmark_matches_jax_cli(data, monkeypatch):
    """A two-configuration grid (the module constants are the grid): same
    rows, graph recall and first-shard oracle recall within 0.05 of the
    JAX CLI's (different sketches of the same construction), and a finished CSV
    is resumed, not recomputed."""
    for mod in (jgq, tgq):
        monkeypatch.setattr(mod, "REPS_GRID", (2, 3))
        monkeypatch.setattr(mod, "FANOUT_GRID", (3,))
        monkeypatch.setattr(mod, "CLUSTER_SIZE_GRID", (500,))
    argv = [str(data / "deep_base1B.fbin"), str(data / "deep_query.fbin"),
            "10", "4"]
    assert jgq.main(argv + [str(data / "j_gq.csv"), "1000"]) == 0
    assert tgq.main(argv + [str(data / "t_gq.csv"), "1000",
                            "--device", "cpu"]) == 0
    rows = {}
    for p in "jt":
        lines = open(data / f"{p}_gq.csv").read().strip().split("\n")
        assert lines[0] == ("reps,fanout,max_cluster_size,degree,graph_recall,"
                            "first_shard_oracle_recall")
        rows[p] = [line.split(",") for line in lines[1:]]
    assert [r[:4] for r in rows["t"]] == [r[:4] for r in rows["j"]] == [
        ["2", "3", "500", "10"], ["3", "3", "500", "10"]]
    got = np.asarray([[float(x) for x in r[4:]] for r in rows["t"]])
    want = np.asarray([[float(x) for x in r[4:]] for r in rows["j"]])
    assert ((0 <= got) & (got <= 1)).all()
    np.testing.assert_allclose(got, want, atol=0.05)
    stamp = os.path.getmtime(data / "t_gq.csv")
    monkeypatch.setattr(tgq, "ApproximateKNNGraphBuilder", None)  # not called
    assert tgq.main(argv + [str(data / "t_gq.csv"), "1000",
                            "--device", "cpu"]) == 0
    lines = open(data / "t_gq.csv").read().strip().split("\n")
    assert [line.split(",") for line in lines[1:]] == rows["t"]
    assert os.path.getmtime(data / "t_gq.csv") >= stamp
