"""Parity of the port's ``cli.distributed_bench``, ``cli.experiments`` and
``cli.small_scale_experiments`` with the JAX package's.

``distributed_bench`` runs on ``tests/test_cli.py``'s data (1500 x 12 points
in 6 blobs, 20 queries, the JAX CLI's BalancedKMeans partition into 4
shards) in one rank in this process and in two CPU ranks started by
``python -m torch.distributed.run``; rank 0 prints its lines, and the
warm serve's first id equals the JAX CLI's. The experiment drivers run on
generated files named as their dataset registries expect
(``deep_base1B.fbin``, ``sift.fbin`` with ``--size``): the partition files
are equal byte for byte, the CSV and Pareto files too once both packages'
timers return one constant (the query-attribution CSV), or with the timing
columns masked (the small-scale CSV, columns 4-6).
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpann_tpu.cli import distributed_bench as jbench
from gpann_tpu.cli import experiments as jexp
from gpann_tpu.cli import partition as jpartition
from gpann_tpu.cli import small_scale_experiments as jsmall
from gpann_tpu.core import write_points
from gpann_tpu.route import sweep as jsweep
from gpann_tpu.search import shard_sweep as jss
from gpann_tpu_torch.cli import distributed_bench as tbench
from gpann_tpu_torch.cli import experiments as texp
from gpann_tpu_torch.cli import small_scale_experiments as tsmall
from gpann_tpu_torch.dist.launch import free_port
from gpann_tpu_torch.route import sweep as tsweep
from gpann_tpu_torch.search import shard_sweep as tss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSQ_TIMING_COLS = (4, 5, 6)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host, and torch's default of one thread per core
    oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def blobs(n, nq, seed=555):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((6, 12)).astype(np.float32) * 4
    lbl = rng.integers(0, 6, size=n)
    pts = (centers[lbl] + 0.4 * rng.standard_normal((n, 12))).astype(np.float32)
    q = (centers[rng.integers(0, 6, size=nq)]
         + 0.4 * rng.standard_normal((nq, 12))).astype(np.float32)
    return pts, q


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_cli")
    pts, q = blobs(1500, 20)
    write_points(str(tmp / "base.fbin"), pts)
    write_points(str(tmp / "queries.fbin"), q)
    assert jpartition.main([str(tmp / "base.fbin"), str(tmp / "part"), "4",
                            "BalancedKMeans"]) == 0
    return tmp


def bench_args(tmp):
    return [str(tmp / "base.fbin"), str(tmp / "queries.fbin"), "10",
            str(tmp / "part.k=4.BalancedKMeans"), "2"]


def printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().strip().split("\n")


def top1(lines):
    return [ln for ln in lines if "top1 id of q0" in ln][0].split("= ")[1]


def check_bench_lines(lines, ranks):
    assert lines[0].startswith(f"{ranks} ranks (cpu); 4 shards; mesh ")
    assert lines[1].startswith("index built in ")
    assert lines[3].startswith("fused nprobes=2: ") and "QPS/rank" in lines[3]
    assert lines[4].startswith("unfused nprobes=2: 20 queries in ")
    assert len(lines) == 5


@pytest.fixture(scope="module")
def jax_top1(data):
    return top1(printed(jbench.main, bench_args(data)))


def test_distributed_bench_one_rank(data, jax_top1):
    lines = printed(tbench.main, bench_args(data) + ["--device", "cpu"])
    check_bench_lines(lines, 1)
    assert "{'dp': 1, 'shard': 1}" in lines[0]
    assert top1(lines) == jax_top1


def test_distributed_bench_two_ranks(data, jax_top1):
    """Two ranks through the launcher: rank 0 alone prints, over gloo."""
    env = dict(os.environ, OMP_NUM_THREADS="2", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
         "-m", "gpann_tpu_torch.cli.distributed_bench"] + bench_args(data)
        + ["--distributed", "--device", "cpu", "--backend", "gloo"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().split("\n")
    check_bench_lines(lines, 2)
    assert "{'dp': 1, 'shard': 2}" in lines[0]
    assert top1(lines) == jax_top1


def test_distributed_bench_refuses_cuda_without_gpu(data):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tbench.main(bench_args(data))


@pytest.fixture(scope="module")
def experiment_runs(tmp_path_factory):
    """Both packages' drivers on generated registry files, each into its
    own output directory, with every timer of the sweeps returning 1 ms."""
    tmp = tmp_path_factory.mktemp("experiments")
    pts, q = blobs(2000, 20, seed=7)
    for name, arr in (("deep_base1B.fbin", pts), ("deep_query.fbin", q),
                      ("sift.fbin", pts), ("sift_query.fbin", q)):
        write_points(str(tmp / name), arr)

    def fixed(fn, *args, reps=5, warmup=1, device=None):
        return 0.001, fn(*args)

    mp = pytest.MonkeyPatch()
    for mod in (jsweep, jss, tsweep, tss):
        mp.setattr(mod, "time_fn", fixed)
    try:
        common = ["--methods", "BalancedKMeans", "--size", "1500"]
        for pkg, main, dev in (("j", jexp.main, []),
                               ("t", texp.main, ["--device", "cpu"])):
            assert main([str(tmp), str(tmp / f"{pkg}_exp"), "--datasets",
                         "deep", "--shards", "4"] + common + dev) == 0
        for pkg, main, dev in (("j", jsmall.main, []),
                               ("t", tsmall.main, ["--device", "cpu"])):
            assert main([str(tmp), str(tmp / f"{pkg}_small"), "--datasets",
                         "sift:l2", "--shards", "4"] + common + dev) == 0
    finally:
        mp.undo()
    return tmp


@pytest.mark.parametrize("name", [
    "deep.partition.k=4.BalancedKMeans", "deep.k=4.BalancedKMeans.csv",
    "deep.k=4.BalancedKMeans.pareto"])
def test_experiments_files_match(experiment_runs, name):
    got = (experiment_runs / "t_exp" / name).read_bytes()
    assert got == (experiment_runs / "j_exp" / name).read_bytes()
    assert len(got.decode().strip().split("\n")) > 1


def test_experiments_registry_copied():
    for name in ("METRICS", "FILE_ENDING", "QUERY_FILES", "DEFAULT_METHODS",
                 "NUM_NEIGHBORS", "OVERLAPPING"):
        assert getattr(texp, name) == getattr(jexp, name), name
    for method, overlap in (("GP", 0.0), ("OGP", 0.2), ("OKM", 0.0)):
        assert (texp.partition_file_name("/o", "deep", 8, method, overlap)
                == jexp.partition_file_name("/o", "deep", 8, method, overlap))


def test_small_scale_experiments_files_match(experiment_runs):
    def rows(pkg):
        with open(experiment_runs / f"{pkg}_small" /
                  "sift.k=4.BalancedKMeans.small.csv") as f:
            lines = f.read().strip().split("\n")
        out = [lines[0]]
        for line in lines[1:]:
            f = line.split(",")
            for c in SSQ_TIMING_COLS:
                f[c] = "*"
            out.append(",".join(f))
        return out

    name = "sift.partition.k=4.BalancedKMeans"
    assert ((experiment_runs / "t_small" / name).read_bytes()
            == (experiment_runs / "j_small" / name).read_bytes())
    assert rows("t") == rows("j") and len(rows("t")) > 1
