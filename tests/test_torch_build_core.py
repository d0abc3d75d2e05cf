"""Parity of the port's build-path core (distances, point and METIS files,
ground truth, oracle recall) with the JAX package.

Inputs are drawn with numpy and handed to both packages; the JAX side runs on
the CPU, the port on CPU tensors. Distances are compared at rtol = atol =
1e-4 (f32 sums in another order), ids through their exact distances, files
byte for byte, recall values exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpann_tpu.core import distances as jd
from gpann_tpu.core import metis_io as jm
from gpann_tpu.core import pointset as jp
from gpann_tpu.core.partition import clusters_to_cover
from gpann_tpu.eval import recall as jr
from gpann_tpu_torch.core import distances as td
from gpann_tpu_torch.core import metis_io as tm
from gpann_tpu_torch.core import pointset as tp
from gpann_tpu_torch.eval import recall as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host, and torch's default of one thread per core
    oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
MODULES = (
    "gpann_tpu_torch", "gpann_tpu_torch.core", "gpann_tpu_torch.core.pointset",
    "gpann_tpu_torch.core.metis_io", "gpann_tpu_torch.eval",
    "gpann_tpu_torch.cluster", "gpann_tpu_torch.cluster.kmeans",
    "gpann_tpu_torch.cluster.streaming", "gpann_tpu_torch.native",
    "gpann_tpu_torch.graph", "gpann_tpu_torch.graph.knn", "gpann_tpu_torch.gp",
    "gpann_tpu_torch.gp.lp", "gpann_tpu_torch.gp.partitioning",
    "gpann_tpu_torch.gp.scale", "gpann_tpu_torch.gp.api",
    "gpann_tpu_torch.route", "gpann_tpu_torch.route.flat",
    "gpann_tpu_torch.route.kmeans_tree", "gpann_tpu_torch.cli.partition",
    "gpann_tpu_torch.search.serve", "gpann_tpu_torch.kernels",
)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(555)
    base = rng.standard_normal((4000, 24)).astype(np.float32)
    qs = rng.standard_normal((96, 24)).astype(np.float32)
    return qs, base


def exact_dists(qs, base, ids, metric):
    if metric == "l2":
        return ((qs[:, None] - base[ids]) ** 2).sum(-1)
    return 1.0 - np.einsum("qd,qkd->qk", qs, base[ids])


def test_new_modules_import_with_jax_blocked():
    """Every module of the port imports with ``jax`` and ``gpann_tpu``
    unimportable (a None entry in sys.modules makes an import raise)."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'gpann_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and\n"
        "       (m.split('.')[0] in ('jax', 'jaxlib', 'gpann_tpu'))]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_assign_closest_matches(data, metric):
    qs, base = data
    wd, wi = jd.assign_closest(jnp.asarray(base), jnp.asarray(qs), metric)
    gd, gi = td.assign_closest(torch.from_numpy(base), torch.from_numpy(qs),
                               metric)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)
    # the chosen centers are equally close
    gi = gi.numpy()
    np.testing.assert_allclose(exact_dists(base, qs, gi[:, None], metric)[:, 0],
                               np.asarray(wd), **TOL)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_chunked_topk_neighbors_matches(data, metric):
    qs, base = data
    wd, wi = jd.chunked_topk_neighbors(qs, base, 8, metric, query_block=40,
                                       block_rows=1000)
    gd, gi = td.chunked_topk_neighbors(qs, base, 8, metric, query_block=40,
                                       block_rows=1000, device="cpu")
    assert gi.dtype == np.int32 and gd.shape == (96, 8)
    np.testing.assert_allclose(gd, wd, **TOL)
    np.testing.assert_allclose(exact_dists(qs, base, gi, metric), wd, **TOL)


def test_streaming_topk_neighbors_matches(data):
    qs, base = data
    wd, wi = jd.streaming_topk_neighbors(qs, base, 8, base_chunk=1500,
                                         query_block=50)
    gd, gi = td.streaming_topk_neighbors(qs, base, 8, base_chunk=1500,
                                         query_block=50, device="cpu")
    assert gi.dtype == wi.dtype == np.int64
    np.testing.assert_allclose(gd, wd, **TOL)
    np.testing.assert_allclose(exact_dists(qs, base, gi, "l2"), wd, **TOL)


def test_l2_normalize_and_offset(data):
    _, base = data
    got = td.l2_normalize(torch.from_numpy(base)).numpy()
    np.testing.assert_allclose(got, np.asarray(jd.l2_normalize(jnp.asarray(base))),
                               **TOL)
    for metric in ("l2", "mips"):
        assert td.pos_distance_offset(metric) == jd.pos_distance_offset(metric)


@pytest.mark.parametrize("suffix", [".fbin", ".u8bin", ".i8bin"])
def test_point_files_byte_identical(tmp_path, suffix):
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((300, 12)).astype(np.float32)
    if suffix != ".fbin":
        pts = rng.integers(0 if suffix == ".u8bin" else -100, 100,
                           (300, 12)).astype(np.float32)
    a, b = tmp_path / f"j{suffix}", tmp_path / f"t{suffix}"
    jp.write_points(str(a), pts)
    tp.write_points(str(b), pts)
    assert a.read_bytes() == b.read_bytes()
    assert tp.read_header(str(a)) == jp.read_header(str(b)) == (300, 12)
    np.testing.assert_array_equal(tp.read_points(str(a), size=50),
                                  jp.read_points(str(b), size=50))


def test_ground_truth_file_byte_identical(tmp_path):
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1000, (40, 10)).astype(np.int32)
    dists = rng.random((40, 10)).astype(np.float32)
    a, b = tmp_path / "j.gt", tmp_path / "t.gt"
    jp.write_ground_truth(str(a), ids, dists)
    tp.write_ground_truth(str(b), ids, dists)
    assert a.read_bytes() == b.read_bytes()
    for got, want in zip(tp.read_ground_truth(str(a)), jp.read_ground_truth(str(b))):
        np.testing.assert_array_equal(got, want)


def test_metis_files_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    part = rng.integers(0, 5, 200).astype(np.int32)
    clusters = [np.nonzero(part == p)[0].astype(np.int32) for p in range(5)]
    clusters.append(np.empty(0, np.int32))
    adjacency = [np.array([1, 2]), np.array([0]), np.array([0])]
    writers = (("partition", "write_metis_partition", part),
               ("clusters", "write_clusters", clusters),
               ("graph", "write_metis_graph", adjacency))
    for name, fn, obj in writers:
        a, b = tmp_path / f"j.{name}", tmp_path / f"t.{name}"
        getattr(jm, fn)(str(a), obj)
        getattr(tm, fn)(str(b), obj)
        assert a.read_bytes() == b.read_bytes(), name
    np.testing.assert_array_equal(tm.read_metis_partition(str(tmp_path / "j.partition")),
                                  part)
    for got, want in zip(tm.read_clusters(str(tmp_path / "j.clusters")), clusters):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tm.read_metis_graph(str(tmp_path / "j.graph")), adjacency):
        np.testing.assert_array_equal(got, want)
    indptr, indices = tm.csr_from_adjacency(adjacency)
    for got, want in zip(tm.adjacency_from_csr(indptr, indices), adjacency):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric,oversample", [("l2", 4), ("mips", 4), ("l2", 0)])
def test_compute_ground_truth_matches(data, metric, oversample):
    """Both phases (bin-top-2 candidates + exact re-sort, with the rescan of
    queries whose found ids share a bin) and the single-phase exact path."""
    qs, base = data
    wi, wd = jr.compute_ground_truth(base, qs, 10, metric,
                                     scan_oversample=oversample)
    gi, gd = tr.compute_ground_truth(base, qs, 10, metric,
                                     scan_oversample=oversample, device="cpu")
    assert gi.dtype == np.int32 and gd.dtype == np.float32
    np.testing.assert_allclose(gd, wd, **TOL)
    np.testing.assert_allclose(exact_dists(qs, base, gi, metric), wd, **TOL)


def test_compute_ground_truth_exact_when_neighbours_share_bins():
    """Rows sorted along one axis put each query's neighbours into the same
    128-row bins; the bin-top-2 scan alone would miss them."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((3000, 8)).astype(np.float32)
    base = base[np.argsort(base[:, 0])]
    base[:, 1:] *= 0.01
    qs = base[rng.choice(3000, 40, replace=False)] + 1e-3
    gi, gd = tr.compute_ground_truth(base, qs, 10, device="cpu")
    want = np.sort(((qs[:, None] - base[None]) ** 2).sum(-1), axis=1)[:, :10]
    np.testing.assert_allclose(gd, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(exact_dists(qs, base, gi, "l2"), want, rtol=1e-4,
                               atol=1e-6)


def test_recall_counts_and_oracles_match():
    rng = np.random.default_rng(5)
    nq, k, n, s = 50, 10, 600, 6
    gt = rng.integers(0, n, (nq, k))
    part = rng.integers(0, s, n).astype(np.int32)
    clusters = [np.nonzero(part == p)[0] for p in range(s)]
    clusters[0] = np.concatenate([clusters[0], clusters[1][:40]])  # overlap
    cover = clusters_to_cover(clusters, n)
    hits = rng.integers(0, 14, nq)
    assert tr.recall_from_hit_counts(hits, k) == jr.recall_from_hit_counts(hits, k)
    np.testing.assert_array_equal(tr.gt_shard_counts(gt, partition=part),
                                  jr.gt_shard_counts(gt, partition=part))
    np.testing.assert_array_equal(tr.gt_shard_counts(gt, cover=cover),
                                  jr.gt_shard_counts(gt, cover=cover))
    np.testing.assert_array_equal(tr.oracle_recall(gt, partition=part),
                                  jr.oracle_recall(gt, partition=part))
    np.testing.assert_array_equal(tr.oracle_recall(gt, cover=cover),
                                  jr.oracle_recall(gt, cover=cover))
    orders = [rng.permutation(s) for _ in range(nq)]
    assert (tr.max_first_shard_routing_recall(gt, orders, part)
            == jr.max_first_shard_routing_recall(gt, orders, part))
