"""Parity of the port's eight non-overlapping partitioning methods, GP at
scale and the partition CLI with the JAX package.

Blob data is drawn with numpy; both packages draw their samples and seeds
from the same ``np.random.default_rng`` seeds. Every partition must hold the
(1+eps)*ceil(n/k) bound; the k-means family and Random must match the JAX
partition exactly, GP's oracle recall must be within 0.02 of JAX's, and the
CLI must write the JAX CLI's file byte for byte.
"""

import importlib
import time

import numpy as np
import pytest
import torch

from gpann_tpu import native as jn
from gpann_tpu.cli import partition as jcli
from gpann_tpu.core.partition import clusters_to_partition
from gpann_tpu.eval import compute_ground_truth, oracle_recall
from gpann_tpu.gp import api as japi
from gpann_tpu_torch.cli import partition as tcli
from gpann_tpu_torch.gp import api as tapi

jscale = importlib.import_module("gpann_tpu.gp.scale")
tscale = importlib.import_module("gpann_tpu_torch.gp.scale")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host, and torch's default of one thread per core
    oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def blobs(n, kb=8, d=12, seed=555, spread=0.4, scale=4.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((kb, d)).astype(np.float32) * scale
    lbl = rng.integers(0, kb, size=n)
    return (centers[lbl] + spread * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library (see test_torch_graph_gp.py)."""
    for _ in range(2):
        if jn.available():
            return jn
        time.sleep(2.0)
        jn._lib, jn._tried = None, False
    pytest.fail("the JAX package's native library did not load")


METHODS = ["Random", "FlatKMeans", "KMeans", "BalancedKMeans", "RKM", "GP",
           "Pyramid", "OurPyramid"]


@pytest.fixture(scope="module")
def method_case():
    pts = blobs(2000, kb=8, d=10)
    q = pts[:100] + 0.05 * np.random.default_rng(2).standard_normal(
        (100, 10)).astype(np.float32)
    gt_ids, _ = compute_ground_truth(pts, q, 10)
    return pts, gt_ids


@pytest.mark.parametrize("method", METHODS)
def test_partition_methods(method_case, jax_native, method):
    """Balance for every method; the k-means family and Random are
    deterministic given the seed and match the JAX package exactly; GP's
    oracle recall is within 0.02 of JAX's."""
    pts, gt_ids = method_case
    n, k = len(pts), 8
    got = tapi.partition(pts, k, method, eps=0.05, device="cpu")
    sizes = np.asarray([len(c) for c in got])
    assert sizes.sum() == n
    if method != "FlatKMeans":  # FlatKMeans has no balance guarantee
        assert sizes.max() <= int((1.05) * np.ceil(n / k)), sizes
    want = japi.partition(pts, k, method, eps=0.05)
    if method in ("Random", "FlatKMeans", "KMeans", "RKM"):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    if method == "GP":
        o_got = oracle_recall(gt_ids, partition=clusters_to_partition(got, n))
        o_want = oracle_recall(gt_ids, partition=clusters_to_partition(want, n))
        assert abs(o_got[0] - o_want[0]) <= 0.02, (o_got[0], o_want[0])
        assert o_got[0] > 0.8


@pytest.mark.parametrize("method,overlap", [("OGP", 0.2), ("OGPS", 0.2),
                                            ("OKM", 0.2), ("OBKM", 0.2),
                                            ("ORKM", 0.2), ("GP", 0.1)])
def test_overlapping_methods_dispatch(method, overlap):
    """The overlapping methods dispatch by name (their parity with the JAX
    package is in test_torch_overlap.py): each returns a cover within the
    capacity bound, and a misspelt name raises."""
    pts = blobs(400, d=4)
    got = tapi.partition(pts, 4, method, overlap=overlap, device="cpu")
    sizes = [len(c) for c in got]
    assert max(sizes) <= int(1.05 * 400 / 4)
    assert 400 <= sum(sizes) <= 400 + int(overlap * 400)
    assert len(np.unique(np.concatenate(got))) == 400
    with pytest.raises(ValueError, match="unsupported partitioning method"):
        tapi.partition(pts, 4, method.lower(), overlap=overlap, device="cpu")


def test_subsample_gp_partition(jax_native):
    pts = blobs(20_000, kb=12, d=16)
    q = pts[::200] + 0.05 * np.random.default_rng(3).standard_normal(
        (100, 16)).astype(np.float32)
    gt_ids, _ = compute_ground_truth(pts, q, 10)
    kw = dict(k=8, eps=0.05, num_subsample=6000, num_aggregate=256,
              chunk_rows=4096)
    want = jscale.subsample_gp_partition(pts, **kw)
    got, (aggs, labels, sample_idx, sub_part) = tscale.subsample_gp_partition(
        pts, return_artifacts=True, device="cpu", **kw)
    assert np.bincount(got, minlength=8).max() <= int(1.05 * np.ceil(20_000 / 8))
    assert got.min() >= 0 and len(aggs) == len(labels) <= 256 + 8
    o_got = oracle_recall(gt_ids, partition=got)[0]
    o_want = oracle_recall(gt_ids, partition=want)[0]
    assert abs(o_got - o_want) <= 0.02, (o_got, o_want)


@pytest.mark.parametrize("method", ["Random", "KMeans"])
def test_cli_writes_the_jax_file(tmp_path, method):
    from gpann_tpu_torch.core.pointset import write_points

    pts = blobs(1500, kb=6, d=8)
    path = str(tmp_path / "pts.fbin")
    write_points(path, pts)
    assert jcli.main([path, str(tmp_path / "jax"), "6", method]) == 0
    assert tcli.main([path, str(tmp_path / "port"), "6", method,
                      "--device", "cpu"]) == 0
    want = (tmp_path / f"jax.k=6.{method}").read_bytes()
    assert (tmp_path / f"port.k=6.{method}").read_bytes() == want


def test_cli_refuses_cuda_without_gpu_and_overlapping_methods(tmp_path):
    """``--device cuda`` (the default) raises without a GPU; an overlapping
    method writes its ``.o=<overlap>`` cover; an unknown method raises."""
    from gpann_tpu_torch.core.metis_io import read_clusters
    from gpann_tpu_torch.core.pointset import write_points

    path = str(tmp_path / "pts.fbin")
    write_points(path, blobs(200, d=4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tcli.main([path, str(tmp_path / "out"), "4", "Random"])
    assert tcli.main([path, str(tmp_path / "out"), "4", "OKM",
                      "--device=cpu"]) == 0
    sizes = [len(c) for c in read_clusters(str(tmp_path / "out.k=4.OKM.o=0.2"))]
    assert max(sizes) <= int(1.05 * 200 / 4) and 200 < sum(sizes) <= 240
    with pytest.raises(ValueError, match="unsupported partitioning method"):
        tcli.main([path, str(tmp_path / "out"), "4", "okm", "--device=cpu"])
