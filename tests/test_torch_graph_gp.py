"""Parity of the port's kNN graph, native ops and graph partitioner with
the JAX package (the partitioning methods are in test_torch_gp_methods.py).

Inputs are drawn with numpy; both packages draw leaders, seeds and
permutations from the same ``np.random.default_rng`` seeds. Exact results
(native ops, LP refinement, ``partition_graph`` part ids, symmetrized CSR)
must be identical; the approximate kNN graph must recover >= 0.99 of the
JAX graph's edges.
"""

import importlib
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpann_tpu import native as jn
from gpann_tpu.graph import knn as jknn
from gpann_tpu_torch import native as tn
from gpann_tpu_torch.graph import knn as tknn

jlp = importlib.import_module("gpann_tpu.gp.lp")
tlp = importlib.import_module("gpann_tpu_torch.gp.lp")


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
    """The JAX package's native library. Its loader builds in place and
    gives up quietly if another process is mid-build, so try twice."""
    for _ in range(2):
        if jn.available():
            return jn
        time.sleep(2.0)
        jn._lib, jn._tried = None, False
    pytest.fail("the JAX package's native library did not load")


@pytest.fixture(scope="module")
def graph():
    """A symmetrized exact kNN graph of 3000 blob points (CSR + COO)."""
    pts = blobs(3000)
    g = jknn.build_exact_knn_graph(pts, 8)
    indptr, indices, w = jknn.symmetrize_to_csr(g)
    u = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return pts, g, indptr, indices, w, u


def test_native_ops_match_jax_library(graph, jax_native):
    _, _, indptr, indices, w, _ = graph
    n = len(indptr) - 1
    rng = np.random.default_rng(1)
    node_w = rng.integers(1, 4, n).astype(np.float32)
    np.testing.assert_array_equal(
        tn.heavy_edge_matching(indptr, indices, w, node_w, 6.0, 12345),
        jn.heavy_edge_matching(indptr, indices, w, node_w, 6.0, 12345))
    cap = 1.05 * np.ceil(node_w.sum() / 8)
    grown = tn.bfs_grow_partition(indptr, indices, node_w, 8, cap, 777)
    np.testing.assert_array_equal(
        grown, jn.bfs_grow_partition(indptr, indices, node_w, 8, cap, 777))
    skewed = np.where(rng.random(n) < 0.5, 0, rng.integers(0, 8, n)).astype(np.int32)
    before = skewed.copy()
    out = tn.force_balance(indptr, indices, w, node_w, 8, cap, skewed)
    np.testing.assert_array_equal(skewed, before)  # the input is not modified
    np.testing.assert_array_equal(
        out, jn.force_balance(indptr, indices, w, node_w, 8, cap, skewed))
    assert np.bincount(out, weights=node_w, minlength=8).max() <= cap


def test_native_ops_hold_the_plain_properties(graph):
    """The plain numpy versions use other tie-breaks and orders, so native
    and plain agree on what each op guarantees, not on the ids."""
    _, _, indptr, indices, w, u = graph
    n = len(indptr) - 1
    node_w = np.ones(n, np.float32)
    idx = np.arange(n)
    for partner in (tn.heavy_edge_matching(indptr, indices, w, node_w, 2.0, 5),
                    tlp._matching_plain(u, indices.astype(np.int64), w, node_w,
                                        2.0, np.random.default_rng(5))):
        assert (partner[partner] == idx).all()  # an involution: mutual pairs
        matched = partner != idx
        assert matched.sum() > n // 10
        # every pair is an edge
        for i in np.nonzero(matched)[0][:200]:
            assert partner[i] in indices[indptr[i] : indptr[i + 1]]
    cap = 1.05 * np.ceil(n / 6)
    for part in (tn.bfs_grow_partition(indptr, indices, node_w, 6, cap, 3),
                 tlp._initial_partition_plain(u, indices.astype(np.int64), w,
                                              node_w, 6, cap,
                                              np.random.default_rng(3))):
        assert part.min() >= 0 and part.max() < 6
    skewed = (idx % 2).astype(np.int32)  # two parts of n/2 > cap
    for part in (tn.force_balance(indptr, indices, w, node_w, 6, cap, skewed),
                 tlp._force_balance_plain(u, indices.astype(np.int64), w,
                                          skewed, node_w, 6, cap)):
        assert np.bincount(part, minlength=6).max() <= cap


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tn, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tn, "CXX_FLAGS", [*tn.CXX_FLAGS, "-fno-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tn.build()


def test_refine_round_matches(graph):
    """One LP round on the same inputs, with many equal gains and equal
    affinities: identical moves (stable sorts, first-index argmax)."""
    _, _, indptr, indices, w, u = graph
    n, k = len(indptr) - 1, 6
    rng = np.random.default_rng(7)
    part = rng.integers(0, k, n).astype(np.int32)
    node_w = rng.integers(1, 3, n).astype(np.float32)
    active = rng.random(n) < 0.7
    cap = 1.05 * np.ceil(node_w.sum() / k)
    want = jlp._refine_round(jnp.asarray(u, jnp.int32),
                             jnp.asarray(indices, jnp.int32), jnp.asarray(w),
                             jnp.asarray(part), jnp.asarray(node_w),
                             jnp.float32(cap), jnp.asarray(active), k)
    got = tlp._refine_round(torch.from_numpy(u), torch.from_numpy(
        indices.astype(np.int64)), torch.from_numpy(w), torch.from_numpy(
        part.astype(np.int64)), torch.from_numpy(node_w),
        torch.tensor(cap, dtype=torch.float32), torch.from_numpy(active), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != part).sum() > 100


@pytest.mark.parametrize("weighted", [False, True])
def test_partition_graph_identical(graph, jax_native, weighted):
    _, _, indptr, indices, w, _ = graph
    nw = (np.random.default_rng(9).integers(1, 5, len(indptr) - 1)
          .astype(np.float32) if weighted else None)
    want = jlp.partition_graph(indptr, indices, w, 8, eps=0.05,
                               node_weights=nw, seed=42)
    got = tlp.partition_graph(indptr, indices, w, 8, eps=0.05, node_weights=nw,
                              seed=42, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_exact_knn_graph_matches(graph):
    pts, want, *_ = graph
    got = tknn.build_exact_knn_graph(pts, 8, query_block=700, device="cpu")
    d = lambda g: ((pts[:, None] - pts[g]) ** 2).sum(-1)  # noqa: E731
    np.testing.assert_allclose(d(got), d(want), rtol=1e-4, atol=1e-4)
    assert not (got == np.arange(len(pts))[:, None]).any()


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_approximate_graph_matches(metric):
    """12k points force a sketching recursion (> MAX_CLUSTER_SIZE); the
    builders pick the same leaders, so the graphs nearly coincide."""
    pts = blobs(12_000, kb=10, d=10)
    if metric == "mips":
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    want = jknn.ApproximateKNNGraphBuilder(metric=metric, seed=555).build(pts, 6)
    got = tknn.ApproximateKNNGraphBuilder(metric=metric, seed=555,
                                          device="cpu").build(pts, 6)
    assert got.shape == want.shape and got.dtype == np.int32
    rec = tknn.graph_recall(got, want)
    assert rec == jknn.graph_recall(got, want)
    assert rec >= 0.99, rec
    for a, b in zip(tknn.symmetrize_to_csr(want), jknn.symmetrize_to_csr(want)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_topk_smallest_orders_ties_as_lax_top_k():
    """Equal values go out in ascending position, as ``jax.lax.top_k``
    gives them; small integers make most entries ties, +inf fills masked
    rows (C12)."""
    import jax

    from gpann_tpu_torch.core.distances import topk_smallest

    rng = np.random.default_rng(12)
    x = rng.integers(0, 6, size=(3, 40, 300)).astype(np.float32)
    x[0, :, 5:] = np.inf        # fewer finite entries than k
    x[1, 3] = 2.0               # a row of one value
    for k in (1, 7, 16):
        neg, want = jax.lax.top_k(-jnp.asarray(x), k)
        vals, got = topk_smallest(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


def test_merge_sort_orders_as_np_lexsort():
    """The graph merge's device sort (``knn._lexsort``) gives
    ``np.lexsort``'s order, full ties in their input order."""
    rng = np.random.default_rng(3)
    for n in (1, 9, 50_000):
        src, dst = rng.integers(0, 40, (2, n))
        dist = rng.integers(0, 4, n).astype(np.float32)
        for keys in ((dist, dst, src), (dist, src)):
            got = tknn._lexsort(tuple(torch.from_numpy(x) for x in keys))
            np.testing.assert_array_equal(got.numpy(), np.lexsort(keys))


def test_approximate_graph_on_byte_data_equals_jax():
    """Byte points (the ``hard2`` u8 bases of ``cli.scale_bench``) have exact
    integer L2 distances, so ties are common: the port breaks them to the
    lowest id in the leader match and the bucket top-k, as the JAX package
    does, and builds the same graph, hence the same LP partition (C12;
    before, 5 of 20,000 edges of a 2000-point graph differed, and the
    partition with them). 12k points force a sketching recursion."""
    from gpann_tpu.eval.synth import VirtualPoints as JPoints
    from gpann_tpu.gp.partitioning import partition_dense_graph as jpart
    from gpann_tpu_torch.gp.partitioning import partition_dense_graph as tpart

    pts = np.asarray(JPoints("hard2", 12_000, 16, 555, dtype="u8")[:],
                     np.float32)
    want = jknn.ApproximateKNNGraphBuilder(seed=555).build(pts, 10)
    got = tknn.ApproximateKNNGraphBuilder(seed=555, device="cpu").build(pts,
                                                                        10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tpart(got, 8, 0.05, seed=555, device="cpu"),
        np.asarray(jpart(want, 8, 0.05, seed=555)))
