"""Parity of the port's multi-rank engines (``gpann_tpu_torch/dist``) with
the JAX package's (``gpann_tpu/dist/mesh.py``) and with the port's own
single-process engines.

Two and four CPU ranks (gloo, two torch threads each) are started once per
world size by ``gpann_tpu_torch.dist.launch.run_ranks`` with a timeout of
their own; each runs every scenario of ``tests/test_dist.py`` and
``tests/test_multiprocess.py`` (``tests/torch_dist_ranks.py``) and returns
its results, which the tests below check one by one. The JAX engines run on
the conftest's eight CPU devices with the same dp, on the same seeded
inputs and the same clusters (the JAX package's balanced k-means).

Tolerances: distances at rtol = atol = 1e-4; ids equal where both sides
scan in one order (the port's single-process ``IVFIndex``), as sorted sets
otherwise (the JAX tests' comparison); Lloyd assignments identical,
centroids within 1e-3 of the single-process round and of JAX's (MIPS: within
1e-5 of a numpy f64 oracle's and of JAX's), two calls identical; every rank
returns the same whole result.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks_mod
from gpann_tpu.cluster import balanced_kmeans
from gpann_tpu.core.partition import partition_to_clusters
from gpann_tpu.dist import DistributedIVF as JaxIVF
from gpann_tpu.dist import DistributedServingEngine as JaxServing
from gpann_tpu.dist import shard_mesh as jax_mesh
from gpann_tpu.dist import sharded_lloyd_round as jax_lloyd
from gpann_tpu.route import centroid_router
from gpann_tpu_torch.cluster.kmeans import kmeans, random_sample
from gpann_tpu_torch.core import profiling
from gpann_tpu_torch.dist import (DistributedIVF, DistributedServingEngine,
                                  shard_mesh, sharded_lloyd_round)
from gpann_tpu_torch.dist.launch import run_ranks
from gpann_tpu_torch.dist.mesh import SERVE_STEPS
from gpann_tpu_torch.eval.recall import (compute_ground_truth,
                                         kth_neighbor_distance, recall_from_ids)
from gpann_tpu_torch.search.ivf import IVFIndex
from gpann_tpu_torch.search.serve import ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
RULES = ranks_mod.RULES
probes = ranks_mod.probes


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host, and torch's default of one thread per core
    oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def blobs(seed, kb, d, n, nq):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((kb, d)).astype(np.float32) * 4
    lbl = rng.integers(0, kb, size=n)
    pts = (centers[lbl] + 0.4 * rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, kb, size=nq)]
         + 0.4 * rng.standard_normal((nq, d))).astype(np.float32)
    return rng, pts, q


@pytest.fixture(scope="module")
def setup():
    """``tests/test_dist.py``'s data (4096 x 16, 64 queries, 8 balanced
    k-means shards) and ``tests/test_multiprocess.py``'s (2048 x 12, 32
    queries, a 256-point router), the variants the scenarios need, and the
    JAX engines' state and results."""
    _, pts, q = blobs(555, 8, 16, 4096, 64)
    _, assign = balanced_kmeans(pts, k=8, eps=0.3, seed=1)
    clusters = partition_to_clusters(assign, 8)
    router = centroid_router(pts, clusters)
    rp, rl = np.asarray(router.points), router.labels_np
    clusters5 = [np.concatenate([clusters[i], clusters[i + 5]]) if i < 3
                 else clusters[i] for i in range(5)]
    # 3 of 8 shards under 16 rows: the ranks' capacities differ
    ragged = [list(c) for c in clusters]
    for b, keep in ((5, 5), (6, 9), (7, 15)):
        for j, pid in enumerate(ragged[b][keep:]):
            ragged[j % 5].append(pid)
        ragged[b] = ragged[b][:keep]
    ragged = [np.sort(np.asarray(c, np.int64)) for c in ragged]
    cents = random_sample(pts, 8, seed=5)

    rng, mpts, mq = blobs(555, 8, 12, 2048, 32)
    _, massign = balanced_kmeans(mpts, k=8, eps=0.3, seed=1)
    rsub = np.sort(rng.choice(2048, 256, replace=False))
    mp = dict(pts=mpts, q=mq, clusters=partition_to_clusters(massign, 8),
              rp=mpts[rsub], rl=massign[rsub])

    jmesh1, jmesh2 = jax_mesh(dp=1), jax_mesh(dp=2)
    jserve = JaxServing(pts, clusters, rp, rl, mesh=jmesh2)
    state = dict(arrays={name: np.asarray(getattr(jserve, name)) for name in (
        "shard_points", "shard_sizes", "shard_ids", "router_points",
        "router_labels", "router_sq")},
        config=dict(num_shards=jserve.num_shards, metric=jserve.metric,
                    rescore=jserve.rescore, voting_impl=jserve.voting_impl))
    jivf2 = JaxIVF(pts, clusters, mesh=jmesh2)
    import jax.numpy as jnp
    jc, ja = jax_lloyd(jmesh2, k=8)(jnp.asarray(pts), jnp.asarray(cents))
    jmc, jma = jax_lloyd(jmesh2, k=8, metric="mips")(jnp.asarray(pts),
                                                       jnp.asarray(cents))
    jax_out = {
        "dp1": JaxIVF(pts, clusters, mesh=jmesh1).search_probed(
            q, probes(64, 8, 3), 10),
        "dp2": jivf2.search_probed(q, probes(64, 8, 8), 10),
        "five": JaxIVF(pts, clusters5).search_probed(q, probes(64, 5, 5), 10),
        "uneven": jivf2.search_probed(q[:13], probes(13, 8, 8), 10),
        "mb_pad": jserve.serve(q[:50], k=10, nprobes=8, voting_t=8,
                               microbatch=16),
        "lloyd": (np.asarray(jc), np.asarray(ja)),
        "mips_ivf": JaxIVF(pts, clusters, mesh=jmesh2, metric="mips"
                           ).search_probed(q, probes(64, 8, 3), 10),
        "mips_serve": JaxServing(pts, clusters, rp, rl, mesh=jmesh2,
                                 metric="mips").serve(
            q, k=10, nprobes=3, voting_t=8, microbatch=16),
        "mips_lloyd": (np.asarray(jmc), np.asarray(jma)),
        "ragged": JaxIVF(pts, ragged, mesh=jmesh1).search_probed(
            q, probes(64, 8, 8), 10),
        "mp_ivf": JaxIVF(mp["pts"], mp["clusters"], mesh=jmesh1).search_probed(
            mp["q"], probes(32, 8, 3), 10),
        "mp_serve": JaxServing(mp["pts"], mp["clusters"], mp["rp"], mp["rl"],
                               mesh=jmesh1).serve(mp["q"], 10, nprobes=3,
                                                  voting_t=20, microbatch=16),
    }
    for rule in RULES:
        jax_out[f"serve_{rule}"] = jserve.serve(q, k=10, nprobes=3, voting_t=8,
                                                rule=rule, microbatch=16)
    jax_out["state_ivf"] = jax_out["dp1"]
    jax_out["state_serve"] = jax_out["serve_min_dist"]
    inp = dict(pts=pts, q=q, clusters=clusters, clusters5=clusters5,
               ragged=ragged, rp=rp, rl=rl, cents=cents, mp=mp, state=state)
    return dict(inp=inp, jax=jax_out)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def run(request, setup):
    """(world, every rank's results): one spawn per world size."""
    world = request.param
    return world, run_ranks(ranks_mod.scenarios, world, (setup["inp"],),
                            timeout=120)


def single_ivf(inp, clusters, p, m=None):
    q = inp["q"][:m]
    return IVFIndex(inp["pts"], clusters, device="cpu").search_probed(
        q, probes(len(q), len(clusters), p), 10)


def assert_same(got, want, ids="equal"):
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_allclose(gd, wd, **TOL)
    if ids == "equal":
        np.testing.assert_array_equal(gi, wi)
    else:
        np.testing.assert_array_equal(np.sort(gi, 1), np.sort(wi, 1))


def test_every_rank_returns_the_whole_result(run):
    world, outs = run
    assert outs[0]["mesh1"] == {"dp": 1, "shard": world}
    assert outs[0]["mesh2"] == {"dp": 2, "shard": world // 2}
    for out in outs[1:]:
        for key, value in out.items():
            if key == "ragged_capacity":
                continue
            if isinstance(value, dict) or isinstance(value, str):
                assert value == outs[0][key], key
            else:
                for a, b in zip(np.asarray(value, dtype=object).ravel(),
                                np.asarray(outs[0][key], dtype=object).ravel()):
                    np.testing.assert_array_equal(a, b, err_msg=key)


def test_dp1_matches_single_and_jax(run, setup):
    inp, out = setup["inp"], run[1][0]
    assert_same(out["dp1"], single_ivf(inp, inp["clusters"], 3))
    assert_same(out["dp1"], setup["jax"]["dp1"])


def test_dp_axis_matches_single_and_jax(run, setup):
    inp, out = setup["inp"], run[1][0]
    assert_same(out["dp2"], single_ivf(inp, inp["clusters"], 8))
    assert_same(out["dp2"], setup["jax"]["dp2"], ids="sets")


def test_full_probe_recall(run, setup):
    inp, out = setup["inp"], run[1][0]
    _, gt_d = compute_ground_truth(inp["pts"], inp["q"], 10, device="cpu")
    kth = kth_neighbor_distance(gt_d, 10)
    assert recall_from_ids(inp["pts"], inp["q"], out["full"][1], kth, 10) == 1.0


def test_shard_count_not_multiple_of_ranks(run, setup):
    """5 shards on a shard axis of 2 or 4: padded with empty shards."""
    inp, out = setup["inp"], run[1][0]
    assert sum(len(c) for c in inp["clusters5"]) == len(inp["pts"])
    assert_same(out["five"], single_ivf(inp, inp["clusters5"], 5))
    assert_same(out["five"], setup["jax"]["five"], ids="sets")


def test_uneven_query_batch_padded(run, setup):
    inp, out = setup["inp"], run[1][0]
    assert out["uneven"][0].shape == (13, 10)
    assert_same(out["uneven"], single_ivf(inp, inp["clusters"], 8, m=13))
    assert_same(out["uneven"], setup["jax"]["uneven"], ids="sets")


@pytest.mark.parametrize("rule", RULES)
def test_serve_matches_single_and_jax(run, setup, rule):
    inp, out = setup["inp"], run[1][0]
    single = ServingEngine(inp["pts"], inp["clusters"], inp["rp"], inp["rl"],
                           pad_multiple=128, device="cpu")
    want = single.serve(inp["q"], k=10, nprobes=3, voting_t=8, rule=rule,
                        query_block=32)
    assert_same(out[f"serve_{rule}"], want, ids="sets")
    assert_same(out[f"serve_{rule}"], setup["jax"][f"serve_{rule}"], ids="sets")


def test_serve_microbatch_padding(run, setup):
    """50 queries padded to dp * microbatch quanta."""
    inp, out = setup["inp"], run[1][0]
    d, i = out["mb_pad"]
    assert d.shape == (50, 10) and (i >= 0).all()
    single = ServingEngine(inp["pts"], inp["clusters"], inp["rp"], inp["rl"],
                           pad_multiple=128, device="cpu")
    assert_same((d, i), single.serve(inp["q"][:50], k=10, nprobes=8,
                                     voting_t=8, query_block=16), ids="sets")
    assert_same((d, i), setup["jax"]["mb_pad"], ids="sets")


def test_sharded_lloyd_round(run, setup):
    """Assignments identical to the single-process round's (and JAX's and a
    numpy oracle's), centroids within 1e-3, two calls identical."""
    inp, out = setup["inp"], run[1][0]
    (c1, a1), (c2, a2) = out["lloyd"]
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)
    pts, cents = inp["pts"], inp["cents"]
    dm = ((pts[:, None, :] - cents[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(a1, dm.argmin(1))
    jc, ja = setup["jax"]["lloyd"]
    np.testing.assert_array_equal(a1, ja)
    single_c, _ = kmeans(pts, centroids=cents, rounds=1, device="cpu")
    np.testing.assert_allclose(c1, single_c, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(c1, jc, rtol=1e-3, atol=1e-3)


def test_mips_search_and_serve(run, setup):
    """MIPS: the probed search against the single-process ``IVFIndex``
    (ids equal) and the JAX engine (id sets), the fused serve against the
    single-process ``ServingEngine`` and the JAX engine (id sets)."""
    inp, out = setup["inp"], run[1][0]
    want = IVFIndex(inp["pts"], inp["clusters"], metric="mips", device="cpu"
                    ).search_probed(inp["q"], probes(64, 8, 3), 10)
    assert_same(out["mips_ivf"], want)
    assert_same(out["mips_ivf"], setup["jax"]["mips_ivf"], ids="sets")
    single = ServingEngine(inp["pts"], inp["clusters"], inp["rp"], inp["rl"],
                           metric="mips", pad_multiple=128, device="cpu")
    want = single.serve(inp["q"], k=10, nprobes=3, voting_t=8, query_block=32)
    assert_same(out["mips_serve"], want, ids="sets")
    assert_same(out["mips_serve"], setup["jax"]["mips_serve"], ids="sets")


def test_sharded_lloyd_round_mips(run, setup):
    """MIPS Lloyd: assignments identical to JAX's and to a numpy f64 oracle
    (largest inner product), centroids the plain means (not renormalised)
    within 1e-5 of the oracle's and of JAX's, two calls identical."""
    inp, out = setup["inp"], run[1][0]
    (c1, a1), (c2, a2) = out["mips_lloyd"]
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)
    pts = inp["pts"].astype(np.float64)
    want_a = (pts @ inp["cents"].astype(np.float64).T).argmax(1)
    np.testing.assert_array_equal(a1, want_a)
    jc, ja = setup["jax"]["mips_lloyd"]
    np.testing.assert_array_equal(a1, ja)
    want_c = inp["cents"].astype(np.float64)       # empty clusters keep theirs
    for c in np.unique(want_a):
        want_c[c] = pts[want_a == c].mean(0)
    np.testing.assert_allclose(c1, want_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c1, jc, rtol=1e-5, atol=1e-5)


def test_multiprocess_parity(run, setup):
    """``tests/test_multiprocess.py`` in the port's form: the probed search
    and the fused serve of 2 / 4 ranks against the single-process engines
    of both packages."""
    from gpann_tpu.search import IVFIndex as JaxIndex
    from gpann_tpu.search.serve import ServingEngine as JaxSingle

    mp, out = setup["inp"]["mp"], run[1][0]
    ivf = IVFIndex(mp["pts"], mp["clusters"], device="cpu")
    assert_same(out["mp_ivf"], ivf.search_probed(mp["q"], probes(32, 8, 3), 10),
                ids="sets")
    assert_same(out["mp_ivf"], JaxIndex(mp["pts"], mp["clusters"]).search_probed(
        mp["q"], probes(32, 8, 3), 10), ids="sets")
    assert_same(out["mp_ivf"], setup["jax"]["mp_ivf"], ids="sets")
    for engine in (ServingEngine(mp["pts"], mp["clusters"], mp["rp"], mp["rl"],
                                 pad_multiple=128, device="cpu"),
                   JaxSingle(mp["pts"], mp["clusters"], mp["rp"], mp["rl"],
                             pad_multiple=128)):
        assert_same(out["mp_serve"], engine.serve(
            mp["q"], 10, nprobes=3, voting_t=20, query_block=32), ids="sets")
    assert_same(out["mp_serve"], setup["jax"]["mp_serve"], ids="sets")


def test_from_jax_state(run, setup):
    """Engines carried over from the JAX serving engine's numpy state (its
    8-shard stack padded for a 4-device shard axis) answer as the JAX
    engine does."""
    out = run[1][0]
    assert_same(out["state_ivf"], setup["jax"]["state_ivf"], ids="sets")
    assert_same(out["state_serve"], setup["jax"]["state_serve"], ids="sets")


def test_shards_of_very_different_sizes(run, setup):
    """3 of 8 shards under 16 rows: each rank sizes its stack by its own
    largest shard, and the result does not depend on it."""
    outs, inp = run[1], setup["inp"]
    assert_same(outs[0]["ragged"], single_ivf(inp, inp["ragged"], 8))
    assert_same(outs[0]["ragged"], setup["jax"]["ragged"], ids="sets")
    caps = [o["ragged_capacity"] for o in outs]
    assert len(set(caps)) > 1, caps


def test_nccl_refuses_cpu_tensors(run):
    assert "nccl exchanges CUDA tensors" in run[1][0]["nccl_on_cpu"]


def test_one_rank_layout_in_process(setup):
    """No process group: world 1, no collectives; dp 2 cannot divide it."""
    inp = setup["inp"]
    mesh = shard_mesh()
    assert (mesh.world, mesh.dp, mesh.shard, mesh.rank) == (1, 1, 1, 0)
    assert mesh.group is None and mesh.shard_group is None
    with pytest.raises(ValueError, match="not divisible"):
        shard_mesh(dp=2)
    got = DistributedIVF(inp["pts"], inp["clusters"], device="cpu"
                         ).search_probed(inp["q"], probes(64, 8, 3), 10)
    assert_same(got, single_ivf(inp, inp["clusters"], 3))
    c, a = sharded_lloyd_round(mesh, 8, device="cpu")(inp["pts"], inp["cents"])
    np.testing.assert_array_equal(a.numpy(), setup["jax"]["lloyd"][1])


def test_serve_device_marks_its_steps(setup):
    """A recorded serve_device call has one span a step and microbatch,
    in order and disjoint, under one root span (the smoke run splits a
    rank's batch by them); the spans change no result."""
    inp = setup["inp"]
    eng = DistributedServingEngine(inp["pts"], inp["clusters"], inp["rp"],
                                   inp["rl"], device="cpu")
    q = torch.from_numpy(inp["q"])
    with profiling.recording(profiling.Recorder()) as rec:
        d, i = eng.serve_device(q, 10, 3, voting_t=8, microbatch=16)
    spans = rec.drain().spans
    (root,) = [sp for sp in spans if sp.parent == -1]
    steps = [sp for sp in spans if sp.parent != -1]
    per_batch = -(-len(q) // 16)
    assert root.name == "dist.batch"
    assert [sp.name for sp in steps] == (list(SERVE_STEPS[:3]) * per_batch
                                         + [SERVE_STEPS[3]])
    assert all(sp.parent == root.id and sp.batch == root.batch
               for sp in steps)
    edges = [t for sp in steps for t in (sp.start_ns, sp.end_ns)]
    assert edges == sorted(edges)
    assert root.start_ns <= edges[0] and edges[-1] <= root.end_ns
    want = eng.serve(inp["q"], 10, 3, voting_t=8, microbatch=16)
    np.testing.assert_array_equal(d.numpy(), want[0])
    np.testing.assert_array_equal(i.numpy(), want[1])


def test_a_failed_or_late_rank_ends_the_run():
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_ranks(ranks_mod.fail_on_rank, 2, (1,), timeout=60)
    with pytest.raises(TimeoutError, match="still running"):
        run_ranks(ranks_mod.sleep, 2, (600,), timeout=4)
