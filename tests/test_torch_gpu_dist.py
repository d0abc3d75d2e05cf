"""The multi-rank engines on a CUDA device against the same engines on the
CPU.

Every test needs a GPU (marker ``gpu``) and skips without one. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_gpu_dist.py -q

The CPU results are held against the JAX package by
``tests/test_torch_dist.py``; here the device must not change them: at
world size 1 in this process, and with two ranks that share the card and
exchange over gloo. Distances agree at rtol = atol = 1e-4, ids as sorted
sets; the Lloyd round's assignment is identical and repeats itself.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks_mod
from gpann_tpu_torch.core.partition import partition_to_clusters
from gpann_tpu_torch.dist.launch import run_ranks
from gpann_tpu_torch.gp.partitioning import random_partition
from gpann_tpu_torch.search.ivf import IVFIndex
from gpann_tpu_torch.search.serve import ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def setup():
    """20k x 32 blobs in 8 random shards, 96 queries, a 2000-point router
    (enough rows a shard for the binned voting's scan)."""
    rng = np.random.default_rng(555)
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 3
    pts = (centers[rng.integers(0, 16, size=20_000)]
           + 0.5 * rng.standard_normal((20_000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 16, size=96)]
         + 0.5 * rng.standard_normal((96, 32))).astype(np.float32)
    assign = random_partition(len(pts), 8)
    clusters = partition_to_clusters(assign, 8)
    rsub = np.sort(rng.choice(len(pts), 2000, replace=False))
    inp = dict(pts=pts, q=q, clusters=clusters, rp=pts[rsub], rl=assign[rsub],
               cents=pts[:8].copy())
    want = {"ivf": IVFIndex(pts, clusters, device="cpu").search_probed(
        q, ranks_mod.probes(96, 8, 8), 10)}
    single = ServingEngine(pts, clusters, pts[rsub], assign[rsub],
                           pad_multiple=128, device="cpu")
    want["serve"] = single.serve(q, 10, nprobes=3, voting_t=8, query_block=32)
    dm = ((pts[:, None, :] - inp["cents"][None]) ** 2).sum(-1)
    want["assignment"] = dm.argmin(1)
    return inp, want


def check(out, want):
    for key, ref in (("ivf", want["ivf"]), ("exact", want["serve"]),
                     ("binned", want["serve"])):
        (d, i), (wd, wi) = out[key], ref
        np.testing.assert_allclose(d, wd, **TOL)
        np.testing.assert_array_equal(np.sort(i, 1), np.sort(wi, 1))
    (c1, a1), (c2, a2) = out["lloyd"]
    np.testing.assert_array_equal(a1, want["assignment"])
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(c1, c2)


@pytest.mark.gpu
def test_world_one_on_cuda(cuda, setup):
    inp, want = setup
    check(ranks_mod.on_card(inp), want)


@pytest.mark.gpu
def test_two_ranks_share_the_card_over_gloo(cuda, setup):
    inp, want = setup
    outs = run_ranks(ranks_mod.on_card, 2, (inp,), timeout=120)
    for out in outs:
        check(out, want)
