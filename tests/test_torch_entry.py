"""The port's entry points (``gpann_tpu_torch/entry.py``) against the root
``__graft_entry__.py``: ``entry(device="cpu")`` builds the same problem and
its scan returns the JAX ``entry()``'s jitted output (distances at rtol
1e-4, ids equal); ``dryrun_multichip`` runs its three steps in 4 and 8 CPU
ranks, every rank returning the same result."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from gpann_tpu_torch import entry as tentry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads per process: the suite runs in several test
    processes on one host, and torch's default of one thread per core
    oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_entry_matches_the_jax_entry():
    sys.path.insert(0, REPO)
    import __graft_entry__ as jentry

    jfn, jargs = jentry.entry()
    want_d, want_i = (np.asarray(a) for a in jax.jit(jfn)(*jargs))
    fn, args = tentry.entry(device="cpu")
    for got, ref in zip(args, jargs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    d, i = fn(*args)
    assert d.shape == (64, 10) and (i >= 0).all()
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(i.numpy(), want_i)


def test_entry_refuses_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tentry.dryrun_multichip(2)


@pytest.mark.parametrize("n, mesh", [(4, {"dp": 2, "shard": 2}),
                                     (8, {"dp": 2, "shard": 4})])
def test_dryrun_multichip_cpu(n, mesh):
    outs = tentry.dryrun_multichip(n, device="cpu")
    assert len(outs) == n
    for out in outs:
        assert out["mesh"] == mesh and out["device"] == "cpu"
        for key in ("dists", "ids", "serve_ids", "centroids", "assignment"):
            np.testing.assert_array_equal(out[key], outs[0][key])
    # the probed step is the entry() scan, merged over the ranks
    fn, args = tentry.entry(device="cpu")
    d, i = fn(*args)
    np.testing.assert_allclose(outs[0]["dists"], d.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(outs[0]["ids"], i.numpy())
