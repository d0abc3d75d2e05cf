"""The frozen generators give the program's bytes; the traffic repeats for a
seed."""

import numpy as np
import pytest
import torch

from annbench import datagen


def test_hard_base_and_queries_equal_the_programs(monkeypatch):
    from gpann_tpu_torch.eval import synth

    monkeypatch.setattr(datagen, "CHUNK_ROWS", 1000)
    got = datagen.hard_base(3500, 16, 555, threads=3)
    want = synth.generate("hard", 3500, 16, 555, chunk_rows=1000)
    assert got.tobytes() == want.tobytes()
    assert (datagen.hard_queries(70, 16, 555).tobytes()
            == synth.generate_queries("hard", 70, 16, 555).tobytes())
    params = synth.make_params("hard", 16, 555)
    for a, b in zip(datagen.hard_params(16, 555), params):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("n", [1000, 2500])
def test_blobs_base_and_queries_equal_bench(monkeypatch, tmp_path, n):
    from gpann_tpu_torch.cli.bench import _blobs_data
    from gpann_tpu_torch.eval import synth

    monkeypatch.setattr(datagen, "CHUNK_ROWS", 1000)
    pts, q = _blobs_data(n, 16, 40, str(tmp_path))
    got, got_q = datagen.blobs_base_and_queries(n, 16, 40, 555)
    assert got.tobytes() == np.asarray(pts).tobytes()
    assert got_q.tobytes() == q.tobytes()
    assert (datagen.blobs_centers(16, 555).tobytes()
            == synth.make_params("blobs", 16, 555).tobytes())


@pytest.mark.parametrize("kind", ["hard", "blobs"])
def test_device_batches_repeat_for_a_seed(monkeypatch, kind):
    monkeypatch.setattr(datagen, "GROUP_ROWS", 100)
    big = 2**31 + 12345
    a = datagen.device_batches(kind, 8, 555, 5, 40, big, "cpu")
    b = datagen.device_batches(kind, 8, 555, 5, 40, big, "cpu")
    c = datagen.device_batches(kind, 8, 555, 5, 40, big + 1, "cpu")
    assert a.shape == (5, 40, 8) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    if kind == "hard":
        # int(0.05 * 40) = 2 background rows a batch, inside [-8, 8)
        flat = a.view(-1, 8)
        assert ((flat >= -8) & (flat < 8)).all(1).sum() >= 5 * 2


def test_base_and_check_queries_rejects_an_unknown_kind():
    with pytest.raises(ValueError):
        datagen.base_and_check_queries("sift", 10, 4, 2, 1)
