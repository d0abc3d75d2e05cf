"""Parity of the port's dataset generators and native "hard2" loop with the
JAX package's (``gpann_tpu/eval/synth.py``, ``native/src/synth_gen.cc``).

Both packages get the same ``(kind, n, d, seed, dtype, chunk_rows)``. Their
outputs must be BYTE-IDENTICAL: the shipped ground truth and partitions are
valid only on exactly that data. The native loop is held against the numpy
oracle at rtol = atol = 1e-5 and a 1e-4 share of bytes that differ at a
rounding boundary, as ``tests/test_synth_hard2.py`` holds it.
"""

import os

import numpy as np
import pytest

from gpann_tpu.eval import synth as jsynth
from gpann_tpu_torch import native
from gpann_tpu_torch.eval import synth as tsynth

KINDS = ("blobs", "hard", "hard2")
DTYPES = ("f32", "u8", "i8")
N, D, SEED, CHUNK = 5000, 24, 7, 2048


def same_bytes(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_make_params_identical(kind):
    jp, tp = (m.make_params(kind, D, SEED) for m in (jsynth, tsynth))
    if kind == "blobs":  # one array of centers; else (centers, scales, w)
        jp, tp = (jp,), (tp,)
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        same_bytes(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_generate_byte_identical(kind, dtype):
    same_bytes(
        jsynth.generate(kind, N, D, seed=SEED, chunk_rows=CHUNK, dtype=dtype),
        tsynth.generate(kind, N, D, seed=SEED, chunk_rows=CHUNK, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_queries_byte_identical(kind, dtype):
    same_bytes(jsynth.generate_queries(kind, 200, D, SEED, dtype),
               tsynth.generate_queries(kind, 200, D, SEED, dtype))


@pytest.mark.parametrize("dtype", ("u8", "i8"))
def test_quantize_chunk_byte_identical(dtype):
    x = (np.random.default_rng(3).standard_normal((512, 8)) * 6
         ).astype(np.float32)
    same_bytes(jsynth._quantize_chunk(x.copy(), dtype),
               tsynth._quantize_chunk(x.copy(), dtype))
    assert jsynth.U8_SCALE == tsynth.U8_SCALE


@pytest.mark.parametrize("kind,dtype", [("hard", "f32"), ("hard2", "u8"),
                                        ("blobs", "i8")])
def test_virtual_points_slices_and_fancy_indices(kind, dtype):
    jv = jsynth.VirtualPoints(kind, N, D, SEED, dtype=dtype, chunk_rows=CHUNK)
    tv = tsynth.VirtualPoints(kind, N, D, SEED, dtype=dtype, chunk_rows=CHUNK)
    assert tv.shape == jv.shape and tv.dtype == jv.dtype and tv.iid_rows
    assert len(tv) == N
    idx = np.random.default_rng(1).integers(0, N, size=300)
    for key in (slice(0, 10), slice(2000, 2100), slice(2040, 4200),
                slice(4990, None), slice(10, 5), slice(0, 100, 7), idx,
                (slice(100, 120), slice(2, 5)), 4321):
        same_bytes(np.asarray(jv[key]), np.asarray(tv[key]))
    whole = tsynth.generate(kind, N, D, seed=SEED, chunk_rows=CHUNK,
                            dtype=dtype)
    same_bytes(tv[idx], whole[idx])


def test_dataset_cached_same_file(tmp_path):
    """One cache directory serves both packages: same file name, same bytes."""
    ta, tp = tsynth.dataset_cached("hard", 3000, 16, 5, str(tmp_path / "t"),
                                   "u8")
    ja, jp = jsynth.dataset_cached("hard", 3000, 16, 5, str(tmp_path / "j"),
                                   "u8")
    assert os.path.basename(tp) == os.path.basename(jp)
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    # a second call maps the cached file
    tb, _ = tsynth.dataset_cached("hard", 3000, 16, 5, str(tmp_path / "t"),
                                  "u8")
    same_bytes(np.asarray(ta), np.asarray(tb))


def test_native_hard2_matches_numpy_oracle():
    """The port's own build of ``synth_gen.cc`` (no -march=native) against
    the numpy oracle, with the tolerances of the JAX package's test."""
    d, seed, m, row0 = 48, 917, 8192, 5 << 20
    params = tsynth.make_params("hard2", d, seed)
    centers, scales, w = params
    cdf = np.cumsum(np.asarray(w, np.float64))
    ref_f = tsynth._hard2_chunk_numpy(m, d, seed, row0, params)
    nat_f = native.synth_hard2_chunk(seed, row0, m, d, centers, scales, cdf,
                                     "f32", 12.0)
    np.testing.assert_allclose(nat_f, ref_f, rtol=1e-5, atol=1e-5)
    for dtype in ("u8", "i8"):
        nat = native.synth_hard2_chunk(seed, row0, m, d, centers, scales,
                                       cdf, dtype, 12.0)
        ref = tsynth._quantize_chunk(ref_f.copy(), dtype)
        assert (nat != ref).mean() < 1e-4  # boundary rounding only


def test_native_hard2_rejects_misshaped_params():
    params = tsynth.make_params("hard2", 8, 1)
    cdf = np.cumsum(params[2].astype(np.float64))
    with pytest.raises(ValueError):
        native.synth_hard2_chunk(1, 0, 16, 9, params[0], params[1], cdf,
                                 "f32", 12.0)


def test_hard2_has_no_silent_numpy_path(monkeypatch):
    """A failed native build raises out of ``gen_chunk_typed`` (the JAX
    package falls back to its numpy oracle)."""
    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "library", broken)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        tsynth.gen_chunk_typed("hard2", 64, 8, 1, 0,
                               tsynth.make_params("hard2", 8, 1), "u8")


def test_native_library_is_one_build_of_both_sources():
    names = sorted(os.path.basename(s) for s in native.SOURCES)
    assert names == ["graph_ops.cc", "synth_gen.cc"]
    lib = native.library()
    assert hasattr(lib, "synth_hard2_chunk") and hasattr(lib, "force_balance")
    assert os.path.dirname(native.build()) == native.BUILD_DIR
