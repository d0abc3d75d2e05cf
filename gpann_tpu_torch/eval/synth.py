"""Synthetic dataset generators for the benches and the scale experiments
(counterpart of ``gpann_tpu/eval/synth.py``; numpy and host C++ only).

For the same ``(kind, n, d, seed, dtype, chunk_rows)`` every function here
returns the bytes the JAX package's returns: the shipped artifacts (ground
truth, partition, router) are only valid on exactly that data.

- ``blobs``: the easy 64-Gaussian mixture. Clusters are well separated, so
  a graph partition is near-trivially optimal (oracle recall ~1.0); good for
  smoke and speed runs, useless for comparing methods.
- ``hard``: a deliberately non-separable distribution: fine clusters whose
  centers are themselves drawn from super-clusters (hierarchical overlap),
  anisotropic per-cluster/per-dim scales, heavy-tailed (t-like) noise, and a
  uniform background component. kNN neighborhoods straddle any balanced
  partition's boundaries, so routed recall < 1 at small nprobes and the
  ordering of the partitioners is informative.
- ``hard2``: the same mixture from counter streams (below).

All are chunk-generated with per-chunk seeds: a large base writes straight
into a ``np.lib.format`` memmap without ever materializing in RAM.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _hard_params(d: int, num_clusters: int, num_super: int, seed: int):
    rng = np.random.default_rng([seed, 0xC0FFEE])
    super_centers = rng.standard_normal((num_super, d)) * 3.0
    which_super = rng.integers(0, num_super, size=num_clusters)
    # cluster centers only 1.2 sigma from their super center: heavy overlap
    centers = (super_centers[which_super]
               + 1.2 * rng.standard_normal((num_clusters, d)))
    # anisotropic scales: lognormal per cluster per dim, median ~0.8
    scales = 0.8 * np.exp(0.5 * rng.standard_normal((num_clusters, d)))
    # cluster weights: Zipf-ish skew (real corpora are never uniform)
    w = 1.0 / np.arange(1, num_clusters + 1) ** 0.6
    w /= w.sum()
    return (centers.astype(np.float32), scales.astype(np.float32), w)


def _gen_chunk(kind: str, m: int, d: int, seed: int, chunk_id: int,
               params) -> np.ndarray:
    rng = np.random.default_rng([seed, chunk_id])
    if kind == "blobs":
        centers = params
        lbl = rng.integers(0, len(centers), size=m)
        return (centers[lbl]
                + 0.6 * rng.standard_normal((m, d))).astype(np.float32)
    centers, scales, w = params
    lbl = rng.choice(len(centers), size=m, p=w)
    # t-like heavy tails: normal / sqrt(chi2/df), df=6. All-f32 with in-place
    # ops, so that no [m, d] float64 temporary is allocated.
    pts = rng.standard_normal((m, d), dtype=np.float32)
    chi = (rng.chisquare(6.0, size=(m, 1)).astype(np.float32)) / 6.0
    np.maximum(chi, 1e-6, out=chi)
    np.sqrt(chi, out=chi)
    pts /= chi
    pts *= scales[lbl]
    pts += centers[lbl]
    # 5% uniform background spread over the support
    nbg = int(0.05 * m)
    if nbg:
        bg = rng.uniform(-8.0, 8.0, size=(nbg, d)).astype(np.float32)
        pts[rng.choice(m, size=nbg, replace=False)] = bg
    return pts


def make_params(kind: str, d: int, seed: int,
                num_clusters: int = 1024, num_super: int = 32):
    if kind == "blobs":
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((64, d)).astype(np.float32) * 2.0)
    if kind in ("hard", "hard2"):
        return _hard_params(d, num_clusters, num_super, seed)
    raise ValueError(f"unknown dataset kind {kind!r}")


# --- "hard2": the counter-based fast generator ------------------------------
# Same distribution family as "hard" (identical _hard_params mixture:
# super-clustered anisotropic centers, chi2(6) heavy-tail scale mixture, 5%
# uniform background) but generated from splitmix64 counter streams instead
# of numpy Generator streams. Three properties "hard" lacks:
#   1. it is generated by the native C++ loop (native/src/synth_gen.cc),
#      which fuses generation and quantisation in one pass over a chunk;
#   2. value at row r depends only on (seed, r): bit-identical under any
#      chunking, so stages with different chunk sizes agree by construction;
#   3. a pure-numpy implementation of the *identical* algorithm below serves
#      as the test oracle (same formulas, double precision; the C++ is
#      compiled -ffp-contract=off so both sides round alike; parity tested
#      in tests/test_torch_synth.py). It is no fallback: a failed native
#      build raises.

_SM_C1 = 0x9E3779B97F4A7C15
_SM_C2 = 0xBF58476D1CE4E5B9
_SM_C3 = 0x94D049BB133111EB
_H2_TMUL = 0xD1B54A32D192ED03
_H2_SEEDX = 0x8000000000000001


def _sm64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 arrays (wrapping)."""
    with np.errstate(over="ignore"):
        x = x + np.uint64(_SM_C1)
        z = (x ^ (x >> np.uint64(30))) * np.uint64(_SM_C2)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(_SM_C3)
        return z ^ (z >> np.uint64(31))


def _norm_icdf(p: np.ndarray) -> np.ndarray:
    """Acklam's inverse normal CDF (vectorized; |rel err| < 1.15e-9) —
    mirrors synth_gen.cc::norm_icdf exactly."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    dd = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)
    plow = 0.02425
    q = p - 0.5
    r = q * q
    central = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
                + a[5]) * q
               / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r
                  + 1.0))
    pt = np.minimum(p, 1.0 - p)
    qt = np.sqrt(-2.0 * np.log(np.maximum(pt, 1e-300)))
    tail = (((((c[0] * qt + c[1]) * qt + c[2]) * qt + c[3]) * qt + c[4]) * qt
            + c[5]) / ((((dd[0] * qt + dd[1]) * qt + dd[2]) * qt + dd[3]) * qt
                       + 1.0)
    tail = np.where(p < 0.5, tail, -tail)
    return np.where((p >= plow) & (p <= 1.0 - plow), central, tail)


def _hard2_chunk_numpy(m: int, d: int, seed: int, row0: int,
                       params) -> np.ndarray:
    """Numpy oracle of the hard2 stream (f32 output, before quantisation):
    the algorithm contract synth_gen.cc implements. Used by the tests only."""
    centers, scales, w = params
    S = _sm64(np.uint64(seed) ^ np.uint64(_H2_SEEDX))
    with np.errstate(over="ignore"):
        r = np.uint64(row0) + np.arange(m, dtype=np.uint64)
        rk = _sm64(S ^ (r * np.uint64(_SM_C1)))
        t = np.arange(8 + d, dtype=np.uint64) * np.uint64(_H2_TMUL)
        h = _sm64(rk[:, None] + t[None, :])
    u = ((h >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0 ** -53
    cdf = np.cumsum(w.astype(np.float64))
    lbl = np.searchsorted(cdf, u[:, 0], side="right")
    np.clip(lbl, 0, len(w) - 1, out=lbl)
    z6 = _norm_icdf(u[:, 1:7])
    chi = np.maximum((z6 * z6).sum(axis=1) / 6.0, 1e-6)
    s = 1.0 / np.sqrt(chi)
    bg = u[:, 7] < 0.05
    z = _norm_icdf(u[:, 8:])
    vals = (z * s[:, None]) * scales[lbl].astype(np.float64) \
        + centers[lbl].astype(np.float64)
    vals = np.where(bg[:, None], -8.0 + 16.0 * u[:, 8:], vals)
    return vals.astype(np.float32)


def gen_chunk_typed(kind: str, m: int, d: int, seed: int, chunk_id: int,
                    params, dtype: str = "f32",
                    chunk_rows: int = 1 << 20) -> np.ndarray:
    """Final-dtype chunk. For ``hard2`` the native loop fuses generation
    and quantization in one cache-friendly pass (a failed native build
    raises); other kinds go through the numpy generators.
    ``chunk_rows`` fixes hard2's global row offset (row0 = chunk_id *
    chunk_rows) and must stay constant across the stages of one artifact —
    every caller uses the 1<<20 default."""
    if kind == "hard2":
        centers, scales, w = params
        row0 = chunk_id * chunk_rows
        from gpann_tpu_torch import native

        cdf = np.cumsum(np.asarray(w, np.float64))
        return native.synth_hard2_chunk(seed, row0, m, d, centers, scales,
                                        cdf, dtype, U8_SCALE)
    return _quantize_chunk(_gen_chunk(kind, m, d, seed, chunk_id, params),
                           dtype)


# Byte quantization for SIFT/SPACEV-style bases (the reference stores those
# as .u8bin/.i8bin and widens bytes to f32 at read time, points_io.cpp:
# 114-124). One fixed affine map for the whole dataset: the 'hard' mixture's
# support is ~[-10, 10], so scale 12 uses most of the byte range.
U8_SCALE = 12.0


def _quantize_chunk(pts: np.ndarray, dtype: str) -> np.ndarray:
    """Quantize a float chunk to bytes (DESTROYS ``pts`` in place)."""
    if dtype == "u8":
        np.multiply(pts, U8_SCALE, out=pts)
        pts += 128.0
        np.rint(pts, out=pts)
        np.clip(pts, 0, 255, out=pts)
        return pts.astype(np.uint8)
    if dtype == "i8":
        np.multiply(pts, U8_SCALE, out=pts)
        np.rint(pts, out=pts)
        np.clip(pts, -128, 127, out=pts)
        return pts.astype(np.int8)
    return pts


def generate(
    kind: str, n: int, d: int, seed: int = 555,
    chunk_rows: int = 1 << 20,
    out_path: Optional[str] = None,
    dtype: str = "f32",
) -> np.ndarray:
    """Generate ``[n, d]`` points; memmap-backed when ``out_path`` is given
    (written chunk-by-chunk, O(chunk) RAM). ``dtype``: "f32" | "u8" | "i8" —
    byte dtypes store the quantized values and rely on consumers widening
    chunks to f32 on the fly (all streaming paths do, via
    ``np.asarray(chunk, np.float32)`` — same semantics as the reference's
    byte-widening loader, points_io.cpp:114-124)."""
    params = make_params(kind, d, seed)
    np_dtype = {"f32": np.float32, "u8": np.uint8, "i8": np.int8}[dtype]
    if out_path is None:
        out = np.empty((n, d), np_dtype)
    else:
        out = np.lib.format.open_memmap(
            out_path, mode="w+", dtype=np_dtype, shape=(n, d)
        )
    for ci, s in enumerate(range(0, n, chunk_rows)):
        m = min(chunk_rows, n - s)
        out[s : s + m] = gen_chunk_typed(kind, m, d, seed, ci, params,
                                         dtype, chunk_rows)
    if out_path is not None:
        out.flush()
        return np.load(out_path, mmap_mode="r")
    return out


def generate_queries(kind: str, nq: int, d: int, seed: int = 555,
                     dtype: str = "f32") -> np.ndarray:
    """Queries from the same distribution (chunk id -1 keeps them disjoint
    from every base chunk's stream). For byte dtypes the queries are
    quantized then widened to f32 — the domain the widened base lives in
    (big-ann byte datasets ship byte queries too)."""
    params = make_params(kind, d, seed)
    q = gen_chunk_typed(kind, nq, d, seed, 0x7E57, params, dtype)
    return q.astype(np.float32) if dtype != "f32" else q


class VirtualPoints:
    """Zero-disk array-like over the per-chunk-seeded generator.

    A 1B x 96 u8 base is 96 GB on disk; since every chunk is regenerated
    bit-identically from ``(seed, chunk_id)``, the base need not exist at
    all: ``points[s:e]`` regenerates exactly the chunks the slice covers.
    This is the stand-in for the reference's prefix-read of on-disk
    big-ann files (``points_io.cpp:25-27``): every pipeline stage consumes
    points via row slices, so a regenerating view slots in wherever a
    memmap does.

    ``iid_rows = True`` advertises that rows are exchangeable: a contiguous
    prefix is distributionally identical to a uniform random subsample, so
    samplers may take ``points[:ns]`` instead of fancy-indexing (which would
    regenerate every chunk). Fancy indexing IS supported (retry rounds of
    ``capacity_stream_assign`` use it) at a cost proportional to the number
    of distinct chunks touched.
    """

    iid_rows = True

    def __init__(self, kind: str, n: int, d: int, seed: int = 555,
                 dtype: str = "f32", chunk_rows: int = 1 << 20) -> None:
        self.kind, self.n, self.d, self.seed = kind, n, d, seed
        self.dtype_name = dtype
        self.chunk_rows = chunk_rows
        self.params = make_params(kind, d, seed)
        self.shape = (n, d)
        self.dtype = np.dtype(
            {"f32": np.float32, "u8": np.uint8, "i8": np.int8}[dtype])
        self._cache_id: int = -1
        self._cache: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.n

    def _chunk(self, ci: int) -> np.ndarray:
        if ci != self._cache_id:
            m = min(self.chunk_rows, self.n - ci * self.chunk_rows)
            self._cache = gen_chunk_typed(
                self.kind, m, self.d, self.seed, ci, self.params,
                self.dtype_name, self.chunk_rows,
            )
            self._cache_id = ci
        return self._cache

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            rows = self[idx[0]]
            return rows[(slice(None),) + tuple(idx[1:])]
        if isinstance(idx, slice):
            s, e, step = idx.indices(self.n)
            if step != 1:
                return self[np.arange(s, e, step)]
            if s >= e:
                return np.empty((0, self.d), self.dtype)
            c0, c1 = s // self.chunk_rows, (e - 1) // self.chunk_rows
            if c0 == c1:
                base = c0 * self.chunk_rows
                return self._chunk(c0)[s - base : e - base].copy()
            parts = []
            for ci in range(c0, c1 + 1):
                base = ci * self.chunk_rows
                lo = max(s, base) - base
                hi = min(e, base + self.chunk_rows) - base
                parts.append(self._chunk(ci)[lo:hi])
            return np.concatenate(parts, axis=0)
        idx = np.asarray(idx)
        if idx.ndim == 0:
            return self[int(idx) : int(idx) + 1][0]
        # fancy index: regenerate each touched chunk once, in chunk order
        out = np.empty((len(idx), self.d), self.dtype)
        ci_of = idx // self.chunk_rows
        order = np.argsort(ci_of, kind="stable")
        sorted_ci = ci_of[order]
        bounds = np.nonzero(np.diff(sorted_ci))[0] + 1
        for grp in np.split(np.arange(len(idx)), bounds):
            ci = int(sorted_ci[grp[0]])
            chunk = self._chunk(ci)
            sel = order[grp]
            out[sel] = chunk[idx[sel] - ci * self.chunk_rows]
        return out


def dataset_cached(
    kind: str, n: int, d: int, seed: int = 555,
    cache_dir: Optional[str] = None,
    dtype: str = "f32",
) -> Tuple[np.ndarray, str]:
    """Memmap-backed dataset cached on disk; returns (memmap, path). The
    file name is the JAX package's, so one cache directory serves both."""
    cache_dir = cache_dir or os.path.expanduser("~/.cache/gpann_tpu")
    os.makedirs(cache_dir, exist_ok=True)
    suffix = "" if dtype == "f32" else f"_{dtype}"
    path = os.path.join(cache_dir, f"synth_{kind}_{seed}_{n}x{d}{suffix}.npy")
    if not os.path.exists(path):
        generate(kind, n, d, seed=seed, out_path=path, dtype=dtype)
    return np.load(path, mmap_mode="r"), path
