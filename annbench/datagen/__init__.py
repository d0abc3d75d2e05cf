"""The benchmark's data: the base, the shipped queries and the query traffic.

The base and the shipped queries are frozen copies of the repository's
generators, so that the benchmark regenerates the bytes that the shipped
partition, routing points and ground truth were built on, whatever a later
change does to the program's own generators:

- ``hard``: ``gpann_tpu_torch/eval/synth.py`` (``_hard_params``,
  ``_gen_chunk``, ``generate``, ``generate_queries``): chunks of
  ``chunk_rows`` rows, each from its own numpy stream ``[seed, chunk]``, so
  the chunks are drawn on several threads at once;
- ``blobs``: ``gpann_tpu_torch/cli/bench.py::_blobs_data``: one sequential
  numpy stream (centres, labels, the base's noise, then the queries). Its
  draws cannot be split, so a second thread only does the arithmetic.

``annbench/tests/test_annbench_datagen.py`` holds the copies byte for byte against
the originals at small sizes. Nothing here writes a file.

The query traffic is not the shipped queries: :func:`device_batches` draws
fresh batches from the same mixture on the device with a ``torch.Generator``
seeded by the run's ``--seed``.

Any other data kind is a module of its own, ``annbench/datagen/<kind>.py``,
found by name (:func:`named`; there is no list in code). It imports nothing
of the program and nothing of JAX, and gives the two functions of this
module without their ``kind`` argument:

- ``base_and_check_queries(n, d, nq, seed)``: the ``[n, d]`` base and the
  ``[nq, d]`` queries that the configuration's shipped ground truth was
  computed on, both float32 numpy arrays in host memory, the same bytes for
  the same arguments;
- ``device_batches(d, base_seed, num_batches, m, seed, device)``:
  ``[num_batches, m, d]`` float32 query traffic drawn on ``device`` from
  ``seed``, the same for the same arguments.

A kind that is neither built in nor such a file raises ``ValueError`` with
the path that was looked for.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from annbench import module_at

HERE = Path(__file__).resolve().parent
BUILT_IN = ("hard", "blobs")   # drawn here; any other kind is named(kind)

HARD_CLUSTERS, HARD_SUPER = 1024, 32
BLOBS_CENTERS = 64
HARD_QUERY_STREAM = 0x7E57   # generate_queries' chunk id
CHUNK_ROWS = 1 << 20
GROUP_ROWS = 1 << 18   # rows of traffic drawn at a time


# -- frozen copies of the program's numpy generators ---------------------------

def hard_params(d: int, seed: int):
    """``synth._hard_params(d, 1024, 32, seed)``: centres, scales, weights."""
    rng = np.random.default_rng([seed, 0xC0FFEE])
    super_centers = rng.standard_normal((HARD_SUPER, d)) * 3.0
    which_super = rng.integers(0, HARD_SUPER, size=HARD_CLUSTERS)
    centers = (super_centers[which_super]
               + 1.2 * rng.standard_normal((HARD_CLUSTERS, d)))
    scales = 0.8 * np.exp(0.5 * rng.standard_normal((HARD_CLUSTERS, d)))
    w = 1.0 / np.arange(1, HARD_CLUSTERS + 1) ** 0.6
    w /= w.sum()
    return centers.astype(np.float32), scales.astype(np.float32), w


def blobs_centers(d: int, seed: int) -> np.ndarray:
    """``synth.make_params("blobs", d, seed)``: the first draw of the blobs
    stream."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((BLOBS_CENTERS, d)).astype(np.float32) * 2.0


def hard_chunk(m: int, d: int, seed: int, chunk_id: int, params) -> np.ndarray:
    """``synth._gen_chunk("hard", ...)``."""
    rng = np.random.default_rng([seed, chunk_id])
    centers, scales, w = params
    lbl = rng.choice(len(centers), size=m, p=w)
    pts = rng.standard_normal((m, d), dtype=np.float32)
    chi = (rng.chisquare(6.0, size=(m, 1)).astype(np.float32)) / 6.0
    np.maximum(chi, 1e-6, out=chi)
    np.sqrt(chi, out=chi)
    pts /= chi
    pts *= scales[lbl]
    pts += centers[lbl]
    nbg = int(0.05 * m)
    if nbg:
        bg = rng.uniform(-8.0, 8.0, size=(nbg, d)).astype(np.float32)
        pts[rng.choice(m, size=nbg, replace=False)] = bg
    return pts


def hard_base(n: int, d: int, seed: int, threads: int = 8) -> np.ndarray:
    """``synth.generate("hard", n, d, seed)`` in host memory, chunks drawn on
    ``threads`` threads (numpy releases the interpreter lock in its fills)."""
    params = hard_params(d, seed)
    out = np.empty((n, d), np.float32)

    def chunk(ci: int) -> None:
        s = ci * CHUNK_ROWS
        m = min(CHUNK_ROWS, n - s)
        out[s : s + m] = hard_chunk(m, d, seed, ci, params)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        for f in [pool.submit(chunk, ci)
                  for ci in range(-(-n // CHUNK_ROWS))]:
            f.result()
    return out


def hard_queries(nq: int, d: int, seed: int) -> np.ndarray:
    """``synth.generate_queries("hard", nq, d, seed)``."""
    return hard_chunk(nq, d, seed, HARD_QUERY_STREAM, hard_params(d, seed))


def blobs_base_and_queries(n: int, d: int, nq: int, seed: int):
    """``bench._blobs_data(n, d, nq, ...)`` in host memory: (base, queries).

    The stream's normal draws run on this thread; a second thread turns each
    drawn chunk into rows (``centres[label] + 0.6 * z`` in float64, stored
    float32, as the original's expression computes it) while the next chunk
    is drawn."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((BLOBS_CENTERS, d)).astype(np.float32) * 2.0
    c64 = centers.astype(np.float64)
    lbl = rng.integers(0, BLOBS_CENTERS, size=n)
    out = np.empty((n, d), np.float32)
    bufs = [np.empty((CHUNK_ROWS, d)), np.empty((CHUNK_ROWS, d))]
    errors: list = []

    def rows(z: np.ndarray, s: int, e: int) -> None:
        try:
            np.multiply(z, 0.6, out=z)
            z += c64[lbl[s:e]]
            out[s:e] = z
        except BaseException as exc:  # re-raised on the drawing thread
            errors.append(exc)
            raise

    worker = None
    for i, s in enumerate(range(0, n, CHUNK_ROWS)):
        e = min(s + CHUNK_ROWS, n)
        z = bufs[i % 2][: e - s]
        rng.standard_normal(out=z)
        if worker is not None:
            worker.join()
        worker = threading.Thread(target=rows, args=(z, s, e))
        worker.start()
    if worker is not None:
        worker.join()
    if errors:
        raise errors[0]
    q = (centers[rng.integers(0, BLOBS_CENTERS, size=nq)]
         + 0.6 * rng.standard_normal((nq, d))).astype(np.float32)
    return out, q


def base_and_check_queries(kind: str, n: int, d: int, nq: int, seed: int):
    """The configuration's base and the shipped ground truth's queries."""
    if kind == "hard":
        return hard_base(n, d, seed), hard_queries(nq, d, seed)
    if kind == "blobs":
        return blobs_base_and_queries(n, d, nq, seed)
    return named(kind).base_and_check_queries(n, d, nq, seed)


def named(kind: str):
    """The module ``annbench/datagen/<kind>.py`` of a kind that is not built
    in (module docstring); ``ValueError`` with the path where there is
    none."""
    path = HERE / f"{kind}.py"
    if not path.exists():
        raise ValueError(f"unknown data kind {kind!r}: no module at {path}")
    return module_at(path)


# -- the traffic: fresh draws from the same mixture, on the device -------------

def device_batches(kind: str, d: int, base_seed: int, num_batches: int,
                   m: int, seed: int, device) -> torch.Tensor:
    """[num_batches, m, d] float32 queries drawn on ``device`` from the
    configuration's mixture (parameters from ``base_seed``) with a
    ``torch.Generator`` seeded by ``seed``, ``GROUP_ROWS`` rows at a time so
    that the draw's temporaries stay small.

    ``hard``: a cluster by the mixture's weights, a normal draw over the
    square root of a chi-square(6) / 6 draw (the sum of six squared normals),
    times the cluster's scales plus its centre; ``int(0.05 * m)`` rows of
    each batch, chosen without replacement, uniform on [-8, 8). ``blobs``: a
    uniform centre plus 0.6 times a normal draw."""
    if kind not in BUILT_IN:
        return named(kind).device_batches(d, base_seed, num_batches, m, seed,
                                          device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    if kind == "blobs":
        centers = torch.as_tensor(blobs_centers(d, base_seed), device=device)
    else:
        centers, scales, w = (torch.as_tensor(a, device=device)
                              for a in hard_params(d, base_seed))
        w = w.to(torch.float32)
    out = torch.empty((num_batches, m, d), dtype=torch.float32, device=device)
    group = max(1, GROUP_ROWS // m)
    for b0 in range(0, num_batches, group):
        nb = min(group, num_batches - b0)
        rows = nb * m
        pts = out[b0 : b0 + nb].view(rows, d)
        if kind == "blobs":
            lbl = torch.randint(0, BLOBS_CENTERS, (rows,), generator=g,
                                device=device)
            torch.randn((rows, d), generator=g, device=device, out=pts)
            pts.mul_(0.6).add_(centers[lbl])
            continue
        lbl = torch.multinomial(w, rows, replacement=True, generator=g)
        torch.randn((rows, d), generator=g, device=device, out=pts)
        chi = torch.randn((rows, 6), generator=g, device=device)
        chi = (chi.square_().sum(1) / 6.0).clamp_(min=1e-6).sqrt_()
        pts.div_(chi[:, None]).mul_(scales[lbl]).add_(centers[lbl])
        nbg = int(0.05 * m)
        if nbg:
            sel = torch.rand((nb, m), generator=g,
                             device=device).argsort(dim=1)[:, :nbg]
            bg = torch.rand((nb, nbg, d), generator=g,
                            device=device).mul_(16.0).sub_(8.0)
            out[b0 : b0 + nb].scatter_(1, sel[:, :, None].expand(-1, -1, d),
                                       bg)
    return out
