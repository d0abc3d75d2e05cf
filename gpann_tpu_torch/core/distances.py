"""Batched fp32 distance helpers (counterpart of ``gpann_tpu/core/distances.py``).

    L2^2(q, x) = |q|^2 + |x|^2 - 2 q.x
    MIPS(q, x) = 1 - q.x

The metric is a runtime argument, as in the JAX package.

The tensor functions compute on the device of their inputs. The host drivers
(:func:`chunked_topk_neighbors`, :func:`streaming_topk_neighbors`) take numpy
in, give numpy out and compute on the ``device`` they are given.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Metric = str  # "l2" | "mips"

_METRICS = ("l2", "mips")

# Precision policy: every ranking matmul runs in full fp32. TF32 keeps a
# 10-bit mantissa, and |q|^2 + |x|^2 - 2 q.x cancels catastrophically at that
# precision (the JAX package measured recall@10 0.59 for plain bf16 ranking,
# docs/PERF.md). Both flags are set explicitly rather than trusting defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def _check_metric(metric: Metric) -> None:
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {_METRICS}")


def to_device(x, device) -> torch.Tensor:
    """``x`` (numpy, memmap slice or tensor) as an f32 tensor on ``device``.

    Byte arrays (u8/i8 bases) are uploaded raw and widened on the device, as
    the JAX package does."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:  # torch.from_numpy warns on read-only arrays
            x = x.copy()
        x = torch.from_numpy(x)
    return x.to(device).float()


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared norms, shape [n]."""
    return torch.sum(x * x, dim=-1)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize to unit L2 norm (reference L2Normalize, dist.cpp:60-67)."""
    return x * torch.rsqrt(torch.clamp(sq_norms(x), min=eps))[..., None]


def pos_distance_offset(metric: Metric) -> float:
    """Additive shift making distances non-negative (dist.cpp:83-88)."""
    return 1.0 if metric == "mips" else 0.0


def pairwise_distances(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: Metric = "l2",
) -> torch.Tensor:
    """Dense [m, n] distance matrix between queries [m, d] and base [n, d].

    The L2 form peaks at two [m, n] buffers (in-place updates, in the JAX
    package's order of operations)."""
    _check_metric(metric)
    queries = queries.float()
    base = base.float()
    dots = queries @ base.T
    if metric == "mips":
        return dots.neg_().add_(1.0)
    d = sq_norms(queries)[:, None] + sq_norms(base)[None, :]
    return d.sub_(dots.mul_(2.0)).clamp_(min=0.0)


def topk_smallest(x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of ``x`` along its last dimension and their
    positions, ascending, equal values in ascending position: the order of
    ``jax.lax.top_k``. ``torch.topk`` picks among equal values in no fixed
    order, and on byte data, whose L2 distances are exact integers, equal
    values are common (ROADMAP C12)."""
    kth = torch.topk(x, k, dim=-1, largest=False).values[..., -1:]
    n = x.shape[-1]
    # besides x, at most two bool masks and one int32 array of its size
    less = x < kth
    need = k - less.sum(-1, keepdim=True, dtype=torch.int32)
    ties = x == kth
    # take: every smaller entry, and the first ``need`` equal ones
    take = torch.cumsum(ties, -1, dtype=torch.int32).le_(need).logical_and_(
        ties).logical_or_(less)
    del less, ties
    # key: a taken entry's position, n elsewhere (in place, int32)
    key = take.int().mul_(torch.arange(n, dtype=torch.int32,
                                       device=x.device) - n).add_(n)
    del take
    # the k taken positions, ascending; then ordered by value, stably
    idx = torch.topk(key, k, dim=-1, largest=False).values.long()
    del key
    vals = x.gather(-1, idx)
    vals, order = torch.sort(vals, dim=-1, stable=True)
    return vals, idx.gather(-1, order)


def topk_neighbors(
    queries: torch.Tensor,
    base: torch.Tensor,
    k: int,
    metric: Metric = "l2",
    block_rows: int = 65536,
    n_valid=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbors of each query in ``base``.

    Returns ``(dists [m, k] f32, ids [m, k] int32)`` sorted ascending. The
    base is streamed in ``block_rows`` chunks with a running top-k merge, so
    the [m, n] matrix is never materialized. Rows ``>= n_valid`` are padding
    and are masked to +inf before selection.
    """
    _check_metric(metric)
    queries = queries.float()
    base = base.float()
    m = queries.shape[0]
    n = base.shape[0]
    dev = queries.device
    if n <= block_rows:
        dm = pairwise_distances(queries, base, metric)
        if n_valid is not None:
            live = torch.arange(n, device=dev) < n_valid
            dm = torch.where(live[None, :], dm, torch.inf)
        kk = min(k, n)
        vals, ids = torch.topk(dm, kk, dim=1, largest=False)
        if kk < k:  # pad (callers use masks / n >= k in practice)
            vals = torch.cat([vals, vals.new_full((m, k - kk), torch.inf)], 1)
            ids = torch.cat([ids, ids.new_full((m, k - kk), n)], 1)
        return vals, ids.to(torch.int32)

    limit = n if n_valid is None else n_valid
    q_sq = sq_norms(queries) if metric == "l2" else None
    vals = torch.full((m, k), torch.inf, device=dev)
    idx = torch.full((m, k), n, dtype=torch.int64, device=dev)
    for start in range(0, n, block_rows):
        blk = base[start : start + block_rows]
        dots = queries @ blk.T
        if metric == "mips":
            dm = 1.0 - dots
        else:
            dm = q_sq[:, None] + sq_norms(blk)[None, :] - 2.0 * dots
        live = (start + torch.arange(blk.shape[0], device=dev)) < limit
        dm = torch.where(live[None, :], dm, torch.inf)
        nv, npos = torch.topk(dm, min(k, blk.shape[0]), dim=1, largest=False)
        cat_v = torch.cat([vals, nv], 1)
        cat_i = torch.cat([idx, npos + start], 1)
        vals, pos = torch.topk(cat_v, k, dim=1, largest=False)
        idx = torch.gather(cat_i, 1, pos)
    if metric == "l2":
        vals = torch.clamp(vals, min=0.0)
    return vals, idx.to(torch.int32)


def assign_closest(points: torch.Tensor, centers: torch.Tensor,
                   metric: Metric = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 assignment: for each point, (distance to, index of) its nearest
    center (reference kmeans.cpp:12-27). Ties go to the lowest index, as
    ``jnp.argmin``."""
    dm = pairwise_distances(points, centers, metric)
    idx = torch.argmin(dm, dim=1)
    return dm.gather(1, idx[:, None])[:, 0], idx


def chunked_topk_neighbors(queries, base, k: int, metric: Metric = "l2",
                           query_block: int = 8192, block_rows: int = 65536,
                           *, device) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k of every query, the queries streamed in ``query_block``
    blocks through :func:`topk_neighbors` on ``device``; the base is uploaded
    once. Returns numpy ``(dists [m, k] f32, ids [m, k] int32)``."""
    base_t = to_device(base, device)
    outs_d, outs_i = [], []
    for s in range(0, queries.shape[0], query_block):
        d, i = topk_neighbors(to_device(queries[s : s + query_block], device),
                              base_t, k, metric=metric, block_rows=block_rows)
        outs_d.append(d.cpu().numpy())
        outs_i.append(i.cpu().numpy())
    if not outs_d:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
    return np.concatenate(outs_d), np.concatenate(outs_i)


def streaming_topk_neighbors(queries, base, k: int, metric: Metric = "l2",
                             base_chunk: int = 1 << 21,
                             query_block: int = 8192, *, device
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k when the base exceeds device memory: host-resident base
    chunks (numpy or memmap) go through the device one at a time and the
    per-chunk top-k lists are merged on the host. Returns numpy
    ``(dists [m, k] f32, ids [m, k] int64)``."""
    n, m = base.shape[0], queries.shape[0]
    best_d = np.full((m, k), np.inf, np.float32)
    best_i = np.full((m, k), -1, np.int64)
    for s in range(0, n, base_chunk):
        blk = np.asarray(base[s : s + base_chunk])
        d, i = chunked_topk_neighbors(queries, blk, min(k, len(blk)),
                                      metric=metric, query_block=query_block,
                                      device=device)
        if d.shape[1] < k:
            d = np.pad(d, ((0, 0), (0, k - d.shape[1])), constant_values=np.inf)
            i = np.pad(i, ((0, 0), (0, k - i.shape[1])), constant_values=-1)
        cat_d = np.concatenate([best_d, d], axis=1)
        cat_i = np.concatenate([best_i, i.astype(np.int64) + s], axis=1)
        sel = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(cat_d, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    return best_d, best_i
