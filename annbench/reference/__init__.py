"""The plain reference of routed k-NN search (plain PyTorch, TF32 off).

It imports nothing of the program and nothing of JAX. It takes the base, the
queries, the shipped partition (``shard_of``: the shard of each base row) and
the shipped routing points with their shard labels, all as the benchmark
loaded or drew them, and works out everything else itself:

- :func:`route`: the ``min_dist`` probe order. Squared L2 distances to the
  routing points in float64, the ``voting_t`` nearest vote for their shards,
  each shard keeps its nearest vote, shards in the order of that distance
  (the lower index first on a tie, shards without a vote after all that have
  one, by index), the first ``nprobes`` of them.
- :func:`search`: the exact top-k of each query over the whole base and over
  the rows of its probed shards only, in one pass over the base shard by
  shard: float32 matrix products (``|q|^2 + |x|^2 - 2 q.x``) pick ``cand``
  candidates, and their distances are then recomputed in float64 as sums of
  squared differences and sorted.
- :func:`exact_distances`: float64 squared distances of given ids.

``precision="tf32"`` computes the candidates' products in TF32 (on the CPU:
both operands rounded to TF32 first, which is what the tensor cores do) and
skips the float64 step: the reference one precision below the program's,
the control of ``annbench/control.py``.

This package is the reference of the metric ``"l2"``. A configuration of
another metric is judged by the module ``annbench/reference/<metric>.py``
(``spec.reference_module``; there is no list in code), which like this
package imports nothing of the program and nothing of JAX and gives:

- ``reference_answers(queries, base, shard_of, routing_points,
  routing_labels, num_shards, voting_t, nprobes, k, precision="fp32")``:
  the :class:`Result` of this package (``whole`` and ``routed``
  :class:`Neighbours`, each row sorted nearest first, a smaller distance
  nearer), and with ``precision="tf32"`` the control's answers;
- ``exact_distances(queries, base, ids)``: ``[m, c]`` float64 distances of
  ``base[ids]`` to each query under the metric, +inf where an id lies
  outside the base;
- ``dist_scale(queries, base, ids, dists)``: ``[m, c]`` float64, the
  magnitude against which a gap in ``dists`` (the distances of
  ``base[ids]`` to each query) is measured: the size of what a distance is
  computed from, not of a distance that the metric shifts by a constant
  (for ``1 - q.x``, ``|q| |x|``, not ``|1 - q.x|``, which nears 0 wherever
  ``q.x`` nears 1).

``cell.compare`` judges the served answers with them (``dist_err`` over the
``dist_scale`` of each query's k-th neighbour), and ``cell.check_base``
checks the regenerated base against the shipped ground truth's distances
with ``exact_distances`` and ``dist_scale``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

QUERY_BLOCK = 4096


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10-bit mantissa, to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _sq_dists(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """[m, n] ``|q|^2 + |x|^2 - 2 q.x`` in float32 products of ``precision``
    (float64 inputs stay float64)."""
    qq, xx = q, x
    if precision == "tf32" and q.device.type == "cpu":
        qq, xx = _round_tf32(q), _round_tf32(x)
    with _matmul_precision(precision):
        dots = qq @ xx.T
    return (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * dots


def route(queries: torch.Tensor, routing_points: torch.Tensor,
          routing_labels: torch.Tensor, num_shards: int, voting_t: int,
          nprobes: int, precision: str = "fp64") -> torch.Tensor:
    """[m, nprobes] int64 probe order under the ``min_dist`` rule."""
    m = queries.shape[0]
    t = min(voting_t, routing_points.shape[0])
    labels = routing_labels.long()
    out = []
    for s in range(0, m, QUERY_BLOCK):
        q = queries[s : s + QUERY_BLOCK]
        if precision == "fp64":
            dist = _sq_dists(q.double(), routing_points.double(), "fp32")
        else:
            dist = _sq_dists(q, routing_points, precision)
        vd, vi = torch.topk(dist, t, dim=1, largest=False)
        min_d = torch.full((q.shape[0], num_shards), torch.inf,
                           dtype=dist.dtype, device=dist.device)
        min_d.scatter_reduce_(1, labels[vi], vd, reduce="amin")
        out.append(torch.argsort(min_d, dim=1, stable=True)[:, :nprobes])
    return torch.cat(out)


def exact_distances(queries: torch.Tensor, base: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """[m, c] float64 squared distances of ``base[ids]`` to each query; +inf
    where an id lies outside the base."""
    valid = (ids >= 0) & (ids < base.shape[0])
    rows = base[torch.where(valid, ids, 0).long()].double()     # [m, c, d]
    d = ((queries.double()[:, None, :] - rows) ** 2).sum(-1)
    return torch.where(valid, d, torch.inf)


def dist_scale(queries: torch.Tensor, base: torch.Tensor, ids: torch.Tensor,
               dists: torch.Tensor) -> torch.Tensor:
    """The magnitude of each of ``dists``: a squared distance is its own
    scale (a float64 sum of squares, never below +0)."""
    return dists.abs()


class Neighbours(NamedTuple):
    ids: torch.Tensor     # [m, k] int64
    dists: torch.Tensor   # [m, k] squared distances


class Result(NamedTuple):
    whole: Neighbours     # over the whole base
    routed: Neighbours    # over the probed shards only


def _merge(vals, ids, new_vals, new_ids, c: int):
    v = torch.cat([vals, new_vals], dim=1)
    i = torch.cat([ids, new_ids], dim=1)
    v, pos = torch.topk(v, c, dim=1, largest=False)
    return v, i.gather(1, pos)


def search(queries: torch.Tensor, base: torch.Tensor, shard_of: torch.Tensor,
           probes: torch.Tensor, num_shards: int, k: int, cand: int = 64,
           precision: str = "fp32") -> Result:
    """Exact top-``k`` of ``queries`` over ``base`` and over the rows of each
    query's ``probes`` (module docstring). ``shard_of`` [n] gives each base
    row's shard."""
    m, dev = queries.shape[0], queries.device
    c = k if precision == "tf32" else cand
    probed = torch.zeros((m, num_shards), dtype=torch.bool, device=dev)
    probed.scatter_(1, probes.long(), True)
    acc = {key: (torch.full((m, c), torch.inf, device=dev),
                 torch.full((m, c), -1, dtype=torch.int64, device=dev))
           for key in ("whole", "routed")}
    for s in range(num_shards):
        rows = torch.nonzero(shard_of == s).flatten()
        if not rows.numel():
            continue
        x = base[rows]
        cs = min(c, rows.numel())
        for q0 in range(0, m, QUERY_BLOCK):
            q = queries[q0 : q0 + QUERY_BLOCK]
            dist = _sq_dists(q, x, precision)
            v, p = torch.topk(dist, cs, dim=1, largest=False)
            sl = slice(q0, q0 + q.shape[0])
            wv, wi = acc["whole"]
            wv[sl], wi[sl] = _merge(wv[sl], wi[sl], v, rows[p], c)
            sel = torch.nonzero(probed[sl, s]).flatten()
            if sel.numel():
                rv, ri = acc["routed"]
                at = sel + q0
                rv[at], ri[at] = _merge(rv[at], ri[at], v[sel], rows[p[sel]],
                                        c)
    out = {}
    for key, (vals, ids) in acc.items():
        if precision != "tf32":
            vals = exact_distances(queries, base, ids)
        vals, pos = torch.sort(vals, dim=1, stable=True)
        out[key] = Neighbours(ids.gather(1, pos)[:, :k], vals[:, :k])
    return Result(out["whole"], out["routed"])


def reference_answers(queries, base, shard_of, routing_points,
                      routing_labels, num_shards: int, voting_t: int,
                      nprobes: int, k: int, precision: str = "fp32") -> Result:
    """:func:`route` (in float64, or in TF32 for the control) then
    :func:`search`."""
    probes = route(queries, routing_points, routing_labels, num_shards,
                   voting_t, nprobes,
                   "fp64" if precision == "fp32" else precision)
    return search(queries, base, shard_of, probes, num_shards, k,
                  precision=precision)
