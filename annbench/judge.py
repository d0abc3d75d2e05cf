"""The numbers that decide ``correct``, and ``recall_at_10``.

Every number compares what the timed path served with the plain reference
of the configuration's metric (``spec.reference_module``) on a sample of the
window's queries. A smaller distance is nearer, whatever the metric; a
distance may be negative (an inner-product metric's ``1 - q.x``):

- ``routed_miss``: one less the recall of the served ids against the exact
  top-k over the shards that the reference's own routing probes. The
  program serves exactly that search, so only rounding at a routing or a
  k-th-distance tie, and the binned scan's top-2-per-bin cut, may miss.
- ``dist_err``: the widest gap between a served distance and the float64
  distance of the served id, over the reference's scale of the query's
  k-th distance in the whole base (``dist_scale``: for squared L2 the
  distance itself), over the served ids that lie in the base. An id that
  does not go with its distance, or a distance computed in a lower
  precision, shows here.
- ``invalid_lists``: served lists, over the whole window, that hold an id
  outside the base or an id twice. Exact: its limit is 0.

Recall uses the repository's tie rule (``eval.recall.recall_from_ids``): a
served id counts when its exact distance is within ``d_k + 1e-5 + 1e-4
|d_k|`` of the reference's k-th distance ``d_k``, a repeated id once, at
most k a query.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

EPS, REL_EPS = 1e-5, 1e-4


def tie_threshold(kth: torch.Tensor) -> torch.Tensor:
    return kth + EPS + REL_EPS * kth.abs()


def _first_copies(ids: torch.Tensor) -> torch.Tensor:
    """[m, c] bool: the first copy of each id in its row."""
    order = torch.argsort(ids, dim=1, stable=True)
    s = ids.gather(1, order)
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    first = torch.zeros_like(dup)
    first.scatter_(1, order, ~dup)
    return first


def recall(served_ids: torch.Tensor, served_exact: torch.Tensor,
           kth: torch.Tensor, k: int) -> float:
    """recall@k of the served ids (their exact distances given) against the
    k-th distances ``kth`` [m], with the tie rule above."""
    hit = (served_exact <= tie_threshold(kth)[:, None]) & _first_copies(
        served_ids) & (served_ids >= 0)
    return float(hit.sum(1).clamp(max=k).sum()) / (k * served_ids.shape[0])


def dist_err(served_dists: torch.Tensor, served_exact: torch.Tensor,
             scale: torch.Tensor) -> float:
    """max |served - exact| / ``scale`` of the query over the valid ids (an
    invalid one is ``invalid_lists``'s to count); ``scale`` is the
    reference's ``dist_scale`` of the query's k-th distance."""
    gap = (served_dists.double() - served_exact).abs() / scale.double()[:, None]
    gap = gap[torch.isfinite(served_exact)]
    return float(gap.max()) if gap.numel() else 0.0


def invalid_lists(ids_batches: Sequence[np.ndarray], n: int) -> int:
    """Lists that hold an id outside [0, n) or the same id twice."""
    bad = 0
    for ids in ids_batches:
        s = np.sort(ids, axis=1)
        bad += int(((s[:, 0] < 0) | (s[:, -1] >= n)
                    | (s[:, 1:] == s[:, :-1]).any(1)).sum())
    return bad


def checks(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number passes at or below
    its limit."""
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"no reading for {sorted(missing)}")
    return {name: {"value": values[name], "limit": limits[name],
                   "ok": bool(values[name] <= limits[name])}
            for name in limits}
