"""K-means family: random sampling, Lloyd, balanced k-means (counterpart of
``gpann_tpu/cluster/kmeans.py``; reference ``src/kmeans.cpp``).

- Lloyd's assignment step (``kmeans.cpp:12-27``) is one [n, d] x [d, k]
  matmul plus a row argmin on the device, and its aggregation
  (``kmeans.cpp:72-100``) a segment sum; both run in f64 over the f32 points,
  so that near ties, which f32 sums in another order would move, fall the
  same way on the CPU and on CUDA. Every segment sum adds in an order fixed
  on each device (no atomics), so a run repeats itself.
- Balanced k-means keeps the JAX package's design: Lloyd warm start,
  distance-priority capacity assignment, capacity-constrained refinement in
  batched-synchronous mini-batches (a Python loop over device tensors here),
  greedy re-migration (``kmeans.cpp:484-515``).
- Empty clusters keep their previous centroid; MIPS ("spherical") centroids
  are renormalised to unit norm (``kmeans.cpp:85-99``).

The host drivers take numpy in, give numpy out and compute on the ``device``
they are given. Randomness is ``np.random.default_rng(seed)`` where the JAX
package draws it, so both packages see the same samples.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpann_tpu_torch.core.distances import (
    Metric,
    pairwise_distances,
    pos_distance_offset,
    sq_norms,
    to_device,
)

DEFAULT_ROUNDS = 20  # reference kmeans.cpp:228-244


def random_sample(points: np.ndarray, k: int, seed: int = 555) -> np.ndarray:
    """Seeded sample of k distinct rows as initial centroids
    (reference RandomSample, kmeans.cpp:207-226)."""
    n = points.shape[0]
    k = min(k, n)
    idx = np.random.default_rng(seed).choice(n, size=k, replace=False)
    return np.asarray(points[np.sort(idx)], dtype=np.float32)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp(sq_norms(x), min=1e-12))[:, None]


def _segment_sum(values, index, k: int, dtype=torch.float64):
    """Sums of the rows of ``values`` [n, ...] per ``index`` [n] into [k, ...],
    accumulated in ``dtype`` in an order fixed on each device.

    ``index_add_`` adds in index order on the CPU, but with atomics in no
    fixed order on CUDA; there the sums are a [k, n] one-hot matrix times
    the values (a GEMM, whose order is fixed). The sort-based
    ``index_put_(accumulate=True)`` is fixed too, but adds each segment's
    rows one after another, which is slow for a few large segments."""
    values = values.to(dtype)
    if values.device.type == "cuda":
        n = values.shape[0]
        # scatter_ of a scalar: an indexed assignment of 1.0 would copy the
        # scalar from the host, which waits for the device every round
        onehot = torch.zeros((k, n), dtype=dtype, device=values.device)
        onehot.scatter_(0, index.long()[None, :], 1.0)
        return (onehot @ values.reshape(n, -1)).reshape(
            (k,) + tuple(values.shape[1:]))
    out = torch.zeros((k,) + tuple(values.shape[1:]), dtype=dtype)
    return out.index_add_(0, index, values)


def _aggregate(weighted, assignment, k: int, metric: Metric, prev_centroids):
    """Mean of members per cluster from the f64 rows ``weighted`` = [weight *
    point | weight] [n, d+1]: one segment sum gives the sums and the sizes,
    divided in f64 and rounded to f32 once; empty clusters keep the previous
    centroid. Returns centroids [k, d] f32."""
    sw = _segment_sum(weighted, assignment, k)
    sizes = sw[:, -1:]
    means = sw[:, :-1] / torch.clamp(sizes, min=1.0)
    if metric == "mips":
        means = _unit_rows(means)
    return torch.where(sizes > 0, means.float(), prev_centroids)


def _nearest64(points, sq, centroids, metric: Metric):
    """Nearest centroid of each f64 row of ``points`` (``sq``: their squared
    norms) by the distances of :func:`pairwise_distances`, in f64 over f32
    values, so that a near tie falls the same way on every device (f32
    products summed in another order can move it)."""
    c = centroids.double()
    if metric == "mips":
        return (points @ c.T).neg_().add_(1.0).argmin(dim=1)
    d = sq[:, None] + sq_norms(c)[None, :]
    return torch.addmm(d, points, c.T, alpha=-2.0).clamp_(min=0.0).argmin(dim=1)


def _objective(points, centroids, assignment, metric: Metric) -> float:
    dm = pairwise_distances(points, centroids, metric)
    d = dm.gather(1, assignment[:, None].long())
    return float(torch.sum(d + pos_distance_offset(metric)))


def _lloyd(points, init_centroids, k: int, metric: Metric, rounds: int,
           weights=None):
    """``rounds`` Lloyd iterations on device tensors, in f64 arithmetic over
    f32 points and centroids; returns (centroids, assignment int32,
    objective)."""
    p64 = points.double()
    w = (torch.ones(points.shape[0], dtype=torch.float64, device=points.device)
         if weights is None else weights.double())
    weighted = torch.cat([p64 * w[:, None], w[:, None]], dim=1)
    sq = sq_norms(p64) if metric == "l2" else None
    centroids = init_centroids
    for _ in range(rounds):
        assignment = _nearest64(p64, sq, centroids, metric)
        centroids = _aggregate(weighted, assignment, k, metric, centroids)
    assignment = _nearest64(p64, sq, centroids, metric)
    obj = _objective(points, centroids, assignment, metric)
    return centroids, assignment.to(torch.int32), obj


def kmeans(
    points: np.ndarray,
    centroids: Optional[np.ndarray] = None,
    k: Optional[int] = None,
    metric: Metric = "l2",
    rounds: int = DEFAULT_ROUNDS,
    seed: int = 555,
    weights: Optional[np.ndarray] = None,
    *,
    device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd k-means (reference KMeans, kmeans.cpp:228-244).

    ``weights`` (optional, [n] float) weight the centroid aggregation.
    Returns (centroids [k, d] float32, assignment [n] int32).
    """
    points = np.ascontiguousarray(points, dtype=np.float32)
    if centroids is None:
        if k is None:
            raise ValueError("pass either centroids or k")
        sample_pool = points if weights is None else points[weights > 0]
        centroids = random_sample(sample_pool, k, seed)
    k = centroids.shape[0]
    if k == 0 or points.shape[0] == 0:
        return np.asarray(centroids, np.float32), np.zeros(points.shape[0], np.int32)
    w = None if weights is None else to_device(weights, device)
    c, a, _ = _lloyd(to_device(points, device), to_device(centroids, device), k,
                     metric, rounds, w)
    return c.cpu().numpy(), a.cpu().numpy()


def objective_value(points: np.ndarray, centroids: np.ndarray,
                    assignment: np.ndarray, metric: Metric = "l2", *,
                    device) -> float:
    """Sum of (pos-shifted) distances to assigned centroids
    (reference ObjectiveValue, kmeans.cpp:102-116)."""
    return _objective(to_device(points, device), to_device(centroids, device),
                      torch.as_tensor(np.asarray(assignment)).to(device), metric)


# ---------------------------------------------------------------------------
# Balanced k-means (kmeans.cpp:253-515)
# ---------------------------------------------------------------------------


def _balanced_round(points, centroids, assignment, penalty: float,
                    max_size: float, k: int, metric: Metric,
                    num_batches: int):
    """One penalized round over ``num_batches`` mini-batches, each applying
    its moves at once (batched-synchronous).

    Within a mini-batch a point moves to ``argmin_c dist(p, c) + penalty *
    size[c]`` (the BKM+ score, kmeans.cpp:411-455) when that beats staying;
    moves into clusters already at ``max_size`` are masked. Sizes and
    centroids are refreshed before the next mini-batch (update_centroids,
    kmeans.cpp:338-370). Returns (centroids, assignment int64).
    """
    n = points.shape[0]
    dev = points.device
    offset = pos_distance_offset(metric)
    sizes = torch.bincount(assignment, minlength=k).float()
    new_assign = assignment.clone()
    rows = torch.arange(k, device=dev)
    for b in range(num_batches):
        lo, hi = b * n // num_batches, (b + 1) * n // num_batches
        if lo == hi:
            continue
        pts, cur = points[lo:hi], assignment[lo:hi]
        dm = pairwise_distances(pts, centroids, metric) + offset
        cur_d = dm.gather(1, cur[:, None])[:, 0]
        score = dm + penalty * sizes[None, :]
        cur_score = cur_d + penalty * (sizes[cur] - 1.0)  # leaving frees a slot
        # can't move into full clusters; can't "move" to the own cluster
        own = rows[None, :] == cur[:, None]
        full = (sizes >= max_size)[None, :] & ~own
        score = score.masked_fill(full | own, torch.inf)
        best = score.argmin(dim=1)
        do_move = score.gather(1, best[:, None])[:, 0] < cur_score
        new = torch.where(do_move, best, cur)
        delta = (torch.bincount(new, minlength=k)
                 - torch.bincount(cur, minlength=k)).float()
        sizes = sizes + delta
        moved = torch.where(do_move[:, None], pts, 0.0)
        sum_delta = (_segment_sum(moved, new, k, torch.float32)
                     - _segment_sum(moved, cur, k, torch.float32))
        centroids = torch.where(
            sizes[:, None] > 0,
            (centroids * (sizes - delta)[:, None] + sum_delta)
            / torch.clamp(sizes, min=1.0)[:, None],
            centroids)
        if metric == "mips":
            centroids = _unit_rows(centroids)
        new_assign[lo:hi] = new
    return centroids, new_assign


def balanced_kmeans(
    points: np.ndarray,
    k: int,
    eps: float = 0.05,
    metric: Metric = "l2",
    num_batches: int = 32,
    seed: int = 555,
    max_size: Optional[int] = None,
    refine_rounds: int = 20,
    train_sample: Optional[int] = None,
    *,
    device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced k-means: max cluster size <= (1+eps)*ceil(n/k).

    Role of reference BalancedKMeans (kmeans.cpp:253-515), in the JAX
    package's form (see its docstring for why the sequential BKM+ schedule
    is replaced):

    1. Lloyd warm start (on a uniform ``train_sample`` subsample if set).
    2. Distance-priority capacity assignment (:func:`_capacity_priority_assign`).
    3. Capacity-constrained refinement: rounds of "move to a strictly closer
       non-full cluster" (the penalty=0 BKM+ score) while the objective drops.
    4. Greedy re-migration safety net (kmeans.cpp:484-515).

    Returns (centroids, assignment).
    """
    points = np.ascontiguousarray(points, dtype=np.float32)
    n = points.shape[0]
    if max_size is None:
        max_size = int((1.0 + eps) * np.ceil(n / k))
    if train_sample and n > train_sample:
        idx = np.random.default_rng(seed).choice(n, size=train_sample,
                                                 replace=False)
        centroids, _ = kmeans(points[idx], k=k, metric=metric, seed=seed,
                              device=device)
    else:
        centroids, _ = kmeans(points, k=k, metric=metric, seed=seed,
                              device=device)

    assignment = _capacity_priority_assign(points, centroids, max_size, metric,
                                           device=device)
    pts = to_device(points, device)
    cents = to_device(centroids, device)
    asg = torch.as_tensor(assignment).to(device).long()
    best_assignment = assignment
    best_obj = _objective(pts, cents, asg, metric)
    for _ in range(refine_rounds):
        cents, asg = _balanced_round(pts, cents, asg, 0.0, float(max_size), k,
                                     metric, num_batches)
        # several moves of one mini-batch can overfill a cluster
        if int(torch.bincount(asg, minlength=k).max()) > max_size:
            break
        obj = _objective(pts, cents, asg, metric)
        if obj < best_obj - 1e-6 * abs(best_obj):
            best_obj = obj
            best_assignment = asg.to(torch.int32).cpu().numpy()
        else:
            break

    assignment = rebalance_greedy(points, cents.cpu().numpy(), best_assignment,
                                  max_size, metric, device=device)
    centroids_f, _ = _final_centroids(points, assignment, k, metric)
    return centroids_f, assignment


def _capacity_priority_assign(points: np.ndarray, centroids: np.ndarray,
                              max_size: int, metric: Metric,
                              block: int = 1 << 20, *, device) -> np.ndarray:
    """Globally-nearest-first assignment under per-cluster capacity.

    Nearest open centroid per block on the device (8 bytes a point come
    back); admission vectorized on the host (sort by distance, per-cluster
    rank < room). Unplaced points retry against clusters with room.
    """
    from gpann_tpu_torch.cluster.streaming import _masked_nearest

    n = points.shape[0]
    k = centroids.shape[0]
    cents = to_device(centroids, device)
    part = np.full(n, -1, np.int32)
    room = np.full(k, max_size, np.int64)

    def nearest_open(chunk: np.ndarray):
        tgt, db = _masked_nearest(to_device(chunk, device), cents,
                                  torch.as_tensor(room > 0).to(device), metric)
        return tgt.cpu().numpy(), db.cpu().numpy()

    def admit(ids: np.ndarray, target: np.ndarray,
              d_best: np.ndarray) -> np.ndarray:
        prio = np.argsort(d_best, kind="stable")
        by_t = np.argsort(target[prio], kind="stable")
        final = prio[by_t]
        t_fin = target[final]
        within = np.arange(len(final)) - np.searchsorted(t_fin, t_fin)
        ok = within < room[t_fin]
        part[ids[final[ok]]] = t_fin[ok]
        np.subtract.at(room, t_fin[ok], 1)
        return ids[final[~ok]]

    rest_parts = []
    for s in range(0, n, block):
        tgt, db = nearest_open(points[s : s + block])
        rest_parts.append(admit(np.arange(s, min(s + block, n)), tgt, db))
    rest = np.concatenate(rest_parts) if rest_parts else np.empty(0, np.int64)
    while len(rest):
        tgt, db = nearest_open(points[rest])
        rest = admit(rest, tgt, db)
    return part


def rebalance_greedy(points: np.ndarray, centroids: np.ndarray,
                     assignment: np.ndarray, max_size: int,
                     metric: Metric = "l2", *, device) -> np.ndarray:
    """Greedy re-migration of overloaded clusters' points to the closest
    non-full cluster (reference final rebalance, kmeans.cpp:484-515)."""
    assignment = assignment.copy()
    k = centroids.shape[0]
    sizes = np.bincount(assignment, minlength=k)
    over = np.nonzero(sizes > max_size)[0]
    if not len(over):
        return assignment
    dm = pairwise_distances(to_device(points, device),
                            to_device(centroids, device), metric).cpu().numpy()
    for c in over:
        members = np.nonzero(assignment == c)[0]
        # evict the members that lose least by moving
        alt = dm[members].copy()
        alt[:, c] = np.inf
        regret = alt.min(axis=1) - dm[members, c]
        order = members[np.argsort(regret)]
        for p in order:
            if sizes[c] <= max_size:
                break
            for t in np.argsort(dm[p]):
                if t != c and sizes[t] < max_size:
                    assignment[p] = t
                    sizes[t] += 1
                    sizes[c] -= 1
                    break
            else:
                raise RuntimeError("no rebalance target found")  # kmeans.cpp:510
    return assignment


def _final_centroids(points, assignment, k, metric):
    # f64 member sums in index order, as np.add.at adds them (bit-identical),
    # one bincount per dimension: on [315000, 96] into 77 clusters np.add.at
    # took 1.5-1.7 s and this 0.26-0.27 s (numpy 2.0, an 8-core Xeon host)
    sums = np.stack([np.bincount(assignment, weights=points[:, j], minlength=k)
                     for j in range(points.shape[1])], axis=1)
    sizes = np.bincount(assignment, minlength=k)
    cents = (sums / np.maximum(sizes, 1)[:, None]).astype(np.float32)
    if metric == "mips":
        norms = np.sqrt(np.maximum((cents * cents).sum(1), 1e-12))
        cents = cents / norms[:, None]
    return cents, sizes
