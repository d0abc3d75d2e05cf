"""Balanced multilevel graph partitioner, the KaMinPar replacement
(counterpart of ``gpann_tpu/gp/lp.py``; reference call site
``PartitionGraphWithKaMinPar``, ``src/partitioning.cpp:172-199``).

1. **Coarsening** (host): repeated heavy-edge mutual matching
   (:func:`gpann_tpu_torch.native.heavy_edge_matching`); node weights and
   edge multiplicities accumulate. Stops near ``coarse_target`` nodes.
2. **Initial partition** (host): greedy BFS region growing from k spread
   seeds on the coarsest graph (:func:`gpann_tpu_torch.native.bfs_grow_partition`).
3. **Refinement** (device): size-constrained label propagation. Each round
   computes every node's affinity to each of the k parts (one accumulating
   ``index_put_`` over the edges), the gain against its current part, and
   admits moves by gain priority under the per-part weight budget (sort by
   (target, -gain), segmented cumulative weight <= remaining capacity).
   Rounds alternate over random node subsets against oscillation. A
   capacity-repair pass (:func:`gpann_tpu_torch.native.force_balance`)
   follows each level.

Edge and node weights are small integers held in f32, so every sum is exact
and the part ids do not depend on the order of summation: on the CPU the
port returns the JAX package's part ids. The partitioner is deterministic
given ``seed``.

The numpy functions ``*_plain`` are the plain versions of the three native
ops. As in the JAX package, the partitioner takes the plain initial
partition or balance pass only when the native one leaves a node unassigned
or a part over capacity; the plain matching serves the tests.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from gpann_tpu_torch import native

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Device: size-constrained LP refinement
# ---------------------------------------------------------------------------


def _refine_round(u, v, w, part, node_w, cap, active, k: int) -> torch.Tensor:
    """One LP round on device tensors. Returns the new partition.

    u, v, w      — directed edge list (both directions present), weights f32
    part         — [n] int64 current parts
    node_w       — [n] f32 node weights
    cap          — f32 scalar tensor, max part weight
    active       — [n] bool, nodes allowed to move this round
    """
    n = part.shape[0]
    dev = part.device
    rows = torch.arange(n, device=dev)
    aff = torch.zeros((n, k), device=dev).index_put_(
        (u, part[v]), w, accumulate=True)
    own = aff.gather(1, part[:, None])[:, 0]
    aff[rows, part] = -torch.inf  # block moving into the own part
    target = aff.argmax(dim=1)  # first maximum, as jnp.argmax
    gain = aff.gather(1, target[:, None])[:, 0] - own

    sizes = torch.zeros(k, device=dev).index_add_(0, part, node_w)
    room = cap - sizes  # capacity left per part (conservative: ignores outflow)

    want = active & (gain > 0)
    # sort by gain desc (stable), then by target (stable): within a target,
    # nodes come in descending gain order
    by_gain = torch.argsort(-torch.where(want, gain, -torch.inf), stable=True)
    by_target = torch.argsort(target[by_gain], stable=True)
    order = by_gain[by_target]
    t_ord = target[order]
    w_ord = torch.where(want[order], node_w[order], 0.0)
    cum = torch.cumsum(w_ord, dim=0)
    # start-of-group cumulative weight per target part
    first_in_group = torch.ones(n, dtype=torch.bool, device=dev)
    first_in_group[1:] = t_ord[1:] != t_ord[:-1]
    group_base = torch.where(first_in_group, cum - w_ord, 0.0)
    group_base = torch.cummax(group_base, dim=0).values
    within = cum - group_base
    admit_ord = want[order] & (within <= room[t_ord])
    admit = torch.zeros(n, dtype=torch.bool, device=dev)
    admit[order] = admit_ord
    return torch.where(admit, target, part)


def _edge_cut(u, v, w, part) -> float:
    """Total weight of cut edges (each undirected edge counted once), summed
    in f64."""
    return float(torch.where(part[u] != part[v], w, 0.0).double().sum()) / 2.0


def refine(u: np.ndarray, v: np.ndarray, w: np.ndarray, part: np.ndarray,
           node_w: np.ndarray, k: int, cap: float, rounds: int = 12,
           seed: int = 555, *, device) -> np.ndarray:
    """Run LP refinement rounds on ``device``; keeps the best feasible cut."""
    ut = torch.as_tensor(np.asarray(u, np.int64)).to(device)
    vt = torch.as_tensor(np.asarray(v, np.int64)).to(device)
    wt = torch.as_tensor(np.asarray(w, np.float32)).to(device)
    nw = torch.as_tensor(np.asarray(node_w, np.float32)).to(device)
    pt = torch.as_tensor(np.asarray(part, np.int64)).to(device)
    cap_t = torch.tensor(cap, dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    n = len(part)
    best = np.asarray(part, np.int32)
    best_cut = _edge_cut(ut, vt, wt, pt)
    stale = 0
    for r in range(rounds):
        frac = 1.0 if r < 2 else 0.7  # damp later rounds against oscillation
        active = torch.as_tensor(rng.random(n) < frac).to(device)
        pt = _refine_round(ut, vt, wt, pt, nw, cap_t, active, k)
        cut = _edge_cut(ut, vt, wt, pt)
        if cut < best_cut - 1e-9:
            best_cut = cut
            best = pt.to(torch.int32).cpu().numpy()
            stale = 0
        else:
            stale += 1
            if stale >= 3:
                break
    return best


# ---------------------------------------------------------------------------
# Host: coarsening by mutual heavy-edge matching
# ---------------------------------------------------------------------------


def _heaviest_neighbor(u, v, w, n, rng):
    """For each node, its heaviest neighbor (random tie-break)."""
    jitter = rng.random(len(w)).astype(np.float32) * 1e-3
    order = np.lexsort((w + jitter, u))  # per-u ascending weight; last = max
    uu, vv = u[order], v[order]
    last = np.zeros(len(uu), dtype=bool)
    last[:-1] = uu[:-1] != uu[1:]
    last[-1] = True
    h = np.full(n, -1, dtype=np.int64)
    h[uu[last]] = vv[last]
    return h


def _matching_plain(u, v, w, node_w, max_node_w, rng) -> np.ndarray:
    """Plain numpy version of :func:`native.heavy_edge_matching` (other
    random tie-breaks): partner[i] = matched partner or i."""
    n = len(node_w)
    idx = np.arange(n)
    h = _heaviest_neighbor(u, v, w, n, rng)
    ok = (h >= 0) & (h[h.clip(min=0)] == idx)  # mutual
    partner = np.where(ok, h, idx)
    # avoid over-heavy contracted nodes
    too_heavy = node_w + node_w[partner.clip(min=0)] > max_node_w
    return np.where(too_heavy, idx, partner)


def _csr_from_sorted_coo(u, v, n):
    """CSR indptr for a COO edge list already sorted by u."""
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=n), out=indptr[1:])
    return indptr


def coarsen_once(u, v, w, node_w, max_node_w, rng):
    """One mutual-matching contraction (native matcher). Returns (mapping
    [n] -> coarse id, coarse u/v/w, coarse node weights)."""
    n = len(node_w)
    idx = np.arange(n)
    indptr = _csr_from_sorted_coo(u, v, n)
    partner = native.heavy_edge_matching(indptr, v, w, node_w, max_node_w,
                                         rng.integers(2**62))
    rep = np.minimum(idx, partner)
    mapping = np.full(n, -1, dtype=np.int64)
    roots = rep == idx
    mapping[roots] = np.arange(int(roots.sum()))
    mapping = mapping[rep]  # followers inherit their root's coarse id
    nc = int(roots.sum())

    cu, cv = mapping[u], mapping[v]
    keep = cu != cv
    cu, cv, cw = cu[keep], cv[keep], w[keep]
    key = cu * nc + cv
    uniq, inv = np.unique(key, return_inverse=True)
    agg_w = np.zeros(len(uniq), np.float32)
    np.add.at(agg_w, inv, cw)
    cu = (uniq // nc).astype(np.int64)
    cv = (uniq % nc).astype(np.int64)
    cnw = np.zeros(nc, np.float64)
    np.add.at(cnw, mapping, node_w)
    return mapping, cu, cv, agg_w, cnw.astype(np.float32)


def _initial_partition(u, v, w, node_w, k, cap, rng):
    """Greedy balanced region growing on the coarsest graph (native; the
    plain version if the native one leaves a node unassigned)."""
    indptr = _csr_from_sorted_coo(u, v, len(node_w))
    part = native.bfs_grow_partition(indptr, v, node_w, k, cap,
                                     rng.integers(2**62))
    if (part >= 0).all():
        return part
    return _initial_partition_plain(u, v, w, node_w, k, cap, rng)


def _initial_partition_plain(u, v, w, node_w, k, cap, rng):
    """Plain Python version of :func:`native.bfs_grow_partition` (another
    seeding and growth order)."""
    n = len(node_w)
    part = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(k, np.float64)
    # spread seeds: random start, then farthest-by-BFS-hops heuristic
    adj_order = np.lexsort((v, u))
    su, sv = u[adj_order], v[adj_order]
    starts = np.searchsorted(su, np.arange(n + 1))
    seeds = [int(rng.integers(n))]
    dist = np.full(n, np.inf)
    for _ in range(k - 1):
        frontier = [seeds[-1]]
        dist[seeds[-1]] = 0
        dd = 0
        while frontier:
            dd += 1
            nxt = []
            for node in frontier:
                for e in range(starts[node], starts[node + 1]):
                    t = sv[e]
                    if dist[t] > dd:
                        dist[t] = dd
                        nxt.append(t)
            frontier = nxt
        far = int(np.argmax(np.where(np.isinf(dist), -1, dist)))
        if dist[far] <= 0 or far in seeds:
            far = int(rng.integers(n))
        seeds.append(far)
    for p, s in enumerate(seeds):
        if part[s] == -1:
            part[s] = p
            sizes[p] += node_w[s]
    # greedy BFS growth: repeatedly grow the lightest part
    frontiers = {p: set() for p in range(k)}
    for p in range(k):
        for s in np.nonzero(part == p)[0]:
            for e in range(starts[s], starts[s + 1]):
                if part[sv[e]] == -1:
                    frontiers[p].add(int(sv[e]))
    unassigned = int((part == -1).sum())
    while unassigned > 0:
        p = int(np.argmin(np.where(sizes <= cap, sizes, np.inf)))
        cands = [c for c in frontiers[p] if part[c] == -1]
        c = cands[0] if cands else int(np.nonzero(part == -1)[0][0])
        part[c] = p
        sizes[p] += node_w[c]
        frontiers[p].discard(c)
        for e in range(starts[c], starts[c + 1]):
            if part[sv[e]] == -1:
                frontiers[p].add(int(sv[e]))
        unassigned -= 1
    return part


def _force_balance(u, v, w, part, node_w, k, cap):
    """Post-pass: move lowest-affinity nodes out of overweight parts (native;
    the plain version if the native one leaves a part over ``cap``)."""
    indptr = _csr_from_sorted_coo(u, v, len(part))
    out = native.force_balance(indptr, v, w, node_w, k, cap, part)
    sizes = np.zeros(k)
    np.add.at(sizes, out, node_w)
    if sizes.max() <= cap + 1e-6:
        return out
    return _force_balance_plain(u, v, w, part, node_w, k, cap)


def _force_balance_plain(u, v, w, part, node_w, k, cap):
    """Plain numpy version of :func:`native.force_balance` (another eviction
    order)."""
    n = len(part)
    sizes = np.zeros(k, np.float64)
    np.add.at(sizes, part, node_w)
    if (sizes <= cap).all():
        return part
    aff = np.zeros((n, k), np.float32)
    np.add.at(aff, (u, part[v]), w)
    part = part.copy()
    for p in np.argsort(-sizes):
        while sizes[p] > cap:
            members = np.nonzero(part == p)[0]
            # evict members with least affinity to p, preferring targets w/ room
            order = members[np.argsort(aff[members, p])]
            moved = False
            for node in order[: max(1, len(order) // 4)]:
                for t in np.argsort(-aff[node]):
                    if t != p and sizes[t] + node_w[node] <= cap:
                        part[node] = t
                        sizes[t] += node_w[node]
                        sizes[p] -= node_w[node]
                        moved = True
                        break
                if sizes[p] <= cap:
                    break
            if not moved:
                # fallback: dump into the globally lightest part
                node = order[0]
                t = int(np.argmin(sizes))
                part[node] = t
                sizes[t] += node_w[node]
                sizes[p] -= node_w[node]
    return part


def partition_graph(
    indptr: np.ndarray,
    indices: np.ndarray,
    edge_weights: Optional[np.ndarray],
    k: int,
    eps: float = 0.05,
    node_weights: Optional[np.ndarray] = None,
    seed: int = 555,
    coarse_target_per_part: int = 64,
    refine_rounds: int = 12,
    *,
    device,
) -> np.ndarray:
    """Multilevel eps-balanced k-way partition of a symmetric CSR graph.

    Role of ``PartitionGraphWithKaMinPar`` (partitioning.cpp:172-199).
    Returns [n] int32 part ids with max part weight <= (1+eps)*ceil(W/k).
    """
    n = len(indptr) - 1
    if n == 0:
        return np.zeros(0, np.int32)
    if n <= k:
        return np.arange(n, dtype=np.int32)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    v = indices.astype(np.int64)
    w = (np.ones(len(v), np.float32) if edge_weights is None
         else np.asarray(edge_weights, np.float32))
    node_w = (np.ones(n, np.float32) if node_weights is None
              else np.asarray(node_weights, np.float32))
    total_w = float(node_w.sum())
    cap = (1.0 + eps) * np.ceil(total_w / k)

    # -- coarsen ------------------------------------------------------------
    # each entry: (mapping fine->coarse, fine-level edges + node weights)
    levels: list = []
    cu, cv, cw, cnw = u, v, w, node_w
    coarse_target = max(coarse_target_per_part * k, 256)
    max_node_w = cap / 4  # keep coarse nodes refinable
    while len(cnw) > coarse_target:
        mapping, nu, nv, nw_, nnw = coarsen_once(cu, cv, cw, cnw, max_node_w, rng)
        if len(nnw) >= len(cnw) * 0.98 or len(nu) == 0:
            break  # matching stalled (e.g. star graphs)
        levels.append((mapping, cu, cv, cw, cnw))
        cu, cv, cw, cnw = nu, nv, nw_, nnw
    t1 = time.perf_counter()

    # -- initial partition on coarsest level ---------------------------------
    part = _initial_partition(cu, cv, cw, cnw, k, cap, rng)
    part = refine(cu, cv, cw, part, cnw, k, cap, rounds=refine_rounds,
                  seed=seed, device=device)
    part = _force_balance(cu, cv, cw, part, cnw, k, cap)

    # -- uncoarsen + refine ----------------------------------------------------
    for mapping, fu, fv, fw, fnw in reversed(levels):
        part = part[mapping]
        part = refine(fu, fv, fw, part, fnw, k, cap, rounds=refine_rounds,
                      seed=seed + len(fnw), device=device)
        part = _force_balance(fu, fv, fw, part, fnw, k, cap)
    log.info("partition_graph: %d nodes, %d levels; coarsen %.3f s, "
             "initial + refine + balance %.3f s", n, len(levels), t1 - t0,
             time.perf_counter() - t1)
    return part.astype(np.int32)
