"""The exact shard scan and the exact rescore that every engine shares.

A block of queries meets its shard as one fp32 matmul with the per-row bias
(|x|^2 or 1, +inf past the shard's size) in the GEMM, a top-k and an exact
f32 rescore (:func:`blocks_topk`). :func:`exact_distances` is the one copy
of the rescore's candidate distance: the bin-top-2 scan's phase 3
(``search/bin_scan.py``) and the ``rescore`` vote of the routing
(``search/serve.py::_probe_rank``) call it too. This module imports only
``core``. Each scan step holds f32 distance tiles of at most ``TILE_BYTES``.
"""

from __future__ import annotations

import torch

from gpann_tpu_torch.core.distances import Metric, sq_norms

# device bytes of one [rows, capacity] f32 distance tile
TILE_BYTES = 1 << 30


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def scan_k(k: int, cap: int, rescore: bool) -> int:
    """Candidate count for the scan phase."""
    return min(max(k, 16) if rescore else k, cap)


def blocks_per_step(cap: int, qb: int, dim: int) -> int:
    """Blocks of ``qb`` query rows per :func:`blocks_topk` call: their
    tiles and gathered ``[cap, dim]`` windows stay under ``TILE_BYTES``."""
    return max(1, TILE_BYTES // (4 * cap * (qb + dim)))


def exact_distances(q: torch.Tensor, cand: torch.Tensor,
                    metric: Metric) -> torch.Tensor:
    """Distances [m, c] of queries ``q`` [m, d] to their own candidate rows
    ``cand`` [m, c, d], computed directly in f32."""
    if metric == "mips":
        return 1.0 - torch.einsum("md,mcd->mc", q, cand)
    return ((q[:, None, :] - cand) ** 2).sum(-1)


def exact_rescore(qs: torch.Tensor, block: torch.Tensor, scan_d: torch.Tensor,
                  pos: torch.Tensor, k: int, metric: Metric):
    """Exact f32 re-ranking of scanned candidates.

    Gathers the candidate rows ``block[pos]`` [m, K, d], recomputes their
    distances (:func:`exact_distances`) and keeps the best k. Masked (inf)
    scan entries stay masked. Returns (dists [m, k], positions-in-block
    [m, k])."""
    exact = exact_distances(qs, block[pos], metric)
    exact = torch.where(torch.isfinite(scan_d), exact, torch.inf)
    d, sel = torch.topk(exact, k, dim=1, largest=False)
    return d, pos.gather(1, sel)


def shard_bias(shard_points: torch.Tensor, shard_sizes: torch.Tensor,
               metric: Metric) -> torch.Tensor:
    """The scan's per-row bias [s, cap]: |x|^2 (L2) or 1 (MIPS), +inf on
    rows past a shard's size. A row ranks by bias + alpha * q.x."""
    s, cap = shard_points.shape[:2]
    dev = shard_points.device
    live = torch.arange(cap, device=dev)[None, :] < shard_sizes[:, None]
    bias = (sq_norms(shard_points) if metric == "l2"
            else torch.ones((s, cap), device=dev))
    return bias.masked_fill_(~live, torch.inf)


def blocks_topk(qs: torch.Tensor, block: torch.Tensor, bias: torch.Tensor,
                ids: torch.Tensor, k: int, metric: Metric, rescore: bool):
    """Top-k of query blocks ``qs`` [c, r, d], block j against shard rows
    ``block[j]`` [cap, d] with their bias [c, cap] and global ids [c, cap]:
    (dists [c, r, k], global ids [c, r, k])."""
    c, r, dim = qs.shape
    cap = block.shape[1]
    # one pass over the [c, r, cap] tile: the bias rides in the GEMM
    dm = torch.baddbmm(bias[:, None, :], qs, block.transpose(1, 2),
                       alpha=-1.0 if metric == "mips" else -2.0)
    d, pos = torch.topk(dm, scan_k(k, cap, rescore), dim=2, largest=False)
    del dm
    if metric == "l2":
        # |q|^2 is constant along a row: added to the kept entries only
        d = d + sq_norms(qs)[:, :, None]
    # positions in the c blocks laid end to end
    pos = (pos + (torch.arange(c, device=qs.device) * cap)[:, None, None]
           ).view(c * r, -1)
    d = d.view(c * r, -1)
    if rescore:
        d, pos = exact_rescore(qs.reshape(c * r, dim),
                               block.reshape(c * cap, dim), d, pos, k, metric)
    else:
        d, pos = d[:, :k], pos[:, :k]
    return d.view(c, r, k), ids.reshape(-1)[pos].view(c, r, k)
