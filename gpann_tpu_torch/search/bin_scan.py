"""Bin-top-2 scan: per-128-row-bin min1/min2 summaries, then exact top-k.

Counterpart of ``gpann_tpu/search/pallas_scan.py``. Phase 1 reduces every
[query, 128-row bin] tile of the distance matrix to its two smallest
distances and their row ids, so device memory sees [m, 2*cap/128] summaries
and never the [m, cap] matrix. Phase 2 picks the ``nc`` best bin entries
with ``torch.topk``; phase 3 rescores those candidates exactly in f32
(:func:`gpann_tpu_torch.search.exact.exact_distances`, the one copy of the
rescore's formula) and takes the top-k. A true neighbour is lost only when
>= 3 of the true top-k share one bin, so ``BIN`` decides recall and stays
128.

Phase 1 has two implementations with one contract:

- the hand-written CUDA kernel ``csrc/bintop2.cu`` (via
  :mod:`gpann_tpu_torch.kernels`), taken for CUDA tensors; its product runs
  on the tensor cores in split TF32 (``split_tf32_dots`` rehearses that
  arithmetic on the CPU), its norms in f32;
- the plain PyTorch version (``binmin_scan_plain``,
  ``bintop2_blocks_plain``), taken for CPU tensors only. It walks the base
  in column chunks so that it fits in memory at bench shapes.

There is no fallback: a CUDA tensor launches the kernel or raises. The
TPU's tiling arguments (``tq``, ``tc``, ``interpret``) and its padding
helpers (``pad_base_for_scan``, ``fused_topk_chunked``) have no counterpart:
any row count and any ``d`` are valid, ``cap`` only has to be a multiple of
``BIN``.

Outputs keep the JAX layout: summaries as ``[min1 | min2]`` halves, ids int32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gpann_tpu_torch.core import profiling
from gpann_tpu_torch.core.distances import Metric, sq_norms
from gpann_tpu_torch.search.exact import exact_distances, round_up

BIN = 128  # rows per bin: decides the candidate set, hence recall

_PLAIN_CHUNK_ELEMS = 1 << 28  # distance-matrix elements per plain-version chunk


def scan_order(ids) -> np.ndarray:
    """The order in which rows with these ``ids`` are laid out for the
    binned scan: ascending id (a stable argsort of ``ids``).

    The scan keeps two rows of each 128-row bin, so near neighbours of one
    another must not sit side by side in a shard. The producers of a
    shard's rows hand them over in orders that group such rows: a cover
    lists its extra points after the members, cheapest first; the fused
    assignment admits the points closest to their representative first.
    Id order is independent of both. (A sub-cluster-major store keeps each
    sub-cluster contiguous on purpose, for pruned reads; its blocks are
    permuted when they are scanned instead, see
    ``StreamedShardEngine._scan``.)
    """
    return np.argsort(np.asarray(ids), kind="stable")


def _is_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"bin-top-2 scan runs on CUDA or CPU tensors, not {t.device}")


# -- plain PyTorch version of the kernel ---------------------------------------

def split_tf32(x: torch.Tensor, rounding: str = "nearest"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (f32) as ``hi + lo`` of TF32 values (10-bit mantissa, low 13 bits
    zero), the way the CUDA kernel splits a tile: ``hi`` is ``x`` rounded to
    nearest with ties away from zero, or cut ("truncate", what a tensor core
    that ignores the low bits would make of the raw word); ``lo`` is
    ``x - hi`` cut. Used by tests and ``chip_smoke.py`` only."""
    if rounding not in ("nearest", "truncate"):
        raise ValueError(f"unknown rounding {rounding!r}")
    bits = x.contiguous().view(torch.int32)
    if rounding == "nearest":
        bits = bits + 0x1000
    hi = (bits & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def split_tf32_dots(q: torch.Tensor, rows: torch.Tensor,
                    rounding: str = "nearest", passes: int = 3) -> torch.Tensor:
    """``q @ rows.T`` as the kernel's tensor-core product: lo*hi + hi*lo +
    hi*hi summed in f32 (``passes=3``), or the single TF32 product hi*hi
    (``passes=1``). A rehearsal of the arithmetic, never on the main path."""
    qh, ql = split_tf32(q, rounding)
    rh, rl = split_tf32(rows, rounding)
    if passes == 1:
        return qh @ rh.T
    return (ql @ rh.T + qh @ rl.T) + qh @ rh.T


def _bin_top2_plain(q: torch.Tensor, rows: torch.Tensor, n_live: int, cap: int,
                    metric: Metric, dots_fn=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin top-2 of ``q`` [m, d] over a window of ``cap`` rows whose first
    ``n_live`` are ``rows[:n_live]`` and the rest are dead (+inf).
    ``dots_fn(q, rows)`` replaces the f32 product (see ``split_tf32_dots``)."""
    m = q.shape[0]
    L = cap // BIN
    mins = torch.empty((m, 2 * L), dtype=torch.float32, device=q.device)
    ids = torch.empty((m, 2 * L), dtype=torch.int32, device=q.device)
    qsq = sq_norms(q) if metric != "mips" else None
    chunk = max(BIN, _PLAIN_CHUNK_ELEMS // max(m, 1) // BIN * BIN)
    for c0 in range(0, cap, chunk):
        c1 = min(c0 + chunk, cap)
        dm = torch.full((m, c1 - c0), torch.inf, device=q.device)
        blk = rows[c0 : max(c0, min(c1, n_live))]
        if blk.shape[0]:
            dots = q @ blk.T if dots_fn is None else dots_fn(q, blk)
            if metric == "mips":
                dm[:, : blk.shape[0]] = 1.0 - dots
            else:
                dm[:, : blk.shape[0]] = (qsq[:, None] + sq_norms(blk)[None, :]
                                         - 2.0 * dots)
        dm3 = dm.view(m, -1, BIN)
        # argmin takes the first minimum, as jnp.argmin does
        a1 = dm3.argmin(dim=2, keepdim=True)
        mn1 = dm3.gather(2, a1)
        dm3b = dm3.scatter(2, a1, torch.inf)
        a2 = dm3b.argmin(dim=2, keepdim=True)
        mn2 = dm3b.gather(2, a2)
        b0, b1 = c0 // BIN, c1 // BIN
        offs = c0 + BIN * torch.arange(b1 - b0, device=q.device)[None, :]
        mins[:, b0:b1] = mn1[..., 0]
        mins[:, L + b0 : L + b1] = mn2[..., 0]
        ids[:, b0:b1] = (offs + a1[..., 0]).to(torch.int32)
        ids[:, L + b0 : L + b1] = (offs + a2[..., 0]).to(torch.int32)
    return mins, ids


def binmin_scan_plain(qs: torch.Tensor, base: torch.Tensor, n_valid,
                      metric: Metric = "l2", dots_fn=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch :func:`binmin_scan` (same inputs, same outputs)."""
    cap = round_up(max(base.shape[0], 1), BIN)
    return _bin_top2_plain(qs, base, int(n_valid), cap, metric, dots_fn)


def bintop2_blocks_plain(queries_blocks: torch.Tensor, base_flat: torch.Tensor,
                         row_off: torch.Tensor, sizes: torch.Tensor, qb: int,
                         cap: int, metric: Metric = "l2"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch :func:`bintop2_blocks`: a loop over probe blocks."""
    nb = row_off.shape[0]
    L = cap // BIN
    dev = queries_blocks.device
    mins = torch.full((nb * qb, 2 * L), torch.inf, device=dev)
    ids = torch.zeros((nb * qb, 2 * L), dtype=torch.int32, device=dev)
    for b, (off, size) in enumerate(zip(row_off.tolist(), sizes.tolist())):
        if size == 0:  # skipped block: +inf summaries, id 0
            continue
        live = min(size, cap)
        sl = slice(b * qb, (b + 1) * qb)
        mins[sl], ids[sl] = _bin_top2_plain(
            queries_blocks[sl], base_flat[off : off + live], live, cap, metric)
    return mins, ids


# -- phase 1 wrappers: kernel on CUDA, plain version on CPU ---------------------

def binmin_scan(qs: torch.Tensor, base: torch.Tensor, n_valid,
                metric: Metric = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin top-2 (distances, global row ids) of ``qs`` [m, d] over
    ``base`` [n, d]; rows ``>= n_valid`` are padding (+inf).

    Returns ``(mins [m, 2L], argmins [m, 2L])``, L = ceil(n/128), laid out as
    ``[all min1 | all min2]``. Kernel B2 of the TPU package, run as the
    block kernel with one block.
    """
    if not _is_cuda(qs):
        return binmin_scan_plain(qs, base, n_valid, metric)
    from gpann_tpu_torch import kernels

    n = base.shape[0]
    if not isinstance(n_valid, torch.Tensor) and not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} outside [0, {n}]")
    cap = round_up(max(n, 1), BIN)
    row_off = torch.zeros(1, dtype=torch.int64, device=qs.device)
    # filled on the device: a tensor made from a host number would be a
    # blocking copy
    sizes = torch.full((1,), n_valid, dtype=torch.int32, device=qs.device)
    return kernels.bintop2(qs, base, row_off, sizes, qs.shape[0], cap, metric,
                           entry="binmin_scan")


def bintop2_blocks(queries_blocks: torch.Tensor, base_flat: torch.Tensor,
                   row_off: torch.Tensor, sizes: torch.Tensor, qb: int,
                   cap: int, metric: Metric = "l2"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of :func:`fused_topk_blocks`: block ``b``'s ``qb`` query rows
    against base rows ``[row_off[b], row_off[b] + cap)``, of which the first
    ``sizes[b]`` are live. Returns [nb*qb, 2*cap/128] summaries with
    block-LOCAL row ids. Size-0 blocks give +inf and id 0.
    """
    if not _is_cuda(queries_blocks):
        return bintop2_blocks_plain(queries_blocks, base_flat, row_off, sizes,
                                    qb, cap, metric)
    from gpann_tpu_torch import kernels

    return kernels.bintop2(queries_blocks, base_flat, row_off.to(torch.int64),
                           sizes.to(torch.int32), qb, cap, metric,
                           entry="bintop2_blocks")


# -- phases 2 and 3 (plain torch, as the JAX package runs them outside Pallas) --

def _select_and_rescore(queries, base, mins, argmins, row_base, k: int,
                        nc: int, metric: Metric, phase2: str):
    """Top-``nc`` bin entries, exact f32 rescore, top-k. ``row_base`` [m]
    maps a query row's local ids to base rows (None: ids are global)."""
    if phase2 not in ("exact", "approx"):
        raise ValueError(f"unknown phase2 {phase2!r}")
    # "approx" is the TPU's partial-reduction top-k; here both are exact
    nc = min(nc, mins.shape[1])
    bvals, bpos = torch.topk(mins, nc, dim=1, largest=False)
    cand_ids = argmins.gather(1, bpos)
    rows = cand_ids.long()
    if row_base is not None:
        rows = rows + row_base[:, None]
    # masked entries (+inf) may point past the base; their scores are masked
    cand = base[rows.clamp_(max=base.shape[0] - 1)]        # [m, nc, d]
    exact = exact_distances(queries, cand, metric)
    exact = torch.where(torch.isfinite(bvals), exact, torch.inf)
    dist, pos = torch.topk(exact, k, dim=1, largest=False)
    return dist, cand_ids.gather(1, pos)


def fused_topk(qs: torch.Tensor, base: torch.Tensor, n_valid, k: int,
               metric: Metric = "l2", num_candidate_bins: int = 0,
               phase2: str = "exact") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each query in ``base`` via the bin-top-2 scan.

    Returns ``(dists [m, k] f32, row ids [m, k] int32)``; padding rows never
    win. Candidate bin entries default to ``max(k, 16)``.
    """
    nc = num_candidate_bins or max(k, 16)
    mins, argmins = binmin_scan(qs, base, n_valid, metric)
    return _select_and_rescore(qs, base, mins, argmins, None, k, nc, metric,
                               phase2)


def fused_topk_blocks(queries_blocks: torch.Tensor, base_flat: torch.Tensor,
                      row_off: torch.Tensor, sizes: torch.Tensor, k: int,
                      metric: Metric = "l2", qb: int = 512, cap: int = 16384,
                      num_candidate_bins: int = 0, phase2: str = "exact"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block top-k: block ``b``'s ``qb`` query rows are scanned against
    base rows ``[row_off[b], row_off[b] + cap)`` (live prefix ``sizes[b]``).

    Returns ``(dists [nb*qb, k], LOCAL row ids [nb*qb, k] int32)``. With a
    recorder installed, phase 1 records a ``scan.b1`` span and phases 2-3 a
    ``scan.phase2`` span.
    """
    nb = row_off.shape[0]
    if queries_blocks.shape[0] != nb * qb:
        raise ValueError(f"{queries_blocks.shape[0]} query rows != {nb}*{qb}")
    if cap % BIN:
        raise ValueError(f"cap={cap} must be a multiple of {BIN}")
    nc = num_candidate_bins or max(k, 16)
    rec = profiling.RECORDER
    if rec is not None:
        step = rec.begin("scan.b1", queries_blocks.device)
    mins, argmins = bintop2_blocks(queries_blocks, base_flat, row_off, sizes,
                                   qb, cap, metric)
    if rec is not None:
        step = rec.next(step, "scan.phase2", queries_blocks.device)
    row_base = row_off.to(torch.int64).repeat_interleave(qb)
    out = _select_and_rescore(queries_blocks, base_flat, mins, argmins,
                              row_base, k, nc, metric, phase2)
    if rec is not None:
        rec.end(step, queries_blocks.device)
    return out
