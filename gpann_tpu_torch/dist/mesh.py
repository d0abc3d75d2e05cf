"""Multi-rank query engine over a (dp, shard) layout of ``torch.distributed``
ranks (counterpart of ``gpann_tpu/dist/mesh.py``; reference
``src/distributed_query_benchmark.h``).

- **Layout.** ``world = dp x shard`` ranks, ``rank = dp_index * shard +
  shard_index`` (:func:`shard_mesh`). The shard count is padded with empty
  shards to a multiple of ``shard``; shard rank j holds global shards
  ``[j * s_local, (j + 1) * s_local)``, replicated over dp. **Each rank
  copies only its own shards** to its device, as the reference's ranks load
  only their owned points (``distributed_query_benchmark.h:48-84``).
- **Query flow.** A batch is split over dp and replicated over shard. Each
  rank scans its dp slice against its shards, each shard meeting only the
  queries whose probe list holds its global id
  (:func:`~gpann_tpu_torch.search.ivf._scan_probed_dense` over
  :mod:`gpann_tpu_torch.search.exact`'s exact scan), then the ranks
  of a dp row ``all_gather`` their ``[m, k]`` lists and take the top-k, the
  lower rank's entry first on equal distances (the order of ``lax.top_k``).
  A last ``all_gather`` over dp gives every rank the whole result.
- **Serving.** The routing points are replicated; every rank routes its own
  dp slice with :func:`~gpann_tpu_torch.search.serve._probe_rank` (four
  rules, four voting impls; ``voting_impl="binned"`` runs the bin-top-2
  kernel on a CUDA device), microbatch by microbatch: route, local scan,
  gather and merge. With a recorder installed
  (:func:`gpann_tpu_torch.core.profiling.recording`) ``serve_device``
  records a ``dist.batch`` span a call with one span a step and microbatch
  inside (:data:`SERVE_STEPS`); without one, each call site reads one
  module global and nothing else.
- **Index build.** :func:`sharded_lloyd_round` is one Lloyd round over
  points split across all ranks; the per-rank sums are gathered and added
  in rank order, so two calls give identical results.

**Backends.** ``"gloo"`` exchanges CPU tensors: a rank on a CUDA device
copies what it exchanges (the ``[m, k]`` lists, the Lloyd partials) to the
host and back, explicitly — the way for several ranks that share one card.
``"nccl"`` exchanges CUDA tensors in place, one device per rank. The backend
is the process group's unless the constructor names one; nothing switches
backend or device on its own.

Left out, as TPU or XLA devices: ``jax.lax.scan`` as a pipelining device (a
Python loop over microbatches here), ``shard_map`` specs,
``make_array_from_callback`` (each rank copies its shards), and one
capacity for every shard (a rank sizes its ``[s_local, cap, d]`` stack by its
own largest shard; results do not depend on it). The JAX engines'
``precision`` has no counterpart: the scan is fp32 with TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gpann_tpu_torch.cluster.kmeans import _nearest64, _segment_sum
from gpann_tpu_torch.core import profiling
from gpann_tpu_torch.core.distances import Metric, sq_norms, to_device
from gpann_tpu_torch.core.partition import Clusters
from gpann_tpu_torch.search.exact import round_up, shard_bias
from gpann_tpu_torch.search.ivf import _scan_probed_dense
from gpann_tpu_torch.search.serve import _VOTING_IMPLS, _probe_rank

# the recorded spans of serve_device's steps
SERVE_STEPS = ("dist.route", "dist.local_scan", "dist.merge_shards",
               "dist.gather_dp")


@dataclass(frozen=True)
class ShardMesh:
    """A (dp, shard) layout of ranks: ``rank = dp_index * shard +
    shard_index``. ``shard_groups[i]`` joins the ranks of dp row i,
    ``dp_groups[j]`` those of shard column j; a group of one rank is
    ``None`` (nothing to exchange), as is ``group`` at world 1."""

    world: int
    dp: int
    rank: int
    group: object
    shard_groups: tuple
    dp_groups: tuple

    @property
    def shard(self) -> int:
        return self.world // self.dp

    @property
    def dp_index(self) -> int:
        return self.rank // self.shard

    @property
    def shard_index(self) -> int:
        return self.rank % self.shard

    @property
    def shard_group(self):
        return self.shard_groups[self.dp_index]

    @property
    def dp_group(self):
        return self.dp_groups[self.shard_index]

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "shard": self.shard}


def shard_mesh(dp: int = 1, group=None) -> ShardMesh:
    """The (dp, shard) layout of the ranks of ``group`` (default: the
    initialised process group). Every rank of the default group must call
    it: each creates every sub-group, in the same order.

    With no initialised process group it is the one-rank layout: world 1,
    no collectives."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    elif group is not None:
        raise ValueError("a group was given, but no process group is "
                         "initialised")
    else:
        world, rank = 1, 0
    if world % dp != 0:
        raise ValueError(f"{world} ranks not divisible by dp={dp}")
    shard = world // dp

    def new_group(ranks):
        if len(ranks) == 1:
            return None
        if group is not None:
            ranks = [dist.get_global_rank(group, r) for r in ranks]
        return dist.new_group(ranks)

    shard_groups = tuple(new_group([i * shard + j for j in range(shard)])
                         for i in range(dp))
    dp_groups = tuple(new_group([i * shard + j for i in range(dp)])
                      for j in range(shard))
    return ShardMesh(world, dp, rank,
                     (group or dist.group.WORLD) if world > 1 else None,
                     shard_groups, dp_groups)


def _host_exchange(mesh: ShardMesh, device: torch.device,
                   backend: Optional[str]) -> bool:
    """Whether exchanged tensors take explicit host copies (gloo with a CUDA
    device). Raises where the backend cannot exchange the device's tensors
    or is not the process group's."""
    if mesh.world == 1:
        return False
    have = str(dist.get_backend(mesh.group))
    backend = have if backend is None else backend
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: pass backend='gloo' or "
                         "'nccl'")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl exchanges CUDA tensors; the device is "
                         f"{device}")
    if backend not in have:
        raise ValueError(f"backend {backend!r}: the process group runs "
                         f"{have!r}")
    return backend == "gloo" and device.type != "cpu"


def _gather(t: torch.Tensor, group, size: int, host: bool) -> torch.Tensor:
    """``[size, *t.shape]``: ``t`` of every rank of ``group``, in rank
    order; ``group is None`` is a group of this rank alone."""
    if group is None:
        return t[None]
    x = t.cpu() if host else t.contiguous()
    out = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(out, x, group=group)
    return torch.stack(out).to(t.device)


def _merge_ranks(all_d: torch.Tensor, all_i: torch.Tensor, k: int):
    """Top-k ``[m, k]`` of the ``[r, m, k]`` lists of r ranks; on equal
    distances the lower rank's entry first; id -1 where the distance is
    +inf."""
    m = all_d.shape[1]
    cat_d = all_d.permute(1, 0, 2).reshape(m, -1)
    cat_i = all_i.permute(1, 0, 2).reshape(m, -1)
    sd, order = torch.sort(cat_d, dim=1, stable=True)
    d = sd[:, :k]
    return d, torch.where(torch.isfinite(d), cat_i.gather(1, order[:, :k]), -1)


class DistributedIVF:
    """IVF shards spread over the shard ranks of a layout; probed search
    with a collective top-k merge."""

    def __init__(
        self,
        points: np.ndarray,
        clusters: Clusters,
        mesh: Optional[ShardMesh] = None,
        metric: Metric = "l2",
        pad_multiple: int = 128,
        rescore: bool = True,
        *,
        device,
        backend: Optional[str] = None,
    ) -> None:
        """``points`` may be a ``np.memmap``: a rank reads only the rows of
        its own shards. ``device``: where this rank's shards live and its
        scans run."""
        mesh = shard_mesh() if mesh is None else mesh
        device = torch.device(device)
        s = len(clusters)
        s_local = -(-s // mesh.shard)
        lo = mesh.shard_index * s_local
        mine = [np.asarray(clusters[b], np.int64) if b < s
                else np.empty(0, np.int64) for b in range(lo, lo + s_local)]
        sizes = np.asarray([len(c) for c in mine], np.int32)
        cap = round_up(max(int(sizes.max()), 1), pad_multiple)
        blocks = torch.zeros((s_local, cap, points.shape[1]),
                             dtype=torch.float32, device=device)
        ids = torch.full((s_local, cap), -1, dtype=torch.int32, device=device)
        for j, members in enumerate(mine):
            if len(members):
                blocks[j, : len(members)] = to_device(points[members], device)
                ids[j, : len(members)] = torch.from_numpy(
                    members.astype(np.int32)).to(device)
        self._setup(mesh, metric, rescore, s, device, backend, blocks,
                    torch.from_numpy(sizes).to(device), ids)

    def _setup(self, mesh, metric, rescore, num_shards, device, backend,
               blocks, sizes, ids) -> None:
        self.mesh = mesh
        self.metric: Metric = metric
        self.rescore = rescore
        self.num_shards = num_shards
        self.device = device
        self.shard_points, self.shard_sizes, self.shard_ids = blocks, sizes, ids
        self.capacity = blocks.shape[1]
        self.shard_offset = mesh.shard_index * blocks.shape[0]
        self._bias = shard_bias(blocks, sizes, metric)
        self._host = _host_exchange(mesh, device, backend)

    @classmethod
    def from_state(cls, arrays: dict, config: dict,
                   mesh: Optional[ShardMesh] = None, *, device,
                   backend: Optional[str] = None):
        """An engine from the JAX engine's state, each rank keeping its own
        shards. ``arrays``: numpy ``shard_points`` [s_pad, cap, d],
        ``shard_sizes`` [s_pad], ``shard_ids`` [s_pad, cap]; ``config``:
        ``num_shards``, ``metric``, ``rescore``. The state's padding shards
        (past ``num_shards``) are dropped and the count padded again for
        this layout."""
        self = cls.__new__(cls)
        mesh = shard_mesh() if mesh is None else mesh
        device = torch.device(device)
        s = int(config["num_shards"])
        s_local = -(-s // mesh.shard)
        lo = mesh.shard_index * s_local
        hi = min(lo + s_local, s)
        sp = np.asarray(arrays["shard_points"][lo:hi], np.float32)
        blocks = np.zeros((s_local,) + sp.shape[1:], np.float32)
        sizes = np.zeros(s_local, np.int32)
        ids = np.full(blocks.shape[:2], -1, np.int32)
        blocks[: hi - lo] = sp
        sizes[: hi - lo] = arrays["shard_sizes"][lo:hi]
        ids[: hi - lo] = arrays["shard_ids"][lo:hi]
        self._setup(mesh, config["metric"], bool(config["rescore"]), s, device,
                    backend, torch.from_numpy(blocks).to(device),
                    torch.from_numpy(sizes).to(device),
                    torch.from_numpy(ids).to(device))
        return self

    # -- the steps of a batch (device tensors) ---------------------------------
    def _local_scan(self, queries: torch.Tensor, probes: torch.Tensor, k: int):
        """This rank's top-k of ``queries`` over its shards."""
        return _scan_probed_dense(queries, probes, self.shard_points,
                                  self.shard_sizes, self.shard_ids, k,
                                  self.metric, self.shard_offset, self.rescore,
                                  self._bias)

    def _merge_shards(self, d: torch.Tensor, i: torch.Tensor, k: int):
        """The top-k over the shard ranks of this rank's dp row."""
        m = self.mesh
        return _merge_ranks(_gather(d, m.shard_group, m.shard, self._host),
                            _gather(i, m.shard_group, m.shard, self._host), k)

    def _gather_dp(self, t: torch.Tensor) -> torch.Tensor:
        """The dp slices of every dp row, laid end to end."""
        m = self.mesh
        out = _gather(t, m.dp_group, m.dp, self._host)
        return out.reshape((-1,) + tuple(t.shape[1:]))

    def _dp_rows(self, m: int) -> slice:
        per = m // self.mesh.dp
        return slice(self.mesh.dp_index * per, (self.mesh.dp_index + 1) * per)

    # -- public entry points ---------------------------------------------------
    def search_probed(self, queries: np.ndarray, probes: np.ndarray, k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Probed search of the whole batch; ``probes`` [m, p] global shard
        ids (-1 pads). A batch that dp does not divide is padded. Every rank
        returns the whole ``(dists [m, k], ids [m, k] int32)`` as numpy."""
        queries = np.asarray(queries, np.float32)
        probes = np.asarray(probes, np.int32)
        m = len(queries)
        pad = (-m) % self.mesh.dp
        if pad:
            queries = np.concatenate(
                [queries, np.zeros((pad, queries.shape[1]), np.float32)])
            probes = np.concatenate(
                [probes, np.full((pad, probes.shape[1]), -1, np.int32)])
        rows = self._dp_rows(m + pad)
        d, i = self._local_scan(to_device(queries[rows], self.device),
                                torch.from_numpy(probes[rows]).to(self.device),
                                k)
        d, i = self._merge_shards(d, i, k)
        return (self._gather_dp(d).cpu().numpy()[:m],
                self._gather_dp(i).cpu().numpy()[:m])


class DistributedServingEngine(DistributedIVF):
    """Routed serving over the layout: every rank routes its own dp slice
    on its device (no exchange), then scans, gathers and merges microbatch
    by microbatch (``distributed_query_benchmark.h:148-180``)."""

    def __init__(
        self,
        points: np.ndarray,
        clusters: Clusters,
        routing_points: np.ndarray,
        routing_labels: np.ndarray,
        mesh: Optional[ShardMesh] = None,
        metric: Metric = "l2",
        pad_multiple: int = 128,
        rescore: bool = True,
        voting_impl: str = "exact",
        *,
        device,
        backend: Optional[str] = None,
    ) -> None:
        super().__init__(points, clusters, mesh=mesh, metric=metric,
                         pad_multiple=pad_multiple, rescore=rescore,
                         device=device, backend=backend)
        rp = np.asarray(routing_points, np.float32)
        # exact squared norms (f64 on the host, stored f32)
        self._set_router(rp, routing_labels,
                         (rp.astype(np.float64) ** 2).sum(1).astype(np.float32),
                         voting_impl)

    @classmethod
    def from_state(cls, arrays: dict, config: dict,
                   mesh: Optional[ShardMesh] = None, *, device,
                   backend: Optional[str] = None):
        """As :meth:`DistributedIVF.from_state`, with the JAX serving
        engine's ``router_points``, ``router_labels``, ``router_sq`` in
        ``arrays`` (replicated on every rank) and ``voting_impl`` in
        ``config``."""
        self = super().from_state(arrays, config, mesh, device=device,
                                  backend=backend)
        self._set_router(arrays["router_points"], arrays["router_labels"],
                         arrays["router_sq"], config["voting_impl"])
        return self

    def _set_router(self, points, labels, sq, voting_impl: str) -> None:
        if voting_impl not in _VOTING_IMPLS:
            raise ValueError(f"unknown voting_impl {voting_impl!r}")
        self.voting_impl = voting_impl
        self.router_points = torch.tensor(np.asarray(points, np.float32),
                                          device=self.device)
        self.router_labels = torch.tensor(np.asarray(labels, np.int64),
                                          device=self.device)
        self.router_sq = torch.tensor(np.asarray(sq, np.float32),
                                      device=self.device)

    def _route(self, queries: torch.Tensor, nprobes: int, voting_t: int,
               rule: str, spann_eps: float) -> torch.Tensor:
        """Probe lists [m, nprobes] (dummy shard ``num_shards`` where a rule
        cuts a list short)."""
        return _probe_rank(
            queries, self.router_points, self.router_labels, self.router_sq,
            s=self.num_shards, voting_t=voting_t, rule=rule,
            spann_eps=spann_eps, nprobes=nprobes, metric=self.metric,
            voting_impl=self.voting_impl)

    def serve_device(self, queries, k: int, nprobes: int, voting_t: int = 60,
                     rule: str = "min_dist", spann_eps: float = 0.6,
                     microbatch: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
        """Routed search of the whole batch ``queries`` [m, d] (a tensor,
        the same on every rank; dp must divide m) without padding; returns
        the whole ``(dists [m, k], ids [m, k])`` on the device."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        m = queries.shape[0]
        if m % self.mesh.dp:
            raise ValueError(f"{m} queries: dp={self.mesh.dp} must divide the "
                             "batch (serve() pads it)")
        local = queries[self._dp_rows(m)]
        rec, dev = profiling.RECORDER, self.device
        if rec is not None:
            batch = rec.begin("dist.batch", dev, root=True)
        outs_d, outs_i = [], []
        for s0 in range(0, len(local), microbatch):
            q = local[s0 : s0 + microbatch]
            if rec is not None:
                step = rec.begin(SERVE_STEPS[0], dev)
            probes = self._route(q, nprobes, voting_t, rule, spann_eps)
            if rec is not None:
                step = rec.next(step, SERVE_STEPS[1], dev)
            d, i = self._local_scan(q, probes, k)
            if rec is not None:
                step = rec.next(step, SERVE_STEPS[2], dev)
            d, i = self._merge_shards(d, i, k)
            if rec is not None:
                rec.end(step, dev)
            outs_d.append(d)
            outs_i.append(i)
        if not outs_d:
            outs_d.append(torch.empty((0, k), device=dev))
            outs_i.append(torch.empty((0, k), dtype=torch.int32, device=dev))
        if rec is not None:
            step = rec.begin(SERVE_STEPS[3], dev)
        out = (self._gather_dp(torch.cat(outs_d)),
               self._gather_dp(torch.cat(outs_i)))
        if rec is not None:
            rec.end(step, dev)
            rec.end(batch, dev)
        return out

    def serve(self, queries, k: int, nprobes: int, voting_t: int = 60,
              rule: str = "min_dist", spann_eps: float = 0.6,
              microbatch: int = 128) -> Tuple[np.ndarray, np.ndarray]:
        """Routed search; the batch is padded to a multiple of ``dp *
        microbatch``. Every rank returns the whole ``(dists [m, k], ids
        [m, k] int32)`` as numpy."""
        queries = np.asarray(queries, np.float32)
        m = len(queries)
        pad = (-m) % (self.mesh.dp * microbatch)
        if pad:
            queries = np.concatenate(
                [queries, np.zeros((pad, queries.shape[1]), np.float32)])
        d, i = self.serve_device(to_device(queries, self.device), k, nprobes,
                                 voting_t, rule, spann_eps, microbatch)
        return d.cpu().numpy()[:m], i.cpu().numpy()[:m]


# ---------------------------------------------------------------------------
# The sharded index-build step: one Lloyd round over points split across all
# ranks, the per-rank sums added in rank order.
# ---------------------------------------------------------------------------


def sharded_lloyd_round(mesh: ShardMesh, k: int, metric: Metric = "l2", *,
                        device, backend: Optional[str] = None):
    """``fn(points_local, centroids) -> (centroids' [k, d] f32, assignment
    [n] int32)``, device tensors. Each rank passes its own rows of the
    points (rank order is row order) and the same centroids; every rank
    gets the new centroids and the WHOLE assignment.

    Each rank assigns its rows (f64 over the f32 values, as
    ``cluster/kmeans.py`` does) and sums them per cluster with
    ``_segment_sum`` (a fixed order on each device); the ranks' [k, d + 1]
    partials are gathered and added in rank order, never by an
    ``all_reduce`` whose order the backend picks, so that two calls give
    identical results. Empty clusters keep their centroid; as in
    ``gpann_tpu/dist/mesh.py``, MIPS means are not renormalised."""
    device = torch.device(device)
    host = _host_exchange(mesh, device, backend)

    def step(points_local, centroids):
        p64 = torch.as_tensor(points_local, dtype=torch.float32,
                              device=device).double()
        c = torch.as_tensor(centroids, dtype=torch.float32, device=device)
        n = p64.shape[0]
        assignment = _nearest64(p64, sq_norms(p64) if metric == "l2" else None,
                                c, metric)
        ones = torch.ones((n, 1), dtype=torch.float64, device=device)
        parts = _gather(_segment_sum(torch.cat([p64, ones], dim=1),
                                     assignment, k),
                        mesh.group, mesh.world, host)
        total = parts[0].clone()
        for r in range(1, mesh.world):
            total += parts[r]
        sizes = total[:, -1:]
        means = (total[:, :-1] / torch.clamp(sizes, min=1.0)).float()
        new_c = torch.where(sizes > 0, means, c)
        counts = _gather(torch.tensor([n], device=device), mesh.group,
                         mesh.world, host).flatten().tolist()
        padded = torch.full((max(counts),), -1, dtype=torch.int32,
                            device=device)
        padded[:n] = assignment.to(torch.int32)
        every = _gather(padded, mesh.group, mesh.world, host)
        return new_c, torch.cat([every[r, :c_r]
                                 for r, c_r in enumerate(counts)])

    return step
