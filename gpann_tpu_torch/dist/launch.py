"""Run one function in several local ranks joined by ``torch.distributed``.

:func:`run_ranks` starts ``world`` processes on this host with
``torch.multiprocessing.start_processes`` (spawn), each joining one process
group (``tcp://127.0.0.1:<free port>``) as its rank, calls ``fn(*args)`` in
every one of them and returns their results in rank order. It is how the
tests, ``gpann_tpu_torch.entry.dryrun_multichip`` and the smoke run drive
the multi-rank engines of :mod:`gpann_tpu_torch.dist.mesh` on one machine.
A rank that raises or exits ends every rank and raises with its traceback;
a run that outlives its ``timeout`` kills every rank and raises. No result
is returned then.

``fn`` is pickled by reference, so it must be a function of an importable
module (not of ``__main__``); the ranks get this process's ``sys.path``.
``args`` and the results are pickled too. Spawn imports the calling
script again in every rank, so a script keeps its top-level work under
``if __name__ == "__main__":``.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
from datetime import timedelta

_GRACE_S = 5.0   # seconds the other ranks get to exit after one failed


def free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, world: int, args: tuple = (), *, timeout: float,
              threads: int = 2, backend: str = "gloo") -> list:
    """``[fn(*args) of rank 0, ..., of rank world - 1]``, each computed in a
    process of its own after ``init_process_group(backend)``.

    ``threads``: torch's intra-op threads a rank. ``timeout`` (seconds)
    bounds the whole run and each collective."""
    import torch.multiprocessing as mp

    if fn.__module__ == "__main__":
        raise ValueError(f"{fn.__qualname__} is defined in __main__; the ranks "
                         "import it, so it must live in an importable module")
    with tempfile.TemporaryDirectory(prefix="gpann_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, (world, free_port(), backend, threads, timeout, tmp,
                         fn, args), nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0),
                               grace_period=_GRACE_S):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world} ranks still running after {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            # the first rank to fail makes the others fail in a collective
            # soon after, and ``join`` names the one it saw first: show the
            # traceback of every rank that raised
            raised = []
            for r, path in enumerate(ctx.error_files):
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        raised.append(f"rank {r}:\n{pickle.load(f)}")
            raise RuntimeError("\n".join(raised) or str(e)) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            for path in ctx.error_files:
                if os.path.exists(path):
                    os.remove(path)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(rank: int, world: int, port: int, backend: str, threads: int,
               timeout: float, tmp: str, fn, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    # every rank is on this host: gloo talks over the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=timedelta(seconds=timeout))
    try:
        result = fn(*args)
        # rank 0 hosts the group's store: no rank leaves before all are done
        dist.barrier()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
