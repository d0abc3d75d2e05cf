"""Tracing / profiling utilities (counterpart of
``gpann_tpu/core/profiling.py``).

- :func:`trace` — a ``torch.profiler`` trace (CPU and, where a GPU is
  present, CUDA activity) around a pipeline stage, exported as a Chrome
  trace (open it in ``chrome://tracing`` or Perfetto).
- :func:`flops_of_scan` — explicit FLOP accounting: distance computations are
  matmul dimensions, no instrumentation needed (replaces
  ``metric_distance_computations``; README bullet 3 of the reference).
- :class:`StageTimer` — accumulating named stage timers with a report,
  the ``Timer`` + cout narration pattern structured.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` trace around a pipeline stage; on exit the trace is
    written to ``<log_dir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def flops_of_scan(num_queries: int, num_points: int, dim: int,
                  passes: int = 3) -> int:
    """FLOPs of one distance scan, counted as ``passes`` matmul passes.

    ``passes=3`` is the TPU reference's scan (bf16x3, HIGH precision); the
    port's fp32 scan is one pass (``passes=1``)."""
    return 2 * num_queries * num_points * dim * passes


def distance_computations(num_queries: int, num_points: int) -> int:
    """The reference's distance-computation counter, analytically."""
    return num_queries * num_points


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [
            f"{name}: {total:.3f}s over {self.counts[name]} calls"
            for name, total in sorted(self.totals.items())
        ]
        return "\n".join(lines)
