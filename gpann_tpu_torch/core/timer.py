"""Accumulating timer (reference ``Timer``, ``src/defs.h:61-98``) plus a
device-aware measurement helper following the reference's benchmark hygiene:
median of repetitions (``shard_searches.cpp:57-68``) and an explicit
completion barrier after every call (counterpart of
``gpann_tpu/core/timer.py``)."""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


class Timer:
    def __init__(self) -> None:
        self.total_duration = 0.0
        self._start: float | None = None

    def start(self) -> None:
        if self._start is not None:
            raise RuntimeError("timer already running")
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("timer not running")
        elapsed = time.perf_counter() - self._start
        self.total_duration += elapsed
        self._start = None
        return elapsed

    def restart(self) -> float:
        elapsed = self.stop()
        self.start()
        return elapsed

    @property
    def elapsed(self) -> float:
        return self.total_duration


def time_fn(fn: Callable, *args, reps: int = 5, warmup: int = 1, device):
    """Median-of-reps wall time of ``fn(*args)``; returns (median_s, result).

    On a CUDA ``device`` every call is followed by
    ``torch.cuda.synchronize(device)``, so a rep times the work it queued,
    not its launches. An exception of ``fn`` propagates."""
    device = torch.device(device)

    def call():
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    result = None
    for _ in range(max(warmup, 0)):
        result = call()
    times = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        result = call()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), result
