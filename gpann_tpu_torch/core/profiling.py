"""Tracing / profiling utilities (counterpart of
``gpann_tpu/core/profiling.py``).

- :class:`Recorder` with :func:`recording` — spans and counters recorded
  inside the engines (``search/serve.py``, ``search/bin_scan.py``,
  ``search/streamed.py``, ``dist/mesh.py``): off unless a caller installs
  a recorder. The benchmark's span window (``annbench/spanwindow.py``),
  ``chip_smoke.py``'s multi-rank phase and the span tests read them.
- :class:`StageTimer` — accumulating named stage timers with a report,
  the ``Timer`` + cout narration pattern structured; the query-attribution
  and small-scale CLIs print it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

# The installed recorder; None (the default) turns every span and counter
# off. Call sites read this global once and do nothing else when it is None.
RECORDER: Optional["Recorder"] = None


class Span(NamedTuple):
    """One recorded span, as :meth:`Recorder.drain` returns it."""

    name: str
    id: int
    parent: int              # -1 for a root
    batch: int               # the root's batch id, shared by its spans
    start_ns: int            # host clock, ``time.time_ns()``
    end_ns: int
    stream_ms: Optional[float]     # card time between the span's events
    stream_at_ms: Optional[float]  # card time from the recorder's first event


class Drained(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]


class Recorder:
    """Spans and counters kept in memory until :meth:`drain`.

    A span's host edges are read from ``time.time_ns()``: the Unix-epoch
    clock of ``torch.profiler``'s events, so spans lie on the same timeline
    as a profile of the same window. On a CUDA device each edge also records
    a timing event on the current stream; the span's stream milliseconds are
    the card's time between its two events, and its ``stream_at_ms`` the
    card's time from the recorder's first event to its first, both resolved
    by :meth:`drain`. A span that was never ended (an exception inside it)
    is dropped.

    Spans nest by the order of calls: a span's parent is the innermost span
    open when it begins; a ``root=True`` span has none and begins a new
    batch (a new batch id) for the spans inside it.
    """

    def __init__(self) -> None:
        self._spans: list = []   # [name, id, parent, batch, t0, t1, ev0, ev1]
        self._open: List[int] = []
        self._batch = -1
        self._counters: dict = {}
        self._devices: set = set()

    def _edge(self, device: torch.device):
        if device.type != "cuda":
            return None
        self._devices.add(device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def _open_span(self, name: str, t: int, ev, parent: int) -> int:
        sid = len(self._spans)
        self._spans.append([name, sid, parent, self._batch, t, None, ev, None])
        self._open.append(sid)
        return sid

    def begin(self, name: str, device: torch.device,
              root: bool = False) -> int:
        """Open a span; returns its id for :meth:`end` or :meth:`next`."""
        if root:
            self._batch += 1
        parent = self._open[-1] if self._open and not root else -1
        t = time.time_ns()
        return self._open_span(name, t, self._edge(device), parent)

    def _close(self, sid: int, t: int, ev) -> None:
        span = self._spans[sid]
        span[5], span[7] = t, ev
        del self._open[self._open.index(sid):]

    def end(self, sid: int, device: torch.device) -> None:
        ev = self._edge(device)
        self._close(sid, time.time_ns(), ev)

    def next(self, sid: int, name: str, device: torch.device) -> int:
        """End span ``sid`` and begin its sibling ``name`` at the same edge
        (one clock reading, one event)."""
        ev = self._edge(device)
        t = time.time_ns()
        parent = self._spans[sid][2]
        self._close(sid, t, ev)
        return self._open_span(name, t, ev, parent)

    def count(self, name: str, value) -> None:
        """Add ``value`` to counter ``name``; a device tensor is added on its
        device and read by :meth:`drain`, so counting never waits for it."""
        self._counters[name] = self._counters.get(name, 0) + value

    def drain(self) -> Drained:
        """Wait for the card once, resolve every span's stream milliseconds
        and every counter, and empty the recorder."""
        for dev in self._devices:
            torch.cuda.synchronize(dev)
        first = next((sp[6] for sp in self._spans if sp[6] is not None), None)
        spans = [Span(name, sid, parent, batch, t0, t1,
                      *((ev0.elapsed_time(ev1), first.elapsed_time(ev0))
                        if ev0 is not None else (None, None)))
                 for name, sid, parent, batch, t0, t1, ev0, ev1 in self._spans
                 if t1 is not None]
        counters = {name: int(v) for name, v in self._counters.items()}
        self.__init__()
        return Drained(spans, counters)


@contextlib.contextmanager
def recording(rec: Recorder) -> Iterator[Recorder]:
    """Install ``rec`` for the code inside; the previous recorder (none by
    default) comes back on exit."""
    global RECORDER
    prev, RECORDER = RECORDER, rec
    try:
        yield rec
    finally:
        RECORDER = prev


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
