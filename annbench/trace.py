"""Reading a ``torch.profiler`` trace of the measured window.

:func:`spans` takes the profiler's raw events: device spans (kernels, copies
and sets on the card) and host spans (operators, runtime calls and
annotations), in nanoseconds of one clock. :class:`Trace` then gives the
window's length, the union of its device spans (busy time), the device time
of kernels by name, and the idle gaps between device spans labelled with the
innermost host span that was open at each gap's middle.

Two kinds of window: :meth:`Trace.device_only` for a profile of the card
alone (no host operators recorded, so the host runs at its own pace), its
length taken on the host's clock; :meth:`Trace.annotated` for a profile of
host and card, bounded by the ``WINDOW_SPAN`` annotation, whose gaps can be
labelled.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

WINDOW_SPAN = "annbench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160
BETWEEN_OPS = "host: between operators"
_LOOK_BACK = 4096


class Span(NamedTuple):
    name: str
    start: int   # ns
    end: int     # ns


def spans(prof) -> Tuple[List[Span], List[Span]]:
    """(device spans, host spans) of a finished ``torch.profiler.profile``.

    A device span is an event on the card other than an annotation (the
    profiler mirrors ``record_function`` ranges onto the card); where the
    events do not name their activity (torch 2.11), annotations are told by
    their ``annbench.`` names."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = Span(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        where = e.device_type().name
        if where == "CPU":
            host.append(span)
        elif where == "CUDA":
            kind = (str(e.activity_type()) if hasattr(e, "activity_type")
                    else None)
            if kind in DEVICE_ACTIVITIES or (kind is None and not
                                             span.name.startswith("annbench.")):
                device.append(span)
    return device, host


class Trace:
    """The device and host spans that fall in the window [lo, hi) (ns)."""

    def __init__(self, device: List[Span], host: List[Span], lo: int,
                 hi: int) -> None:
        self.lo, self.hi = lo, hi
        self.device = sorted((s for s in device
                              if s.end > self.lo and s.start < self.hi),
                             key=lambda s: s.start)
        self.host = sorted((s for s in host if s.name != WINDOW_SPAN
                            and s.end > self.lo and s.start < self.hi),
                           key=lambda s: s.start)

    @classmethod
    def annotated(cls, device: List[Span], host: List[Span]) -> "Trace":
        """The window that the one ``WINDOW_SPAN`` host span bounds."""
        windows = [s for s in host if s.name == WINDOW_SPAN]
        if len(windows) != 1:
            raise ValueError(f"{len(windows)} '{WINDOW_SPAN}' spans in the trace")
        return cls(device, host, windows[0].start, windows[0].end)

    @classmethod
    def device_only(cls, device: List[Span], seconds: float) -> "Trace":
        """A profile of the card alone, started with nothing pending on it
        and stopped once the window's last result was on the host: every
        device span is the window's, and the window lasts ``seconds`` on the
        host's clock from its first device span."""
        lo = min((s.start for s in device), default=0)
        return cls(device, [], lo, lo + int(round(seconds * 1e9)))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-9

    def _busy_segments(self) -> np.ndarray:
        """[r, 2] merged device intervals clipped to the window (ns)."""
        if not self.device:
            return np.zeros((0, 2), np.int64)
        st = np.clip([s.start for s in self.device], self.lo, self.hi)
        en = np.clip([s.end for s in self.device], self.lo, self.hi)
        reach = np.maximum.accumulate(en)
        new = np.ones(len(st), bool)
        new[1:] = st[1:] > reach[:-1]
        first = np.nonzero(new)[0]
        last = np.append(first[1:] - 1, len(st) - 1)
        return np.stack([st[first], reach[last]], axis=1)

    def busy_s(self) -> float:
        seg = self._busy_segments()
        return float((seg[:, 1] - seg[:, 0]).sum()) * 1e-9

    def kernel_s(self, name_part: str) -> Optional[float]:
        """Device seconds of the kernels whose name holds ``name_part``; None
        when there is none."""
        hit = [s for s in self.device if name_part in s.name]
        if not hit:
            return None
        return sum(min(s.end, self.hi) - max(s.start, self.lo)
                   for s in hit) * 1e-9

    def top_device_ops(self, n: int = 10) -> List[list]:
        total: dict = {}
        for s in self.device:
            key = s.name[:NAME_CHARS]
            total[key] = total.get(key, 0) + (min(s.end, self.hi)
                                              - max(s.start, self.lo))
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds summed by the innermost host span open at each gap's
        middle (``BETWEEN_OPS`` when none), the ``n`` largest."""
        seg = self._busy_segments()
        starts = np.concatenate([[self.lo], seg[:, 1]])
        ends = np.concatenate([seg[:, 0], [self.hi]])
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]
        h_start = np.array([s.start for s in self.host], np.int64)
        h_end = np.array([s.end for s in self.host], np.int64)
        total: dict = {}
        for a, b in zip(starts.tolist(), ends.tolist()):
            mid = (a + b) // 2
            label = BETWEEN_OPS
            i = int(np.searchsorted(h_start, mid, side="right")) - 1
            for j in range(i, max(i - _LOOK_BACK, -1), -1):
                if h_end[j] >= mid:
                    label = self.host[j].name[:NAME_CHARS]
                    break
            total[label] = total.get(label, 0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]
