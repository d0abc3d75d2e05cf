"""phase2_step_ms: mean stream milliseconds a batch between the CUDA events of
the program's ``scan.phase2`` span (``search/bin_scan.py``: the bin pick and
the exact rescore after kernel B1), from the span window
(``annbench/spanwindow.py``). Moves ``qps``."""

from annbench.spanwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["phase2_step_ms"]
