"""dispatch_idle_pct: the share of the span window, in percent, in which no
kernel, copy or set ran on the card while the host was inside a
``serve.batch`` span before its ``serve.readback``: the card waiting on the
host's launches and syncs, from the span window
(``annbench/spanwindow.py``). Moves ``qps``."""

from annbench.spanwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["dispatch_idle_pct"]
