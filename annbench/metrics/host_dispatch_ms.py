"""host_dispatch_ms: mean host milliseconds a batch from the start of the
program's ``serve.batch`` span to the start of its ``serve.readback``: the
steps' enqueueing plus any wait on a sync inside them, from the span window
(``annbench/spanwindow.py``). Moves ``qps``."""

from annbench.spanwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["host_dispatch_ms"]
