"""merge_step_ms: mean stream milliseconds a batch between the CUDA events of
the program's ``serve.merge`` span (the per-query top-k merge in
``ServingEngine._pipeline``), from the span window
(``annbench/spanwindow.py``). Moves ``qps``."""

from annbench.spanwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["merge_step_ms"]
