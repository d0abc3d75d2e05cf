"""route_step_ms: mean stream milliseconds a batch between the CUDA events of
the program's ``serve.route`` span (``search/serve.py::_probe_rank``), from
the span window (``annbench/spanwindow.py``). Moves ``qps``."""

from annbench.spanwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["route_step_ms"]
