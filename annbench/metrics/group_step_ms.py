"""group_step_ms: mean stream milliseconds a batch between the CUDA events of
the program's ``serve.group`` span (``search/serve.py::_group``), from the
span window (``annbench/spanwindow.py``). Moves ``qps``."""

from annbench.spanwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["group_step_ms"]
