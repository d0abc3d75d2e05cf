"""device_idle_pct: the share of the traced window in which no kernel, copy
or set ran on the card (one less the union of the profiler's device spans
over the window's length), in percent. Moves ``qps``; its
``.host_bound`` twin ``qps.host_bound``, its ``.streamed`` twin the streamed
cell's pace (``window_qps.streamed``)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
