"""window_qps: every query answered in the traced window over all of its
time on the host's clock, in queries/s: the end-to-end ``qps`` quantity,
read per layer in a cell whose runs spread too widely for an end-to-end
bound (``window_qps.streamed``: the host's page-cache read sets the
streamed cell's pace and moves with the shared host). The window is the
one with the card profiled alone, so the host runs at its own pace. Nothing
off a card."""


def read(ctx):
    if ctx.trace is None or ctx.device.type != "cuda" or not ctx.served:
        return None
    return len(ctx.served) * ctx.traffic["batch"] / ctx.trace.window_s
