"""b1_roofline: kernel B1's share of its roofline over the traced window, in
percent: the least time that the card's published peaks allow for the
window's B1 work (``annbench/roofline.py``: operations and bytes from each
served batch's grouping, ``ServingEngine.scan_inputs``) over the device time
of the ``bintop2`` kernels in the profiler's trace; nothing for an engine
that scans no such blocks. Moves ``qps``."""

from annbench.roofline import b1_bytes, b1_ops, roofline_pct

KERNEL = "bintop2"


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.kernel_s(KERNEL)
    if seconds is None:
        return None
    d = ctx.config["dim"]
    ops = nbytes = 0.0
    for i in ctx.served:
        grouping = ctx.grouping(i)
        if grouping is None:
            return None
        live_q, sizes, row_off = grouping
        ops += b1_ops(live_q, sizes, d)
        nbytes += b1_bytes(live_q, sizes, row_off, d)
    return roofline_pct(ops, nbytes, seconds, ctx.kind)
