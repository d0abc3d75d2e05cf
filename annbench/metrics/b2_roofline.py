"""b2_roofline: kernel B2's share of its roofline over the traced window, in
percent: the least time that the card's published peaks allow for the
window's B2 work (``annbench/roofline_b2.py``: operations and bytes from
each served batch's probe order, ``StreamedShardEngine.probe_order``) over
the device time of the ``bintop2`` kernels in the profiler's trace (in a
streamed cell only B2 launches them: routing's vote is ``torch.topk``);
nothing for an engine without a probe order over streamed shards. Read as
``b2_roofline.host_bound`` in the streamed cell, whose rate is read per
layer (``window_qps.streamed``)."""

from annbench.roofline import roofline_pct
from annbench.roofline_b2 import b2_bytes, b2_ops, b2_work

KERNEL = "bintop2"


def read(ctx):
    if ctx.trace is None:
        return None
    program = getattr(ctx.engine, "engine", None)
    if not hasattr(program, "probe_order"):
        return None
    seconds = ctx.trace.kernel_s(KERNEL)
    if seconds is None:
        return None
    d = ctx.config["dim"]
    ops = nbytes = 0.0
    for i in ctx.served:
        mq, sizes = b2_work(program, ctx.config, ctx.pool[i].cpu().numpy())
        ops += b2_ops(mq, sizes, d)
        nbytes += b2_bytes(mq, sizes, d)
    return roofline_pct(ops, nbytes, seconds, ctx.kind)
