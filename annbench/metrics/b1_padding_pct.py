"""b1_padding_pct: padding rows in the blocks that kernel B1 scans, over all
rows of those blocks, in the engine's grouping (``search/serve.py::_group``)
of the first ``BATCHES`` pool batches, read from the public
``ServingEngine.scan_inputs`` (``live_q``, ``sizes``). A count that repeats
exactly for a seed; nothing for an engine that scans no such blocks. Moves
``qps``."""

import numpy as np

from annbench.roofline import padding_pct

BATCHES = 64


def read(ctx):
    parts = [ctx.grouping(i) for i in range(min(BATCHES, ctx.pool.shape[0]))]
    if None in parts:
        return None
    live_q = np.concatenate([p[0] for p in parts])
    sizes = np.concatenate([p[1] for p in parts])
    return padding_pct(live_q, sizes, ctx.config["query_block"])
