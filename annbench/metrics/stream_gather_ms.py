"""stream_gather_ms: mean host milliseconds a pass inside the program's
``stream.gather`` spans (``StreamedShardEngine.shard_block``: the host read
of each probed shard's rows from the store), from the stream window
(``annbench/streamwindow.py``). Moves ``qps``."""

from annbench.streamwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["stream_gather_ms"]
