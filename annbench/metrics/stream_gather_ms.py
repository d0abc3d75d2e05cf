"""stream_gather_ms: mean host milliseconds a pass inside the program's
``stream.gather`` spans (one a block, ``StreamedShardEngine._stream`` and
``_Staging.fill``: the fill of a page-locked staging buffer with the
block's rows from the store, over the engine's reader threads; a shard's
first block also its ``_reader`` lookup), from the stream window
(``annbench/streamwindow.py``). Read as ``stream_gather_ms.host_bound``,
which moves the streamed cell's pace, read per layer as
``window_qps.streamed`` (its ``moves`` in ``BENCHMARK.json`` names
``recall_at_10``, the cell's one end-to-end metric besides
``setup_s``)."""

from annbench.streamwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["stream_gather_ms"]
