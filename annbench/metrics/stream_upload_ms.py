"""stream_upload_ms: mean host milliseconds a pass inside the program's
``stream.upload`` spans (one a block, ``StreamedShardEngine._stream`` and
``_Staging.upload``: the enqueue of the block's asynchronous copy from its
staging buffer to the card, and the host's wait, if any, for the other
staging buffer's copy), from the stream window
(``annbench/streamwindow.py``). Read as ``stream_upload_ms.host_bound``,
which moves the streamed cell's pace, read per layer as
``window_qps.streamed`` (its ``moves`` in ``BENCHMARK.json`` names
``recall_at_10``, the cell's one end-to-end metric besides
``setup_s``)."""

from annbench.streamwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["stream_upload_ms"]
