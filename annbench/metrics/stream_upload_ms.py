"""stream_upload_ms: mean host milliseconds a pass inside the program's
``stream.upload`` spans (``StreamedShardEngine._scan_block``: each block's
copy to the card and the wait for it), from the stream window
(``annbench/streamwindow.py``). Moves ``qps``."""

from annbench.streamwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["stream_upload_ms"]
