"""stream_scan_ms: mean stream milliseconds a pass between the CUDA events
of the program's ``stream.scan`` spans (``StreamedShardEngine._scan_block``:
kernel B2 or the exact scan, phase 2 and the block's read-back), from the
stream window (``annbench/streamwindow.py``). Moves ``qps``."""

from annbench.streamwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["stream_scan_ms"]
