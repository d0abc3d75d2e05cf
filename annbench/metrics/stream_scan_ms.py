"""stream_scan_ms: mean stream milliseconds a pass between the CUDA events
of the program's ``stream.scan`` spans (one a block,
``StreamedShardEngine._scan`` on the compute stream after its wait on the
block's copy: the widening, kernel B2 or the exact scan, phase 2, and the
enqueue of the results' copy to the host, which the pass takes two blocks
later, outside every span), from the stream window
(``annbench/streamwindow.py``). Read as ``stream_scan_ms.host_bound``,
which moves the streamed cell's pace, read per layer as
``window_qps.streamed`` (its ``moves`` in ``BENCHMARK.json`` names
``recall_at_10``, the cell's one end-to-end metric besides
``setup_s``)."""

from annbench.streamwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["stream_scan_ms"]
