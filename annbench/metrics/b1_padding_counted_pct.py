"""b1_padding_counted_pct: 100 x (1 - ``b1.rows_real`` / ``b1.rows_scanned``),
the program's counters of the block rows that kernel B1 scans, over every
batch of the span window, from the span window (``annbench/spanwindow.py``).
Moves ``qps``."""

from annbench.spanwindow import window


def read(ctx):
    w = window(ctx)
    return None if w is None else w["b1_padding_counted_pct"]
