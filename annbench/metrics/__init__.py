"""Per-layer metric readers, one file each, found by the metric's name.

Each ``<metric>.py`` defines ``read(ctx) -> float | None`` over an
:class:`annbench.cell.Ctx`; ``None`` when it finds nothing to read there
(no card, no trace, no kernel of its kind), and the metric is then left out
of the result line.
"""
