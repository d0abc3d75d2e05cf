"""The program's engines, one module each, found by the name in a
configuration's ``serving`` (``spec.engine``).

Each ``<serving>.py`` gives the harness four functions:

- ``build(base, shard_of, routing_points, routing_labels, cfg, device)``:
  the program's engine, from the benchmark's own base ([n, d] float32 on
  the host), the shipped partition (the shard of each row), the routing
  points and their labels, the configuration and the device; inside
  ``setup_s``;
- ``serve(engine, cfg, queries)``: one batch ([m, d] on the device, where
  the harness keeps its pool) through the program's public entry; host
  ``(dists [m, k], ids [m, k])``, ids -1 where a list is short;
- ``grouping(engine, cfg, queries)``: the batch's ``(live_q, sizes,
  row_off)`` as numpy arrays, the blocks that kernel B1 scans, or None for
  an engine that scans no such blocks;
- ``close(engine)``: removes whatever the engine wrote; it runs when the run
  ends, failed runs included.
"""
