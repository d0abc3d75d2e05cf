"""The benchmark of ``gpann_tpu_torch`` on one H100 (``BENCHMARK.json``).

    python3 -m annbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

- ``run.py``: the command; ``cell.py``: set-up, the closed-loop window, the
  per-layer readers, the judgement and the result line;
- ``spec.py``: a cell's files found by name: ``configs/<config>.json``,
  ``traffic/<traffic>.json``, ``limits/<cell>.json``,
  ``metrics/<metric>.py``, and ``engines/<serving>.py``, the program's
  engine that the configuration names (``resident``: every shard on the
  card; ``streamed``: the base on the host, a pass a batch);
- ``datagen/``: frozen copies of the repository's generators and the
  query traffic; ``reference/``: the plain reference; ``judge.py``: the
  numbers that decide ``correct``; ``roofline.py``: peaks and B1's work;
  ``trace.py``: the profiler's trace;
- ``control.py``: the readings the limits were set from (not run by the
  benchmark); ``tests/``: its CPU tests (``python -m pytest annbench/tests``).

It imports nothing of JAX and nothing of the JAX package; ``reference/``
imports nothing of the program either.
"""
