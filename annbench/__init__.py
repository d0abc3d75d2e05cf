"""The benchmark of ``gpann_tpu_torch`` on one H100 (``BENCHMARK.json``).

    python3 -m annbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

- ``run.py``: the command; ``cell.py``: set-up, the closed-loop window, the
  per-layer readers, the judgement and the result line;
- ``spec.py``: a cell's files found by name: ``configs/<config>.json``,
  ``traffic/<traffic>.json``, ``limits/<cell>.json``,
  ``metrics/<metric>.py``, and ``engines/<serving>.py``, the program's
  engine that the configuration names (``resident``: every shard on the
  card; ``streamed``: the base on the host, a pass a batch),
  ``datagen/<data>.py`` for data that is not built in, and
  ``reference/<metric>.py`` for a metric other than ``l2``;
- ``datagen/``: frozen copies of the repository's generators and the
  query traffic; ``reference/``: the plain squared-L2 reference; ``judge.py``:
  the numbers that decide ``correct``; ``roofline.py``: peaks and B1's work;
  ``trace.py``: the profiler's trace;
- ``control.py``: the readings the limits were set from (not run by the
  benchmark); ``tests/``: its CPU tests (``python -m pytest annbench/tests``).

It imports nothing of JAX and nothing of the JAX package; ``reference/`` and
``datagen/`` import nothing of the program either.
"""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path


@functools.lru_cache(maxsize=None)
def module_at(path: Path):
    """The module of the file ``path``, loaded once under a private name
    (``_annbench_<folder>_<stem>``). It is bound as no package's
    attribute, so a file named as one of its package's functions
    (``reference/search.py``, ``datagen/hard_base.py``) hides nothing."""
    name = f"_annbench_{path.parent.name}_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
