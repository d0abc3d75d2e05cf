"""gpann_tpu_torch — the PyTorch / CUDA port of ``gpann_tpu``.

The package mirrors ``gpann_tpu``'s module paths so that each counterpart is
easy to find. It imports ``torch`` and numpy, never JAX. The hand-written
Hopper kernel (``csrc/bintop2.cu``) is built and loaded at its first launch,
never at import time, and no subpackage builds, loads or launches anything
when it is imported.

- ``core``    — partitions, point and METIS files, fp32 distance helpers,
  the timer and the profiler trace.
- ``search``  — the bin-top-2 scan (``bin_scan``), the shard-major IVF index
  and its probed scans (``ivf``), the resident serving engine (``serve``),
  the two-level index and the in-shard sweep (``two_level``,
  ``shard_sweep``), the shard-major store (``relayout``) and the streamed
  engine for bases larger than the device (``streamed``).
- ``eval``    — ground truth, recall and oracle recall (``recall``), the
  data generators (``synth``) and the query-attribution tables
  (``combination``).
- ``cluster`` — Lloyd, balanced and streaming k-means.
- ``graph``   — exact and approximate kNN graphs.
- ``gp``      — the balanced graph partitioner, the partitioning methods
  (overlapping ones included) and GP at scale.
- ``route``   — the flat and k-means-tree routers and their sweeps.
- ``dist``    — the multi-rank engines over ``torch.distributed`` (a (dp,
  shard) layout of ranks, collective top-k merge, sharded Lloyd round) and
  a launcher of local ranks.
- ``native``  — the host C++ ops (graph ops, the ``hard2`` generator; built
  with g++ at first use).
- ``cli``     — the command-line drivers: partition, query attribution,
  small-scale queries, oracle recall, convert, bench, scale bench, the
  three analysis CLIs, distributed bench and the two experiment drivers.
- ``entry``   — one probed scan on one device and a multi-rank dry run
  (``python -m gpann_tpu_torch.entry``).
"""

__version__ = "0.1.0"
