"""gpann_tpu_torch — the PyTorch / CUDA port of ``gpann_tpu``.

The package mirrors ``gpann_tpu``'s module paths so that each counterpart is
easy to find. It imports ``torch`` and numpy, never JAX. The hand-written
Hopper kernel (``csrc/bintop2.cu``) is built and loaded at its first launch,
never at import time.

- ``core``    — partitions, point and METIS files, fp32 distance helpers.
- ``search``  — the bin-top-2 scan (``bin_scan``) and the resident serving
  engine (``serve``).
- ``eval``    — ground truth, recall and oracle recall.
- ``cluster`` — Lloyd, balanced and streaming k-means.
- ``graph``   — exact and approximate kNN graphs.
- ``gp``      — the balanced graph partitioner, the non-overlapping
  partitioning methods and GP at scale.
- ``route``   — the flat and k-means-tree routers.
- ``native``  — the partitioner's host C++ ops (built with g++ at first use).
- ``cli``     — the partition CLI.
"""

__version__ = "0.1.0"
