"""Multi-rank layer: a (dp, shard) layout of ``torch.distributed`` ranks,
probed search and routed serving with a collective top-k merge, and a
sharded Lloyd round (counterpart of ``gpann_tpu/dist``).

Nothing is built or launched at import time; :mod:`.launch` starts local
ranks for tests and smoke runs.
"""

from gpann_tpu_torch.dist.mesh import (
    DistributedIVF,
    DistributedServingEngine,
    shard_mesh,
    sharded_lloyd_round,
)

__all__ = [k for k in dir() if not k.startswith("_")]
