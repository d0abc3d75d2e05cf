"""In-shard search layer: the exact block scan and rescore that every engine
shares, the bin-top-2 scan, the IVF index, the resident serving engine, the
shard-major store and the streamed engine.

Import the submodules directly (``gpann_tpu_torch.search.serve``,
``gpann_tpu_torch.search.ivf``, ...). Unlike ``gpann_tpu/search``, which
exports ``IVFIndex``, ``hits_per_shard`` and ``merge_shard_topk``, this
package imports nothing at import time: importing it builds, loads and
launches nothing, and a caller pays only for the submodules it uses.
"""
