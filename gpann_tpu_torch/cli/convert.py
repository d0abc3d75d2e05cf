"""Convert CLI of the PyTorch port — re-run the combination/Pareto analysis
from saved artifacts (counterpart of ``gpann_tpu/cli/convert.py``;
reference ``convert.cpp``, C20, active branch ``convert.cpp:63-90``).

Reload ``*.routes`` + ``*.searches`` and regenerate the CSV + Pareto without
re-searching (stage-checkpoint re-analysis). Host numpy only (no
``--device``); the files read and written are the JAX CLI's.

Usage:
    python -m gpann_tpu_torch.cli.convert \
        <routes_file> <searches_file> <num_shards> <requested_shards> <k> \
        <out_prefix> [part_method]
"""

from __future__ import annotations

import sys

from gpann_tpu_torch.eval.combination import (
    CSV_HEADER,
    combine_routes_and_searches,
    deserialize_routes,
    deserialize_searches,
    pareto_filter,
)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 6:
        print(__doc__)
        return 2
    routes_file, searches_file = argv[:2]
    num_shards, requested_shards, k = map(int, argv[2:5])
    out_prefix = argv[5]
    part_method = argv[6] if len(argv) > 6 else "GP"

    routes = deserialize_routes(routes_file)
    searches = deserialize_searches(searches_file)
    num_queries = len(routes[0].buckets_to_probe)
    rows = combine_routes_and_searches(
        routes, searches, num_queries, num_shards, requested_shards, k,
        partition_method=part_method,
    )
    with open(out_prefix + ".csv", "w") as f:
        f.write(CSV_HEADER + "\n" + "\n".join(rows) + "\n")
    front = pareto_filter(rows)
    with open(out_prefix + ".pareto", "w") as f:
        f.write(CSV_HEADER + "\n" + "\n".join(front) + "\n")
    print(f"re-analyzed {len(routes)} routes x {len(searches)} searches -> "
          f"{len(rows)} rows, {len(front)} pareto")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
