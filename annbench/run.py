"""The benchmark's command: one run of one cell on the card.

    python -m annbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. It regenerates the cell's base, loads the
shipped index, builds the program's serving engine, serves query batches
drawn from ``--seed`` in a closed loop for ``--seconds``, judges a sample of
the served answers against the configuration's plain reference,
and prints one JSON line last on standard output: ``correct``,
``attempted`` and ``failed`` (queries, and those with an invalid answer
list), ``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics from a window with the card profiled with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown`` of the trace,
``reused_batches`` (window batches served a second time because the program
outran the query pool; 0 in a sound cell), and last ``checks``: each number
judged with its limit, also printed as the last lines of standard error.

It exits with a code other than 0 and prints no result line when there is
no CUDA card (it never falls back to the CPU), when the cell or a file it
names is missing, or when JAX or the JAX package is loaded once the window
has closed.
"""

import time

T0 = time.perf_counter()   # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.stdout.strip() or out.stderr.strip()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m annbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from annbench.cell import forbidden_modules, log, run_cell
    from annbench.spec import load_cell

    cell = load_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T0)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
