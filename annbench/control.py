"""The readings that the limits of ``correct`` are set from, on the card.

    python -m annbench.control --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 3] [--out PATH]

One set-up serves every seed: for each seed the query pool is drawn anew,
the closed loop runs for ``--seconds`` at the cell's load, and a sample of
the served answers is judged as a run judges it (``cell.compare``): the
program's readings. For each control seed the same judged queries are
answered by the control instead: the configuration's plain reference put in
the program's place and computed one precision lower, TF32 (the program
computes in float32), and judged by the same numbers. A JSON line a reading
goes to standard output and to ``--out``; the last line gives, for each
number, the largest reading of the program and the smallest of the control.

The benchmark's runs never run this. ``annbench/tests/
test_annbench_control.py`` runs the same at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from annbench import datagen
from annbench.cell import (closed_loop, compare, draw_sample, log, setup,
                           truth)
from annbench.judge import invalid_lists
from annbench.spec import Cell, engine_module, load_cell

NUMBERS = ("routed_miss", "dist_err", "invalid_lists")


def readings(cell: Cell, seeds: List[int], control_seeds: List[int],
             seconds: float, device, artifact: Optional[dict] = None,
             emit=print) -> Dict[str, dict]:
    """Program readings on ``seeds``, control readings on ``control_seeds``
    (each also in ``seeds``); returns the summary (module docstring)."""
    device = torch.device(device)
    s = setup(cell, seeds[0], seconds, device, artifact)
    num = s.pool.shape[0]
    s = s._replace(pool=None)
    try:
        return _readings(cell, s, num, seeds, control_seeds, seconds, device,
                         emit)
    finally:
        engine_module(cell.config["serving"]).close(s.engine)


def _readings(cell: Cell, s, num: int, seeds: List[int],
              control_seeds: List[int], seconds: float, device,
              emit) -> Dict[str, dict]:
    cfg, traffic = cell.config, cell.traffic
    tr = truth(s, device)
    program: List[dict] = []
    control: List[dict] = []
    for seed in seeds:
        pool = datagen.device_batches(cfg["data"], cfg["dim"],
                                      cfg["base_seed"], num,
                                      traffic["batch"], seed, device)
        win = closed_loop(s.engine, cfg, pool, seconds)
        sample = draw_sample(win, pool, traffic["judged_queries"], seed)
        values = compare(cfg, tr, sample.queries, sample.ids, sample.dists)
        values["invalid_lists"] = float(invalid_lists(win.ids,
                                                      cfg["num_points"]))
        row = dict(side="program", seed=seed, batches=len(win.ids),
                   judged=int(sample.ids.shape[0]), **values)
        program.append(row)
        emit(row)
        if seed in control_seeds:
            low = compare(cfg, tr, sample.queries, None, None,
                          precision="tf32")
            low["invalid_lists"] = 0.0
            row = dict(side="control", seed=seed,
                       judged=int(sample.ids.shape[0]), **low)
            control.append(row)
            emit(row)
        del pool, win
    summary = {name: {"program_max": max(r[name] for r in program),
                      "control_min": (min(r[name] for r in control)
                                      if control else None)}
               for name in NUMBERS}
    emit({"summary": summary, "seeds": len(program),
          "control_seeds": len(control)})
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m annbench.control",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 2
    seeds = [int(x) for x in args.seeds.split(",")]
    control_seeds = [int(x) for x in args.control_seeds.split(",") if x]
    if not set(control_seeds) <= set(seeds):
        log("every control seed must be one of --seeds")
        return 2
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    t = time.perf_counter()
    try:
        readings(load_cell(args.workload), seeds, control_seeds, args.seconds,
                 "cuda:0", emit=emit)
    finally:
        if out is not None:
            out.close()
    log(f"{args.workload}: {len(seeds)} seeds in "
        f"{time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
