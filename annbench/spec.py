"""What a cell is made of, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and the
metrics with the cells that report them. The files behind the names:

- ``annbench/configs/<config>.json``: the deployment (data, index, engine,
  routing); its ``serving`` names the engine module, its ``data`` the data
  and its ``metric`` the plain reference;
- ``annbench/engines/<serving>.py``: how the harness builds, serves through
  and closes one of the program's engines;
- ``annbench/datagen/<data>.py``, for a ``data`` that
  ``annbench/datagen/__init__.py`` does not draw itself
  (``datagen.BUILT_IN``): the base, the shipped ground truth's queries and
  the traffic of that data (``datagen.named``; the functions it gives are
  listed there);
- ``annbench/reference/<metric>.py``, for a ``metric`` other than ``"l2"``:
  the plain reference that judges the configuration, as
  ``annbench/reference/__init__.py``, the squared-L2 reference, judges
  ``"l2"`` (:func:`reference_module`; the functions it gives are listed
  there);
- ``annbench/traffic/<traffic>.json``: the mix (loop, batch, query pool);
- ``annbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``;
- ``annbench/metrics/<metric>.py``: the reader of a per-layer metric.

Each module is found by its file, with no list in code: a configuration
that names a file that is not there fails in :func:`load_cell`, with the
path, before any work.

A metric named ``<quantity>.<regime>`` is its quantity in the cells of one
regime (cells whose runs spread alike, and so share a bound): an end-to-end
one reads ``<quantity>``, a per-layer one ``metrics/<quantity>.py`` unless
``metrics/<metric>.py`` is there.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

from annbench import datagen, module_at, reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list     # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = _load_json(benchmark)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark.name}; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    config = _load_json(HERE / "configs" / f"{w['config']}.json")
    engine_module(config["serving"])
    if config["data"] not in datagen.BUILT_IN:
        datagen.named(config["data"])
    reference_module(config["metric"])
    return Cell(
        name=name,
        config=config,
        traffic=_load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(HERE / "limits" / f"{name}.json")["limits"],
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def quantity(metric: str) -> str:
    """What a metric measures: its name up to the first dot."""
    return metric.split(".", 1)[0]


def reader(metric: str):
    """The ``read(ctx)`` function of ``annbench/metrics/<metric>.py``, else
    of ``annbench/metrics/<quantity>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{quantity(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        "annbench.metrics." + metric.replace(".", "__"), path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@functools.lru_cache(maxsize=None)
def engine_module(serving: str):
    """The module ``annbench/engines/<serving>.py``: ``build``, ``serve``,
    ``grouping`` and ``close`` of one of the program's engines."""
    path = HERE / "engines" / f"{serving}.py"
    if not path.exists():
        raise FileNotFoundError(f"no engine {serving!r} at {path}")
    return importlib.import_module(f"annbench.engines.{serving}")


def reference_module(metric: str):
    """The plain reference of ``metric``: the package ``annbench/reference``
    (squared L2) for ``"l2"``, else the module
    ``annbench/reference/<metric>.py`` (``annbench.module_at``)."""
    if metric == "l2":
        return reference
    path = HERE / "reference" / f"{metric}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reference for metric {metric!r} at "
                                f"{path}")
    return module_at(path)
