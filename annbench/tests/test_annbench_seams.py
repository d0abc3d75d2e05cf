"""A configuration's data and plain reference, found by name: a stand-in
for each, handed over by patching the function that finds it, runs the tiny
cell as the built-in one does or is judged by it; a name with no file fails
in ``load_cell``; a file named as one of its package's functions hides
nothing; every data and reference module imports nothing of the program or
of JAX; the judge's ``dist_err`` is over the reference's ``dist_scale``."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import annbench
from annbench import datagen, judge, spec
from annbench import reference as l2
from annbench.cell import Truth, compare, run_cell
from annbench.tests.tiny import tiny_artifact, tiny_cell

SEED = 2**31 + 91
OUTSIDE = {"gpann_tpu_torch", "gpann_tpu", "jax", "jaxlib", "flax"}
GIVES = {"datagen": ("base_and_check_queries", "device_batches"),
         "reference": ("reference_answers", "exact_distances", "dist_scale")}


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell()
    return cell, tiny_artifact(cell.config)


def _config(cell, **keys):
    return cell._replace(config=dict(cell.config, **keys))


def _stand_in(monkeypatch, owner, finder: str, name: str, module) -> None:
    """``owner.<finder>`` finds ``module`` under ``name``, every other name
    as before."""
    real = getattr(owner, finder)

    def find(wanted):
        return module if wanted == name else real(wanted)
    monkeypatch.setattr(owner, finder, find)


def _hard_under(monkeypatch, name: str) -> list:
    """A data module ``name`` that draws the built-in ``hard`` data; returns
    the list of its calls."""
    calls = []

    def base(n, d, nq, seed):
        calls.append("base")
        return datagen.base_and_check_queries("hard", n, d, nq, seed)

    def batches(d, base_seed, num_batches, m, seed, device):
        calls.append("batches")
        return datagen.device_batches("hard", d, base_seed, num_batches, m,
                                      seed, device)
    _stand_in(monkeypatch, datagen, "named", name, SimpleNamespace(
        base_and_check_queries=base, device_batches=batches))
    return calls


def _l2_as(monkeypatch, **functions) -> None:
    """The reference of ``"l2"`` is the L2 reference with ``functions`` in
    place of its own."""
    _stand_in(monkeypatch, spec, "reference_module", "l2", SimpleNamespace(
        **{**{f: getattr(l2, f) for f in GIVES["reference"]}, **functions}))


def _shifted(monkeypatch) -> None:
    """Every exact distance of the reference one more."""
    _l2_as(monkeypatch, exact_distances=lambda q, base, ids: (
        l2.exact_distances(q, base, ids) + 1.0))


def test_a_data_kind_under_another_name_gives_a_correct_run(tiny,
                                                            monkeypatch):
    calls = _hard_under(monkeypatch, "hard_again")
    cell, art = tiny
    r = run_cell(_config(cell, data="hard_again"), SEED, 0.3, False, "cpu",
                 0.0, artifact=art)
    assert r["correct"] is True and r["failed"] == 0
    # the base, the window's pool and the warm-up's pool
    assert calls == ["base", "batches", "batches"]


def test_a_reference_that_shifts_every_distance_fails_the_judge(
        tiny, monkeypatch):
    cell, art = tiny
    r = run_cell(cell, SEED, 0.3, False, "cpu", 0.0, artifact=art)
    assert r["correct"] is True
    _shifted(monkeypatch)
    # set-up's check of the base uses the same reference and would refuse
    # the shift first (next test); opened here, the judge sees it
    r = run_cell(_config(cell, check_rtol=np.inf), SEED, 0.3, False, "cpu",
                 0.0, artifact=art)
    assert r["correct"] is False
    dist_err = r["checks"]["dist_err"]
    assert dist_err["value"] > dist_err["limit"]


def test_set_up_checks_the_base_with_the_configurations_reference(
        tiny, monkeypatch):
    _shifted(monkeypatch)
    cell, art = tiny
    with pytest.raises(RuntimeError, match="gt_dists"):
        run_cell(cell, SEED, 0.3, False, "cpu", 0.0, artifact=art)


def test_an_unknown_data_kind_names_the_file_looked_for():
    with pytest.raises(ValueError, match="datagen/sift.py"):
        datagen.base_and_check_queries("sift", 10, 4, 2, 1)
    with pytest.raises(ValueError, match="datagen/sift.py"):
        datagen.device_batches("sift", 4, 1, 1, 2, 3, "cpu")


def _loading(monkeypatch, **keys) -> None:
    """``load_cell`` reads every configuration with ``keys`` set."""
    real = spec._load_json

    def load(path):
        got = real(path)
        return dict(got, **keys) if path.parent.name == "configs" else got
    monkeypatch.setattr(spec, "_load_json", load)


@pytest.mark.parametrize("keys, error, match", [
    ({"metric": "mips"}, FileNotFoundError, "'mips' at .*reference/mips.py"),
    ({"data": "nowhere"}, ValueError, "'nowhere'.* at .*datagen/nowhere.py"),
])
def test_a_configuration_that_names_a_missing_module_fails_in_load_cell(
        monkeypatch, keys, error, match):
    _loading(monkeypatch, **keys)
    with pytest.raises(error, match=match):
        spec.load_cell("hard8m-b4096")


def test_load_cell_takes_another_metric_with_its_own_reference(monkeypatch):
    _stand_in(monkeypatch, spec, "reference_module", "mips", l2)
    _loading(monkeypatch, metric="mips")
    assert spec.load_cell("hard8m-b4096").config["metric"] == "mips"


def test_a_file_named_as_a_function_of_its_package_hides_nothing(
        tmp_path, monkeypatch):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "search.py").write_text("WHO = 'search'\n")
    (tmp_path / "hard_base.py").write_text("WHO = 'hard_base'\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    monkeypatch.setattr(datagen, "HERE", tmp_path)
    search, hard_base = l2.search, datagen.hard_base
    assert spec.reference_module("search").WHO == "search"
    assert datagen.named("hard_base").WHO == "hard_base"
    assert l2.search is search and datagen.hard_base is hard_base


def _found_modules():
    here = Path(annbench.__file__).parent
    return sorted(p.relative_to(here).as_posix() for folder in GIVES
                  for p in (here / folder).glob("*.py"))


@pytest.mark.parametrize("file", _found_modules())
def test_every_data_and_reference_module_imports_nothing_of_the_program(
        file):
    """Each file of ``datagen/`` and ``reference/``, a module added later
    too, loaded alone as ``spec`` and ``datagen`` load it, gives its
    functions and loads nothing of the program or of JAX."""
    folder, name = file.split("/")
    load = (f"importlib.import_module('annbench.{folder}')"
            if name == "__init__.py" else
            f"annbench.module_at(Path(annbench.__file__).parent / {file!r})")
    code = ("import importlib, json, sys\nfrom pathlib import Path\n"
            f"import annbench\nm = {load}\n"
            f"print(json.dumps([[f for f in {GIVES[folder]!r} "
            "if not callable(getattr(m, f, None))], "
            "sorted({k.split('.')[0] for k in sys.modules})]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    missing, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert missing == []
    assert not set(loaded) & OUTSIDE


def _tiny_truth():
    rng = np.random.default_rng(4)
    base = torch.as_tensor(rng.standard_normal((2000, 12), np.float32))
    q = torch.as_tensor(rng.standard_normal((30, 12), np.float32))
    shard_of = torch.as_tensor(rng.integers(0, 4, 2000))
    cfg = {"k": 10, "num_shards": 4, "voting_t": 8, "nprobes": 2}
    return cfg, Truth(base, shard_of, base[::10], shard_of[::10]), q


def test_the_control_reaches_the_metrics_reference_at_both_precisions(
        monkeypatch):
    cfg, tr, q = _tiny_truth()
    want = compare(cfg, tr, q, None, None, precision="tf32")
    asked = []

    def answers(*a, precision="fp32"):
        asked.append(precision)
        return l2.reference_answers(*a, precision=precision)
    _l2_as(monkeypatch, reference_answers=answers)
    got = compare(dict(cfg, metric="l2"), tr, q, None, None,
                  precision="tf32")
    assert got == want and asked == ["fp32", "tf32"]


def test_dist_err_is_over_the_references_dist_scale(monkeypatch):
    cfg, tr, q = _tiny_truth()
    ans = l2.reference_answers(q, tr.base, tr.shard_of, tr.routing_points,
                               tr.routing_labels, 4, 8, 2, 10)
    ids = ans.routed.ids
    dists = (ans.routed.dists * (1 + 1e-3)).float()
    one = compare(cfg, tr, q, ids, dists)
    assert one["dist_err"] > 0
    _l2_as(monkeypatch, dist_scale=lambda q, base, ids, d: 2 * d.abs())
    two = compare(cfg, tr, q, ids, dists)
    assert two["dist_err"] == one["dist_err"] / 2
    assert {k: v for k, v in two.items() if k != "dist_err"} == {
        k: v for k, v in one.items() if k != "dist_err"}


def test_dist_err_over_the_l2_scale():
    # a distance that a metric shifts below 0, as 1 - q.x does: its
    # magnitude
    exact = torch.tensor([[-9.0, -5.0, np.inf]], dtype=torch.float64)
    served = torch.tensor([[-9.0, -4.5, 3.0]])
    kth = torch.tensor([[-4.0]], dtype=torch.float64)
    scale = l2.dist_scale(None, None, None, kth)[:, 0]
    assert judge.dist_err(served, exact, scale) == 0.125
    # squared L2: what the formula before the scale, over the k-th
    # distance, gives, to the bit
    g = torch.Generator().manual_seed(11)
    diff = torch.randn((64, 10, 16), generator=g, dtype=torch.float64)
    exact = (diff ** 2).sum(-1)
    exact[3, 4] = np.inf
    served = (exact + 1e-4 * torch.randn(exact.shape, generator=g,
                                         dtype=torch.float64)).float()
    kth = exact[:, 9].clone()
    kth[3] = (diff[3, 0] ** 2).sum()
    scale = l2.dist_scale(None, None, None, kth[:, None])[:, 0]
    gap = (served.double() - exact).abs() / kth.double()[:, None]
    assert judge.dist_err(served, exact, scale) == float(
        gap[torch.isfinite(exact)].max())
