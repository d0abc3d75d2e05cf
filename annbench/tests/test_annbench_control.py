"""The control at a small size: the plain reference put in the program's
place one precision lower (TF32) fails a limit of ``correct`` that the
program's own answers keep. On the CPU, TF32 is emulated by rounding both
operands (``reference._round_tf32``); the ``gpu`` case uses the card's."""

import pytest

from annbench.control import readings
from annbench.tests.tiny import LIMITS, tiny_artifact, tiny_cell

SEEDS = [2**31 + 3, 2**31 + 4, 2**31 + 5]


def _check(summary):
    for name, limit in LIMITS.items():
        assert summary[name]["program_max"] <= limit
    assert any(summary[name]["control_min"] > limit
               for name, limit in LIMITS.items())
    # dist_err separates the two by orders of magnitude
    assert (summary["dist_err"]["control_min"]
            > 100 * summary["dist_err"]["program_max"])


def test_control_fails_where_the_program_passes_on_the_cpu():
    cell = tiny_cell()
    _check(readings(cell, SEEDS, SEEDS, 0.2, "cpu",
                    artifact=tiny_artifact(cell.config), emit=lambda r: None))


@pytest.mark.gpu
def test_control_fails_where_the_program_passes_on_the_card(cuda_device):
    cell = tiny_cell(batch=256)
    _check(readings(cell, SEEDS, SEEDS, 0.5, cuda_device,
                    artifact=tiny_artifact(cell.config), emit=lambda r: None))
