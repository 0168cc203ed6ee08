"""The check that decides `correct`, driven through the rest of a run at a
tiny size on the CPU (the harness's look for a card skipped): a sound run
passes; each fault the cell can have, planted in the port's timed path,
and the control (the reference with its products in fp8 in the program's
place) fail, against the cell's own limits."""

import pytest

from benchmark import faults, harness
from conftest import tiny_cell

CELLS = ["dsg_ref_unet256.ddim50_b8", "dsg_cond128.cfg_ddim50_b32", "dsg_ref_unet256.train_b14"]
SEED = 3_000_000_019


def run(name):
    spec, cell, config = tiny_cell(name)
    return harness.run_cell(spec, name, cell, config, SEED, 0.2, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    _, cell, _ = tiny_cell(name)
    with faults.FAULTS[fault](cell["kind"]):
        res = run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    _, cell, config = tiny_cell(name)
    checks = harness.traffic_module(cell["kind"]).Cell(cell, config, SEED, "cpu").control_check()
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
