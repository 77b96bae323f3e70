"""What ``correct`` catches, at a size a test holds, on the CPU.

The control (the reference in float32 with TF32-rounded products, put in
the program's place on the same requests) fails a number of each cell,
under the cell's own limits; each biased draw fails a number of the
permutation cell; and a run whose timed path is broken underneath — an
answer altered where it is produced, half of a batch left out with the
mean of the rest in its place, a draw that is not uniform — comes out not
correct.
The control runs at each configuration's ``"control"`` size, the drivers
at its ``"tiny"`` one (``tests/sizes/configs/``); each cell's broken paths
are the ``FAULTS`` of ``tests/faults/<cell>.py``. The chip runs the control
at the cells' own size (``perfbench/control.py``).
"""

from __future__ import annotations

import pytest

import perfbench_testkit as kit
from harness import bench


@pytest.mark.parametrize("cell", kit.CELLS)
def test_the_control_fails_and_the_program_passes(cell):
    run = kit.tiny_run(cell, seconds=0.5, control=True)
    driver = bench.load_module("drivers", run.cell["driver"])
    out = kit.control_module().readings(run, driver, control=True)
    limits = run.cell["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control"][k] > v for k, v in limits.items()), out


def test_each_biased_draw_fails_a_number_of_the_permutation_cell():
    run = kit.tiny_run("st76k.perm1000", seconds=0.5, control=True)
    driver = bench.load_module("drivers", run.cell["driver"])
    out = kit.control_module().readings(run, driver, control=True)
    limits = run.cell["limits"]
    assert set(out["faults"]) == set(driver.DRAW_FAULTS)
    for fault, numbers in out["faults"].items():
        assert any(numbers[k] > limits.get(k, 0.0) for k in numbers), (fault, numbers)


@pytest.mark.parametrize("cell,fault", kit.fault_cases())
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    owner, attr, breaker = kit.faults(cell)[fault]
    monkeypatch.setattr(owner, attr, breaker(getattr(owner, attr)))
    res = kit.execute(kit.tiny_run(cell))
    assert res["correct"] is False, res["check"]
