"""Each driver's control flow at a tiny size on the program's CPU route,
untraced and traced, and the last line's schema."""

from __future__ import annotations

import pytest

import perfbench_testkit as kit
from harness import bench


@pytest.fixture
def device():
    """These tests hold the CPU route; a card, where present, is not used."""
    import torch
    return torch.device("cpu")


def _check_line(res: dict, cell: str, trace: bool) -> None:
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for n in res["check"].values():
        assert set(n) == {"value", "limit"} and n["value"] <= n["limit"]
    specs = bench.cell_metrics(kit.benchmark(), cell, trace)
    names = {m["name"] for m in specs}
    if trace:
        # everything but what the device trace gives (no card here)
        assert set(res["metrics"]) == {m["name"] for m in specs
                                       if m["source"] != "device_trace"}
    else:
        assert set(res["metrics"]) == names


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", kit.CELLS)
def test_cell_plays_checks_and_reports(cell, trace, device):
    run = kit.tiny_run(cell, trace=trace)
    assert run.device == device
    res = kit.execute(run)
    _check_line(res, cell, trace)
    # the window ends with its last request; every request returned in it
    assert run.t_end >= run.deadline or not run.requests
    assert all(r.t1 <= run.t_end for r in run.requests)


def test_served_cells_count_what_they_served(device):
    run = kit.tiny_run("st76k.perm1000")
    res = kit.execute(run)
    done = run.done()
    perms = sum(r.units["perms"] for r in done)
    assert res["metrics"]["perm_per_s"]["value"] == pytest.approx(perms / run.window_s)
    assert run.counters["labels_evaluated"][0] == perms
    occupancy = run.counters["gather_window_occupancy"]
    assert occupancy[1] == len(done)


def test_fresh_subjects_build_one_plan_each_and_leave_nothing_registered(device):
    run = kit.tiny_run("st76k.fresh")
    kit.execute(run)
    assert run.counters["plans_built"][0] == len(run.requests)
    assert len(run.state["kind"].free) == run.traffic["subjects"]
