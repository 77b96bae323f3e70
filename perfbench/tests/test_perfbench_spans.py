"""The readers of the program's own spans: ``fingerprint_ms.fresh``,
``draw_ms.perm`` and ``grid_plan_ms``, on hand-built runs and in a traced
CPU run of each served cell.

Each reader returns None where there is nothing to read (an untraced run,
a program without the span), as a parent without these spans gives."""

from __future__ import annotations

import pytest

import perfbench_testkit as kit
from harness import bench


def _reader(name: str):
    return bench.load_module("metrics", name).read


def _run(cell: str, trace: bool = True):
    run = kit.tiny_run(cell, trace=trace)
    run.t_begin, run.t_end = 0.0, 1.0
    return run


def _done(run, units: dict, n: int) -> None:
    for i in range(n):
        run.requests.append(bench.Request("r", float(i), float(i) + 0.5, units=units))


def test_draw_ms_reads_draw_spans_over_completed_requests():
    read = _reader("draw_ms.perm")
    run = _run("st76k.perm1000")
    assert read(run) is None                                   # no request, no span
    _done(run, {"perms": 40}, 4)
    assert read(run) is None                                   # a program without draws
    run.spans += [("null_chunk", 0.0, 0.1), ("draw", 0.0, 0.06), ("draw", 1.0, 1.02),
                  ("eval", 0.2, 0.25), ("batch_wait", 0.0, 2.0)]
    failed = bench.Request("r", 5.0, 5.5, units={"perms": 40}, ok=False)
    run.requests.append(failed)
    assert read(run) == pytest.approx(1e3 * 0.08 / 4)


def test_grid_plan_ms_reads_plan_spans_over_grid_points():
    read = _reader("grid_plan_ms")
    run = _run("tp380.grid")
    assert read(run) is None
    run.spans += [("eval", 0.0, 1.0), ("grid_point", 0.0, 0.4), ("grid_point", 0.5, 0.9),
                  ("hat_matrix", 0.0, 0.1), ("fold_factors", 0.1, 0.3),
                  ("hat_matrix", 0.5, 0.6), ("fold_factors", 0.6, 0.7)]
    assert read(run) == pytest.approx(1e3 * 0.5 / 2)


def test_fingerprint_ms_reads_the_engines_histogram():
    from repro_torch.serve import MetricsRegistry

    read = _reader("fingerprint_ms.fresh")
    run = _run("st76k.fresh")
    assert read(run) is None                                   # no engine (released)
    reg = MetricsRegistry()
    hist = reg.histogram("stage_latency_seconds", labels=("stage",))
    hist.declare(stage="eval")
    run.state = {"engine": type("Engine", (), {"metrics": reg})()}
    assert read(run) is None                                   # no fingerprint series
    hist.declare(stage="fingerprint")
    assert read(run) is None                                   # declared, never observed
    for seconds in (0.2, 0.3):
        hist.observe(seconds, stage="fingerprint")
    hist.observe(5.0, stage="eval")
    assert read(run) == pytest.approx(250.0)


@pytest.mark.parametrize("cell,metric,whole", [
    ("st76k.fresh", "fingerprint_ms.fresh", "register_ms.fresh"),
    ("st76k.perm1000", "draw_ms.perm", "null_chunk_ms.perm"),
    ("tp380.grid", "grid_plan_ms", "grid_point_ms"),
])
def test_a_traced_served_cell_reports_its_span_metric(cell, metric, whole):
    run = kit.tiny_run(cell, trace=True)
    res = kit.execute(run)
    assert res["correct"] is True
    part, of = res["metrics"][metric]["value"], res["metrics"][whole]["value"]
    assert 0.0 < part <= of
    assert metric not in kit.execute(kit.tiny_run(cell, trace=False))["metrics"]
