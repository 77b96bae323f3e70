"""Readers that several per-layer metrics share; each metric's own file
under ``metrics/`` names the one it reads and what it reads it over."""

from __future__ import annotations

from harness.compare import p95


def device_idle(run):
    """Share (%) of the traced window in which no kernel ran on the device
    (torch.profiler, union of kernel intervals; copies keep the copy engine
    busy and are left out)."""
    trace = run.device_trace
    return None if trace is None else 100.0 * trace.idle_share


def p95_ms(run, unit: str):
    """95th percentile (ms) over every request of the window that completed
    ``unit``, from its start to its answer (host clock, raw times, not the
    program's bucketed histogram)."""
    times = [r.seconds for r in run.done() if r.units.get(unit)]
    return 1e3 * p95(times) if times else None
