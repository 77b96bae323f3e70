"""The run of one cell: what a driver, a metric reader and a check share.

A cell is found by name: ``cells/<cell>.json`` names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``)
and the driver that plays it (``drivers/<driver>.py``). The metrics a run
reports are the ones ``BENCHMARK.json`` lists for the cell, each read by
``metrics/<metric>.py``. Nothing here names a cell, a configuration or a
metric.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import time
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """``<bench_dir>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = bench_dir / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the cell ``name``."""
    cell = load_json(bench_dir / "cells" / f"{name}.json")
    config = load_json(bench_dir / "configs" / f"{cell['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def cell_metrics(benchmark: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics of ``BENCHMARK.json`` that this cell reports: its
    end-to-end ones untraced, its per-layer ones traced. A metric without a
    ``workloads`` key is reported by every cell that reports what it
    moves."""
    e2e = [m for m in benchmark["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    e2e_names = {m["name"] for m in e2e}

    def reported(m: dict) -> bool:
        return cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names

    return [m for m in benchmark["per_layer"] if reported(m)]


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is the JAX stack or the JAX
    package (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Request:
    """One request (or one library call) of the window."""

    kind: str
    t0: float
    t1: float = 0.0
    units: dict = dataclasses.field(default_factory=dict)
    ok: bool = True
    timings: Optional[dict] = None   # the program's stage sums, traced runs only
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Number:
    """One number the check compares, with its limit (pass: value <= limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


class Run:
    """State of one run of one cell: inputs, the window's requests, the
    spans and counters the metric readers take, and the device trace."""

    def __init__(self, cell_name: str, seed: int, seconds: float, trace: bool, device,
                 cell: dict, config: dict, traffic: dict, t_process: float):
        self.cell_name, self.seed, self.seconds, self.trace = cell_name, seed, seconds, trace
        self.device = device
        self.cell, self.config, self.traffic = cell, config, traffic
        self.t_process = t_process
        self.setup_s: Optional[float] = None
        self.t_begin: Optional[float] = None
        self.t_end: Optional[float] = None
        self.requests: list[Request] = []
        self.spans: list[tuple[str, float, float]] = []   # (name, t0, t1) on the host clock
        self.counters: dict = {}        # name -> value over the window (end - start)
        self.launches: dict = {}        # (kernel, int args) -> launches in the traced part
        self.device_trace = None        # harness.devtrace.DeviceTrace of a traced run
        self.state = None               # the driver's own
        self._profiler = None
        self._launch_start = None

    # -- the window ---------------------------------------------------------

    @property
    def deadline(self) -> float:
        return self.t_begin + self.seconds

    def begin_window(self, launch_counter=None) -> None:
        """Set-up ends here (a traced run has readied its device trace)."""
        if self.trace and self.device.type == "cuda":
            from harness.devtrace import DeviceTrace
            DeviceTrace.warm()
        self.setup_s = time.perf_counter() - self.t_process
        self._launch_counter = launch_counter
        self.t_begin = time.perf_counter()
        self.trace_tick()

    def trace_tick(self) -> None:
        """Drivers call this between requests: a traced run starts its
        device trace (and its count of launches) for the window's end."""
        from harness.devtrace import PROFILE_SECONDS, DeviceTrace

        if (not self.trace or self._launch_start is not None
                or time.perf_counter() < self.deadline - PROFILE_SECONDS):
            return
        if self.device.type == "cuda":
            self._profiler = DeviceTrace()
            self._profiler.start()
        self._launch_start = dict(self._launch_counter or {})

    def end_window(self) -> None:
        """The window closes when its last request has finished; a device
        trace is read after it."""
        self.t_end = max([self.t_begin] + [r.t1 for r in self.requests])
        if self._launch_start is not None:
            end = dict(self._launch_counter or {})
            self.launches = {k: v - self._launch_start.get(k, 0) for k, v in end.items()
                             if v - self._launch_start.get(k, 0)}
        if self._profiler is not None:
            self.device_trace = self._profiler.stop(self.spans)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_begin

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def done(self) -> list[Request]:
        """The requests of the window that returned."""
        return [r for r in self.requests if r.ok]

    def limit(self, name: str) -> float:
        return float(self.cell["limits"][name])
