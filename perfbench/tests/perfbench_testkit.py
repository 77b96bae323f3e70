"""Shared helpers of the benchmark's CPU tests: tiny copies of the cells.

The cells run on the CPU through the program's plain route at a size a
test holds. Everything per cell is found by name, so that a new cell is
tested by adding files alone:

- the cells are the ``workloads`` of ``BENCHMARK.json``, in order;
- a configuration's test sizes are ``tests/sizes/configs/<config>.json``:
  a ``"tiny"`` block (the drivers' smoke size) and a ``"control"`` block
  (the control test's size), each a set of the configuration's own keys;
- a traffic mix's test size is ``tests/sizes/traffic/<traffic>.json``: a
  ``"tiny"`` block, a set of the mix's own keys;
- a cell's broken timed paths are ``FAULTS`` of ``tests/faults/<cell>.py``:
  ``{name: (owner, attribute, breaker)}``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import bench  # noqa: E402

def benchmark(bench_dir: Path = BENCH) -> dict:
    """The ``BENCHMARK.json`` beside ``bench_dir``."""
    return bench.load_json(bench_dir.parent / "BENCHMARK.json")


def cells(bench_dir: Path = BENCH) -> tuple[str, ...]:
    """The benchmark's cells: each ``workloads`` entry's name, in order."""
    return tuple(w["name"] for w in benchmark(bench_dir)["workloads"])


CELLS = cells()


def sizes_path(kind: str, name: str, bench_dir: Path = BENCH) -> Path:
    """``tests/sizes/<kind>/<name>.json`` (``kind``: configs or traffic)."""
    return bench_dir / "tests" / "sizes" / kind / f"{name}.json"


def faults_path(cell_name: str, bench_dir: Path = BENCH) -> Path:
    return bench_dir / "tests" / "faults" / f"{cell_name}.py"


def faults(cell_name: str, bench_dir: Path = BENCH) -> dict:
    """``FAULTS`` of ``tests/faults/<cell>.py``: name -> (owner, attribute,
    breaker), the breaker taking the attribute and returning what stands in
    for it."""
    path = faults_path(cell_name, bench_dir)
    if not path.is_file():
        raise FileNotFoundError(f"no faults file for the cell {cell_name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"perfbench_faults_{cell_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAULTS


def fault_cases(bench_dir: Path = BENCH) -> list[tuple[str, str]]:
    """(cell, fault) of every cell, in the cells' and each file's order."""
    return [(cell, name) for cell in cells(bench_dir) for name in faults(cell, bench_dir)]


def control_module():
    """``perfbench/control.py``, the chip's reader of the control."""
    spec = importlib.util.spec_from_file_location("perfbench_control", BENCH / "control.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_run(cell_name: str, seed: int = 2**31 + 11, seconds: float = 0.3,
             trace: bool = False, control: bool = False, bench_dir: Path = BENCH):
    """A Run of ``cell_name`` on the CPU at a test's size: the traffic's
    and the configuration's ``"tiny"`` sizes, with the configuration's
    ``"control"`` sizes over them where ``control``."""
    import torch

    cell, config, traffic = bench.load_cell(cell_name, bench_dir)
    config_sizes = bench.load_json(sizes_path("configs", cell["config"], bench_dir))
    config = {**config, **config_sizes["tiny"], **(config_sizes["control"] if control else {})}
    shrink = bench.load_json(sizes_path("traffic", cell["traffic"], bench_dir))["tiny"]
    return bench.Run(cell_name, seed, seconds, trace, torch.device("cpu"), cell, config,
                     {**traffic, **shrink}, time.perf_counter())


def execute(run, benchmark_json: dict | None = None, bench_dir: Path = BENCH) -> dict:
    """run.py's ``execute`` on ``run`` (the look for a card skipped), as the
    JSON line would carry it."""
    spec = importlib.util.spec_from_file_location("perfbench_run", BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    result = mod.execute(run, benchmark_json or benchmark(bench_dir), bench_dir)
    return json.loads(json.dumps(result))
