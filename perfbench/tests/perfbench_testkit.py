"""Shared helpers of the benchmark's CPU tests: tiny copies of the cells.

The cells run on the CPU through the program's plain route at a size a
test holds: a few channels at 20 Hz, 60 trials, 5 folds, short windows.
"""

from __future__ import annotations

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

CELLS = ("st76k.cohort", "st76k.perm1000", "tp380.grid", "st76k.fresh")

#: what shrinks each configuration and traffic mix to a CPU test's size
TINY_CONFIG = {"n_trials": 60, "n_channels": 8, "fs_hz": 20.0, "folds": 5}
TINY_TRAFFIC = {"subjects": 3, "n_perm": 40, "clients": 2, "warmup_requests": 1,
                "warmup_analyses": 1}


def control_module():
    """``perfbench/control.py``, the chip's reader of the control."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("perfbench_control", BENCH / "control.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return bench.load_json(ROOT / "BENCHMARK.json")


def tiny_run(cell_name: str, seed: int = 2**31 + 11, seconds: float = 0.3,
             trace: bool = False):
    """A Run of ``cell_name`` on the CPU at a test's size."""
    import torch

    cell, config, traffic = bench.load_cell(cell_name)
    config = {**config, **TINY_CONFIG}
    traffic = {**traffic, **{k: v for k, v in TINY_TRAFFIC.items() if k in traffic}}
    return bench.Run(cell_name, seed, seconds, trace, torch.device("cpu"), cell, config,
                     traffic, time.perf_counter())


def execute(run, benchmark_json: dict | None = None, bench_dir: Path = BENCH) -> dict:
    """run.py's ``execute`` on ``run`` (the look for a card skipped), as the
    JSON line would carry it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("perfbench_run", BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    result = mod.execute(run, benchmark_json or benchmark(), bench_dir)
    return json.loads(json.dumps(result))
