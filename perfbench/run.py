"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with a CUDA card. The cell is
found by name under ``perfbench/cells/``; its configuration, traffic mix,
driver and metric readers by the names it and ``BENCHMARK.json`` give.

The run makes its inputs on the device from ``--seed``, warms up every
shape the cell's traffic uses (set-up, ``setup_s``), plays the traffic
for ``--seconds`` (the window), then checks the window's answers against
the plain reference. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (end-to-end metrics
with ``--trace 0``, per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``check``: each compared
number beside its limit. The same numbers end standard error.

Exits 2 without a CUDA card (or with fewer cards than the cell asks for)
and 3 if the JAX stack or the JAX package was loaded; neither prints a
result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

# Build and kernel caches at fixed paths inside the checkout.
CACHE = ROOT / ".perfbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(run, benchmark: dict, bench_dir: Path = BENCH) -> dict:
    """Play the cell, read its metrics, check its answers: the result line."""
    import torch

    from harness import bench

    driver = bench.load_module("drivers", run.cell["driver"], bench_dir)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    driver.play(run)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    metrics = {}
    for spec in bench.cell_metrics(benchmark, run.cell_name, bool(run.trace)):
        value = bench.load_module("metrics", spec["name"], bench_dir).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    driver.release(run)
    answers = driver.answers(run)
    numbers = driver.compare_answers(run, answers, driver.reference(run, answers, tf32=False))
    failed = sum(1 for r in run.requests if not r.ok)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0 and all(n.ok for n in numbers),
              "attempted": len(run.requests), "failed": failed,
              "metrics": metrics, "device": device}
    trace = run.device_trace
    if trace is not None:
        device["busy_s"], device["window_s"] = trace.busy_s, trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(10),
                               "idle_gaps": [[label, sec] for sec, label in trace.gaps]}
    result["check"] = {n.name: {"value": n.value if math.isfinite(n.value) else None,
                                "limit": n.limit} for n in numbers}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from harness import bench

    benchmark = bench.load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in benchmark["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell, config, traffic = bench.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = bench.Run(args.workload, args.seed, args.seconds, bool(args.trace), device,
                    cell, config, traffic, T_PROCESS)
    result = execute(run, benchmark)
    loaded = bench.forbidden_modules(sys.modules)
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: the benchmark measures repro_torch alone",
              file=sys.stderr)
        return 3
    if run.device_trace is not None:
        print(f"device trace: {run.device_trace.events} device ops in "
              f"{run.device_trace.window_s:.3f} s (started in {run.device_trace.start_s:.3f} s, "
              f"read in {run.device_trace.read_s:.1f} s)",
              file=sys.stderr)
    for name, n in result["check"].items():
        print(f"check {name} = {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
