"""Readings behind the limits of ``correct``, at a cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 12 --control-seeds 4 \
        --seconds 3 [--out FILE]

For each of ``--seeds`` seeds, in one process: play the cell for a short
window, check the window's answers against the float64 reference, and
print the numbers compared (the program's readings; the lower reading of
a number is the largest over the seeds). For the first ``--control-seeds``
of them, also put the control in the program's place: the reference in
float32 with TF32 products, on the same requests, and print the numbers
it reads (the upper reading is the smallest over those seeds). In a
permutation cell the same seeds also put each biased draw of the driver's
``DRAW_FAULTS`` in the program's place and print what it reads. The last
line sums it all up per number. Needs a CUDA card; the benchmark's runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def readings(run, driver, control: bool) -> dict:
    """Play ``run`` and return {"program": {...}, "control": {...}?}."""
    driver.play(run)
    driver.release(run)
    answers = driver.answers(run)
    ref = driver.reference(run, answers, tf32=False)
    out = {"program": {n.name: n.value for n in driver.compare_answers(run, answers, ref)},
           "requests": len(run.requests), "failed": sum(1 for r in run.requests if not r.ok)}
    if control:
        ctl = driver.as_answers(run, answers, driver.reference(run, answers, tf32=True))
        out["control"] = {n.name: n.value for n in driver.compare_answers(run, ctl, ref)}
        kind = (run.state or {}).get("kind")
        if hasattr(kind, "planted"):
            out["faults"] = {fault: {n.name: n.value for n in kind.planted(answers, fault)}
                             for fault in driver.DRAW_FAULTS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch

    from harness import bench

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell, config, traffic = bench.load_cell(args.workload)
    driver = bench.load_module("drivers", cell["driver"])
    lines, lower, upper = [], {}, {}
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        run = bench.Run(args.workload, seed, args.seconds, False, device, cell, config,
                        traffic, time.perf_counter())
        line = {"cell": args.workload, "seed": seed,
                **readings(run, driver, k < args.control_seeds)}
        for name, v in line["program"].items():
            lower[name] = max(lower.get(name, v), v)
        for name, v in line.get("control", {}).items():
            upper[name] = min(upper.get(name, v), v)
        for fault, numbers in line.get("faults", {}).items():
            for name, v in numbers.items():
                key = f"{fault}: {name}"
                upper[key] = min(upper.get(key, v), v)
        print(json.dumps(line), flush=True)
        lines.append(line)
        del run
        torch.cuda.empty_cache()
    summary = {"cell": args.workload, "device": torch.cuda.get_device_name(device),
               "lower": lower, "upper": upper, "limits": cell["limits"]}
    print(json.dumps(summary), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines + [summary]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
