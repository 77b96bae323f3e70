"""The contract that ``BENCHMARK.json`` and the files it names keep.

``check(benchmark, bench_dir)`` raises ``ContractError`` with a message
that names what is missing or wrong. It states the rules a new cell or
configuration is held to, not the cells that exist: a cell is added by
new files and entries alone (see ``perfbench_testkit``).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import perfbench_testkit as kit
from harness import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
#: the keys that ``reduced`` may name, and no other: depth, the chip's share
#: of a layer (experts held, heads, vocabulary) and a deployment's cohort.
#: A width (hidden, feed-forward or expert size, head size, experts per
#: token, a record's channels or features) is never cut; another kind of
#: scale joins this set only with a change of the benchmark itself.
CUTTABLE = {
    "num_layers", "num_hidden_layers", "n_layers", "n_layer",
    "moe_experts", "num_experts", "num_local_experts", "n_routed_experts",
    "num_heads", "num_kv_heads", "num_attention_heads", "num_key_value_heads",
    "vocab_size",
    "subjects",
}
#: how a configuration file records each cut: "<published> -> <here> (<why>)"
CUT = re.compile(r"^(?P<published>\S.*?) -> (?P<here>\S.*?) \((?P<why>[^()]+)\)$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
MAX_REDUCED = 16
MAX_CELLS = 24


class ContractError(AssertionError):
    """``BENCHMARK.json`` or a file it names breaks the contract."""


def _need(ok, message: str) -> None:
    if not ok:
        raise ContractError(message)


def check(b: dict, bench_dir: Path) -> None:
    """Hold ``b`` (a ``BENCHMARK.json``) and the files under ``bench_dir``
    to the contract."""
    root = bench_dir.parent
    _need(set(b) == KEYS, f"BENCHMARK.json has the keys {sorted(b)}, not {sorted(KEYS)}")
    _need(b["command"] == ["python3", "perfbench/run.py"] and b["paths"] == ["perfbench"],
          f"command {b['command']} or paths {b['paths']} changed")
    _need(1 <= b["run_seconds"] <= 51, f"run_seconds {b['run_seconds']} is not 1 to 51")
    configs = {c["name"]: c for c in b["configs"]}
    cells = [w["name"] for w in b["workloads"]]
    _need(len(configs) == len(b["configs"]), "two configurations share a name")
    _need(len(set(cells)) == len(cells), "two workloads share a name")
    _need(1 <= len(configs) <= MAX_CELLS and 1 <= len(cells) <= MAX_CELLS,
          f"{len(configs)} configurations and {len(cells)} cells; each 1 to {MAX_CELLS}")
    _need(1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128,
          f"{len(b['end_to_end'])} end-to-end metrics (1 to 16) and "
          f"{len(b['per_layer'])} per-layer metrics (1 to 128)")
    for c in b["configs"]:
        _check_config(c, root, bench_dir)
        _need(any(w["config"] == c["name"] for w in b["workloads"]),
              f"configuration {c['name']} is used by no cell")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    _need("setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25,
          "setup_s is missing or bound above 0.25")
    _check_cell_files(cells, bench_dir)
    for w in b["workloads"]:
        _check_workload(b, w, configs, bench_dir)
    four = [w["name"] for w in b["workloads"] if w["chips"] == 4]
    quota = max(1, len(cells) // 4)
    _need(len(four) <= quota, f"{len(four)} cells ask for 4 chips ({', '.join(four)}); "
          f"{len(cells)} cells allow {quota}")
    for m in b["end_to_end"] + b["per_layer"]:
        _need(NAME.match(m["name"]) and UNIT.match(m["unit"])
              and m["better"] in ("lower", "higher"), f"metric {m['name']}: name, unit or better")
        _need(m["source"] in SOURCES, f"metric {m['name']}: source {m['source']!r}")
        reader = bench_dir / "metrics" / f"{m['name']}.py"
        _need(reader.is_file(), f"metric {m['name']} has no reader {reader.relative_to(root)}")
        _need(set(m.get("workloads", [])) <= set(cells),
              f"metric {m['name']} names cells that are not workloads")
    for m in b["end_to_end"]:
        _need(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace"),
              f"end-to-end metric {m['name']}: bound {m['bound']} or source {m['source']}")
    for m in b["per_layer"]:
        _need(set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"},
              f"per-layer metric {m['name']} has the keys {sorted(m)}")
        _need(m["moves"] in e2e, f"per-layer metric {m['name']} moves {m['moves']!r}")
        for cell in m["workloads"]:
            _need(cell in e2e[m["moves"]].get("workloads", cells),
                  f"per-layer metric {m['name']}: {cell} does not report {m['moves']}")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            _need(m["unit"] == "%", f"roofline {m['name']} is not in %")
    _need(len(json.dumps(b)) < 64 * 1024, "BENCHMARK.json is 64 KiB or more")


def _check_config(c: dict, root: Path, bench_dir: Path) -> None:
    name = c["name"]
    _need(set(c) == {"name", "source", "file", "reduced", "why"},
          f"configuration {name} has the keys {sorted(c)}")
    _need(NAME.match(name) and c["file"].startswith("perfbench/"),
          f"configuration {name}: name or file {c['file']!r}")
    _need((root / c["file"]).is_file(), f"configuration {name} has no file {c['file']}")
    config = json.loads((root / c["file"]).read_text())
    _need(config["name"] == name, f"{c['file']} names {config['name']!r}, not {name!r}")
    reduced = c["reduced"]
    _need(isinstance(reduced, list) and len(reduced) <= MAX_REDUCED
          and len(set(reduced)) == len(reduced),
          f"configuration {name}: reduced is not a list of at most {MAX_REDUCED} keys")
    for key in reduced:
        _need(isinstance(key, str) and NAME.match(key),
              f"configuration {name}: reduced entry {key!r} is not a key's name")
        _need(key in config, f"configuration {name}: reduced names {key!r}, "
              f"which {c['file']} does not have")
        _need(key in CUTTABLE, f"configuration {name}: reduced names {key!r}, which is no "
              "depth, share of a layer or cohort, so it may not be cut")
    cuts = config.get("cuts", {})
    _need(set(cuts) == set(reduced), f"configuration {name}: {c['file']}'s cuts "
          f"{sorted(cuts)} are not its reduced keys {sorted(reduced)}")
    for key, cut in cuts.items():
        m = CUT.match(cut)
        _need(m, f"configuration {name}: the cut of {key} reads {cut!r}, "
              "not '<published> -> <here> (<why>)'")
        _need(m["here"] == json.dumps(config[key]), f"configuration {name}: the cut of {key} "
              f"gives {m['here']}, the file holds {json.dumps(config[key])}")
    path = kit.sizes_path("configs", name, bench_dir)
    _need(path.is_file(), f"configuration {name} has no sizes file {path.relative_to(root)}")
    sizes = json.loads(path.read_text())
    for block in ("tiny", "control"):
        _need(isinstance(sizes.get(block), dict) and set(sizes[block]) <= set(config),
              f"{path.relative_to(root)}: {block!r} is not a set of {name}'s own keys")


def _check_cell_files(cells: list, bench_dir: Path) -> None:
    root = bench_dir.parent
    for name in cells:
        path = bench_dir / "cells" / f"{name}.json"
        _need(path.is_file(), f"workload {name} has no cell file {path.relative_to(root)}")
    for path in sorted((bench_dir / "cells").glob("*.json")):
        _need(path.stem in cells, f"cell file {path.relative_to(root)} has no workload "
              f"{path.stem!r} in BENCHMARK.json")


def _check_workload(b: dict, w: dict, configs: dict, bench_dir: Path) -> None:
    root, name = bench_dir.parent, w["name"]
    _need(set(w) == {"name", "config", "traffic", "chips", "why"},
          f"workload {name} has the keys {sorted(w)}")
    _need(NAME.match(name) and NAME.match(w["traffic"]), f"workload {name}: name or traffic")
    _need(w["chips"] in (1, 4), f"workload {name} asks for {w['chips']} chips, not 1 or 4")
    _need(w["config"] in configs, f"workload {name}: no configuration {w['config']!r}")
    _need(len(w["why"]) <= 200, f"workload {name}: why is over 200 characters")
    cell = json.loads((bench_dir / "cells" / f"{name}.json").read_text())
    _need((cell["config"], cell["traffic"], cell["why"]) == (w["config"], w["traffic"], w["why"]),
          f"cells/{name}.json's config, traffic or why is not the workload's")
    traffic_path = bench_dir / "traffic" / f"{w['traffic']}.json"
    _need(traffic_path.is_file(), f"workload {name} has no traffic {traffic_path.relative_to(root)}")
    sizes = kit.sizes_path("traffic", w["traffic"], bench_dir)
    _need(sizes.is_file(), f"traffic {w['traffic']} has no sizes file {sizes.relative_to(root)}")
    tiny = json.loads(sizes.read_text()).get("tiny")
    _need(isinstance(tiny, dict) and set(tiny) <= set(json.loads(traffic_path.read_text())),
          f"{sizes.relative_to(root)}: 'tiny' is not a set of {w['traffic']}'s own keys")
    reported = [m["name"] for m in bench.cell_metrics(b, name, trace=False)]
    _need("setup_s" in reported and len(reported) >= 2,
          f"workload {name} reports {reported}: setup_s and one more end-to-end metric")
    _need(bench.cell_metrics(b, name, trace=True), f"workload {name} reports no per-layer metric")
    path = kit.faults_path(name, bench_dir)
    _need(path.is_file(), f"workload {name} has no faults file {path.relative_to(root)}")
    faults = kit.faults(name, bench_dir)
    _need(isinstance(faults, dict) and faults,
          f"{path.relative_to(root)}: FAULTS is empty; every cell shows that a broken timed "
          "path comes out not correct")
    for fault, case in faults.items():
        _need(isinstance(case, tuple) and len(case) == 3,
              f"{path.relative_to(root)}: {fault!r} is not (owner, attribute, breaker)")
        owner, attr, breaker = case
        _need(hasattr(owner, attr) and callable(breaker),
              f"{path.relative_to(root)}: {fault!r} breaks no attribute {attr!r} of {owner!r}")
