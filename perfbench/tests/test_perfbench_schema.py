"""The benchmark's definition: BENCHMARK.json against its contract, the
count functions, discovery by name, and what the harness imports."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

import perfbench_testkit as kit
from counts import kernels as counts
from harness import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_follows_the_contract():
    b = kit.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"] and b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert (kit.ROOT / c["file"]).is_file() and c["reduced"] == []
        assert json.loads((kit.ROOT / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in b["workloads"]]
    assert cells == list(kit.CELLS)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in configs and len(w["why"]) <= 200
        cell = json.loads((kit.BENCH / "cells" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"], cell["why"]) == (w["config"], w["traffic"],
                                                                  w["why"])
        reported = [m["name"] for m in bench.cell_metrics(b, w["name"], trace=False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.cell_metrics(b, w["name"], trace=True)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert m["source"] in SOURCES
        assert (kit.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


def test_count_functions_on_hand_worked_shapes():
    # gram at the paper's size: 787·788·76,000 operations at 495 TFLOP/s
    t, by = counts.gram(787, 76_000)
    assert by == "operations" and t == pytest.approx(787 * 788 * 76_000 / 495e12)
    assert t == pytest.approx(9.52e-5, rel=1e-3)
    # a small Gram is bound by its bytes: X (4, 8) and G (4, 4), f32
    t, by = counts.gram(4, 8)
    assert by == "bytes" and t == pytest.approx(4 * (32 + 16) / 3.35e12)
    # the serve null's fold solve: K 10, m 78, B 1,024, f32 — bytes bound
    t, by = counts.foldsolve(10, 78, 1024)
    assert by == "bytes" and t == pytest.approx(4 * 10 * (78 * 78 + 2 * 78 * 1024) / 3.35e12)
    assert t == pytest.approx(1.98e-6, rel=1e-2)
    ops = 10 * (2 * 78 ** 3 / 3 + 2 * 78 * 78 * 1024)
    assert ops / 67e12 < t


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in kit.BENCH.rglob("*.py"):
        assert not (_imports(path) & set(bench.FORBIDDEN)), path


def test_forbidden_names_compare_whole_top_level_names():
    assert bench.forbidden_modules(["repro_torch", "repro_torch.core.fastcv", "reprolint",
                                    "jaxtyping", "torch"]) == []
    assert bench.forbidden_modules(["repro.core", "jax.numpy", "jaxlib", "flax.linen",
                                    "repro_torch"]) == ["flax", "jax", "jaxlib", "repro"]


def test_a_whole_run_loads_neither_jax_nor_the_jax_package():
    """A tiny cell end to end in a fresh interpreter, then sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench_testkit as kit\n"
        "from harness import bench\n"
        "res = kit.execute(kit.tiny_run('st76k.perm1000', seconds=0.2))\n"
        "assert res['correct'], res\n"
        "print(bench.forbidden_modules(sys.modules))\n" % str(kit.BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=kit.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_refuses_without_a_card_and_prints_nothing(tmp_path):
    out = subprocess.run([sys.executable, str(kit.BENCH / "run.py"), "--workload",
                          "st76k.cohort", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=kit.ROOT, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_fails_in_a_directory_with_only_the_benchmark(tmp_path):
    """Without the program beside it a run cannot play a cell (on the CPU
    route here: the card's look comes first on a machine without one)."""
    shutil.copytree(kit.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(kit.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, 'perfbench/tests')\n"
            "import perfbench_testkit as kit\n"
            "print(kit.execute(kit.tiny_run('st76k.cohort', seconds=0.2)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr


def test_a_new_config_cell_traffic_and_metric_are_found_by_name(tmp_path):
    """Adding files (and entries) is enough: nothing that is there changes."""
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(kit.BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((bench_dir / "configs" / "wh-meg-st76k.json").read_text())
    config.update({**kit.TINY_CONFIG, "name": "tiny-meg", "n_channels": 5})
    (bench_dir / "configs" / "tiny-meg.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "tiny_loop.json").write_text(
        json.dumps({"subjects": 2, "warmup_analyses": 1}))
    (bench_dir / "cells" / "tiny.loop.json").write_text(json.dumps(
        {"config": "tiny-meg", "traffic": "tiny_loop", "driver": "library",
         "why": "a throwaway cell", "limits": {"dval_err": 1e-3, "class_gap": 1e-2}}))
    (bench_dir / "metrics" / "analyses_done.py").write_text(
        "def read(run):\n    return len(run.done())\n")
    b = kit.benchmark()
    b["configs"].append({"name": "tiny-meg", "source": "test", "why": "test",
                         "file": "perfbench/configs/tiny-meg.json", "reduced": []})
    b["workloads"].append({"name": "tiny.loop", "config": "tiny-meg", "traffic": "tiny_loop",
                           "chips": 1, "why": "a throwaway cell"})
    for m in b["end_to_end"]:
        if "workloads" in m and m["name"] == "subjects_per_s":
            m["workloads"].append("tiny.loop")
    b["per_layer"].append({"name": "analyses_done", "unit": "analyses", "better": "higher",
                           "source": "host_clock", "layer": "test", "moves": "subjects_per_s",
                           "workloads": ["tiny.loop"]})
    import torch

    cell, cfg, traffic = bench.load_cell("tiny.loop", bench_dir)
    assert cfg["n_channels"] == 5 and traffic["subjects"] == 2
    for trace in (False, True):
        run = bench.Run("tiny.loop", 3, 0.2, trace, torch.device("cpu"), cell, cfg, traffic,
                        0.0)
        res = kit.execute(run, b, bench_dir)
        assert res["correct"]
        names = set(res["metrics"])
        assert names == ({"analyses_done"} if trace else {"setup_s", "subjects_per_s"})
