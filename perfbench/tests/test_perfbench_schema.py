"""The benchmark's definition: BENCHMARK.json against its contract, the
count functions, discovery by name, and what the harness imports."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

import perfbench_contract as contract
import perfbench_testkit as kit
from counts import kernels as counts
from harness import bench


def test_benchmark_json_follows_the_contract():
    contract.check(kit.benchmark(), kit.BENCH)


def _copy(tmp_path):
    """A copy of the benchmark (``perfbench/`` and ``BENCHMARK.json``)."""
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(kit.BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(kit.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return bench_dir


def _write(path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2))


def _cut(reduced, cuts=None, **values):
    """Cuts of ``wh-meg-tp380``: the entry's ``reduced``, and the file's
    ``cuts`` and values."""
    def mutate(b, bench_dir):
        entry = next(c for c in b["configs"] if c["name"] == "wh-meg-tp380")
        entry["reduced"] = reduced
        path = bench_dir.parent / entry["file"]
        config = json.loads(path.read_text())
        config.update(values)
        if cuts is not None:
            config["cuts"] = cuts
        _write(path, config)
    return mutate


def _unlink(*parts):
    return lambda b, bench_dir: bench_dir.joinpath(*parts).unlink()


def _chips(*each):
    def mutate(b, bench_dir):
        for w, chips in zip(b["workloads"], each):
            w["chips"] = chips
    return mutate


def _cells_over_the_cap(b, bench_dir):
    spare = b["workloads"][0]
    b["workloads"] += [{**spare, "name": f"spare.{i}"} for i in range(25 - len(b["workloads"]))]


def _spare_cell(b, bench_dir):
    cells = bench_dir / "cells"
    shutil.copy(cells / "st76k.cohort.json", cells / "st76k.spare.json")


def _empty_faults(b, bench_dir):
    kit.faults_path("tp380.grid", bench_dir).write_text("FAULTS = {}\n")


BROKEN = {
    "workload without a cell file": (
        _unlink("cells", "tp380.grid.json"),
        "workload tp380.grid has no cell file perfbench/cells/tp380.grid.json"),
    "cell file without a workload": (
        _spare_cell, "cell file perfbench/cells/st76k.spare.json has no workload"),
    "configuration without a sizes file": (
        _unlink("tests", "sizes", "configs", "wh-meg-tp380.json"),
        "wh-meg-tp380 has no sizes file perfbench/tests/sizes/configs/wh-meg-tp380.json"),
    "traffic without a sizes file": (
        _unlink("tests", "sizes", "traffic", "grid_closed4.json"),
        "grid_closed4 has no sizes file perfbench/tests/sizes/traffic/grid_closed4.json"),
    "cell without a faults file": (
        _unlink("tests", "faults", "tp380.grid.py"),
        "tp380.grid has no faults file perfbench/tests/faults/tp380.grid.py"),
    "cell with an empty FAULTS": (
        _empty_faults, "perfbench/tests/faults/tp380.grid.py: FAULTS is empty"),
    "reduced entry that is no key's name": (
        _cut(["subjects: 16 -> 2 (a test)"]), "reduced entry 'subjects: 16 -> 2 (a test)'"),
    "reduced names a key the file lacks": (
        _cut(["n_subjects"]), "reduced names 'n_subjects', which perfbench/configs/"),
    "reduced names a record's width": (
        _cut(["n_channels"], cuts={"n_channels": "380 -> 380 (x)"}),
        "reduced names 'n_channels', which is no depth, share of a layer or cohort"),
    "reduced names a model's width": (
        _cut(["d_model"], cuts={"d_model": "2048 -> 256 (x)"}, d_model=256),
        "reduced names 'd_model', which is no depth, share of a layer or cohort"),
    "reduced differs between the entry and the file": (
        _cut(["subjects"], cuts={"folds": "10 -> 10 (x)"}),
        "cuts ['folds'] are not its reduced keys ['subjects']"),
    "a cut without its record": (
        _cut(["subjects"]), "cuts [] are not its reduced keys ['subjects']"),
    "a malformed cut": (
        _cut(["subjects"], cuts={"subjects": "16 to 2"}, subjects=2),
        "the cut of subjects reads '16 to 2'"),
    "a cut that is not the file's value": (
        _cut(["subjects"], cuts={"subjects": "16 -> 4 (a test)"}, subjects=2),
        "the cut of subjects gives 4, the file holds 2"),
    "a 25th cell": (_cells_over_the_cap, "25 cells; each 1 to 24"),
    "chips neither 1 nor 4": (_chips(1, 2), "st76k.perm1000 asks for 2 chips, not 1 or 4"),
    "one 4-chip cell beyond the quota": (
        _chips(4, 4), "2 cells ask for 4 chips (st76k.cohort, st76k.perm1000); 4 cells allow 1"),
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_the_contract_names_what_a_broken_benchmark_misses(case, tmp_path):
    bench_dir = _copy(tmp_path)
    b = kit.benchmark(bench_dir)
    contract.check(b, bench_dir)
    mutate, message = BROKEN[case]
    mutate(b, bench_dir)
    with pytest.raises(contract.ContractError) as err:
        contract.check(b, bench_dir)
    assert message in str(err.value)


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


def _files(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _only_appended(old: dict, new: dict) -> None:
    """Every entry of ``old`` is in ``new`` as it was, but for names
    appended to its ``workloads``."""
    assert set(new) == set(old)
    for key, value in old.items():
        if not (isinstance(value, list) and value and isinstance(value[0], dict)):
            assert new[key] == value, key
            continue
        assert len(new[key]) >= len(value), key
        for was, now in zip(value, new[key]):
            now = dict(now)
            if "workloads" in was:
                assert now["workloads"][:len(was["workloads"])] == was["workloads"], was["name"]
                now["workloads"] = was["workloads"]
            assert now == was, was["name"]


TINY_FAULTS = """\
from perfbench_faultkit import altered, first_plus, pair_first
from repro_torch.core import fastcv

FAULTS = {"decision value altered": (fastcv, "binary_cv",
                                     lambda f: altered(f, pair_first(first_plus(1.0))))}
"""


def test_a_new_config_cell_traffic_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """Adding files (and entries) is enough: nothing that is there changes.
    The copy's contract holds, its kit finds the cell, its sizes and its
    fault, and the cell plays untraced and traced."""
    bench_dir = _copy(tmp_path)
    before = _files(tmp_path)
    config = json.loads((bench_dir / "configs" / "wh-meg-st76k.json").read_text())
    tiny = {**json.loads(kit.sizes_path("configs", "wh-meg-st76k").read_text())["tiny"],
            "n_channels": 5}
    del config["reduced"]
    config.update({**tiny, "name": "tiny-meg", "subjects": 2,
                   "cuts": {"subjects": "16 -> 2 (a test's cohort)"}})
    _write(bench_dir / "configs" / "tiny-meg.json", config)
    _write(bench_dir / "traffic" / "tiny_loop.json", {"subjects": 2, "warmup_analyses": 1})
    _write(bench_dir / "cells" / "tiny.loop.json",
           {"config": "tiny-meg", "traffic": "tiny_loop", "driver": "library",
            "why": "a throwaway cell", "limits": {"dval_err": 1e-3, "class_gap": 1e-2}})
    (bench_dir / "metrics" / "analyses_done.py").write_text(
        "def read(run):\n    return len(run.done())\n")
    _write(kit.sizes_path("configs", "tiny-meg", bench_dir),
           {"tiny": tiny, "control": {**tiny, "n_trials": 200}})
    _write(kit.sizes_path("traffic", "tiny_loop", bench_dir), {"tiny": {"subjects": 2}})
    kit.faults_path("tiny.loop", bench_dir).write_text(TINY_FAULTS)
    b = kit.benchmark(bench_dir)
    b["configs"].append({"name": "tiny-meg", "source": "test", "why": "test",
                         "file": "perfbench/configs/tiny-meg.json", "reduced": ["subjects"]})
    b["workloads"].append({"name": "tiny.loop", "config": "tiny-meg", "traffic": "tiny_loop",
                           "chips": 1, "why": "a throwaway cell"})
    for m in b["end_to_end"]:
        if "workloads" in m and m["name"] == "subjects_per_s":
            m["workloads"].append("tiny.loop")
    b["per_layer"].append({"name": "analyses_done", "unit": "analyses", "better": "higher",
                           "source": "host_clock", "layer": "test", "moves": "subjects_per_s",
                           "workloads": ["tiny.loop"]})
    _write(tmp_path / "BENCHMARK.json", b)
    b = kit.benchmark(bench_dir)

    contract.check(b, bench_dir)
    assert kit.cells(bench_dir) == kit.CELLS + ("tiny.loop",)
    assert kit.fault_cases(bench_dir)[-1] == ("tiny.loop", "decision value altered")
    run = kit.tiny_run("tiny.loop", bench_dir=bench_dir)
    assert run.config["n_channels"] == 5 and run.traffic["subjects"] == 2
    owner, attr, breaker = kit.faults("tiny.loop", bench_dir)["decision value altered"]
    with monkeypatch.context() as patch:
        patch.setattr(owner, attr, breaker(getattr(owner, attr)))
        assert kit.execute(run, b, bench_dir)["correct"] is False
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

    after = _files(tmp_path)
    for path, data in before.items():
        if path != "BENCHMARK.json":
            assert after[path] == data, path
    _only_appended(json.loads(before["BENCHMARK.json"]), json.loads(after["BENCHMARK.json"]))
