"""reprolint for the port (repro_torch.analysis): golden fixtures, suppressions,
vocabularies, the CLI, the port's own tree, and parity with the reference's
checker on the reference's fixtures.

The fixtures under tests/fixtures/reprolint_torch/ seed each rule's torch
violations; the reference's fixtures under tests/fixtures/reprolint/ are
read, never written.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import all_rules as ref_all_rules
from repro.analysis.core import check_file as ref_check_file
from repro_torch.analysis import BAD_SUPPRESSION, all_rules, load_metrics, load_stages, run
from repro_torch.analysis.core import check_file, iter_py_files, parse_file

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "reprolint_torch"
REF_FIXTURES = REPO / "tests" / "fixtures" / "reprolint"
PORT_TREE = [str(REPO / "src" / "repro_torch"), str(REPO / "benchmarks" / "torch")]


def sites(findings):
    return sorted({(f.rule, f.line) for f in findings})


def check(name):
    return check_file(FIXTURES / name, all_rules())


# ---------------------------------------------------------------------------
# Golden fixtures: each seeded violation reported with the right id/line
# ---------------------------------------------------------------------------


def test_rl001_torch_assembly_item_and_wall_clock():
    assert sites(check("rl001_host_torch.py")) == [
        ("RL001", 14),  # torch.cat
        ("RL001", 15),  # F.pad
        ("RL001", 16),  # .item()
        ("RL001", 17),  # torch.nn.functional.pad
        ("RL001", 24),  # time.time()
    ]  # torch.as_tensor and torch.from_numpy (lines 18, 19) are allowed


def test_rl002_stage_vocabulary():
    assert sites(check("rl002_stage_vocab.py")) == [("RL002", 5), ("RL002", 7), ("RL002", 8),
                                                    ("RL002", 20), ("RL002", 22)]


def test_rl003_metrics_discipline():
    assert sites(check("rl003_metrics.py")) == [
        ("RL003", 5),  # undeclared metric name
        ("RL003", 6),  # missing label key
        ("RL003", 7),  # str() label value (cardinality bomb)
        ("RL003", 10),  # .observe() on a counter (+ label-set drift)
        ("RL003", 11),  # a histogram registered as a gauge
    ]


def test_rl004_lock_discipline():
    assert sites(check("rl004_locks.py")) == [("RL004", 16), ("RL004", 17), ("RL004", 23)]


def test_rl005_torch_dtypes_casts_and_strings():
    assert sites(check("rl005_dtype_torch.py")) == [
        ("RL005", 11),  # torch.float32
        ("RL005", 12),  # .half()
        ("RL005", 13),  # "float16"
        ("RL005", 19),  # .float()
    ]


@pytest.mark.parametrize("spelling", ["torch.float32", "torch.float", "torch.float16",
                                      "torch.half", "torch.bfloat16", "torch.complex64",
                                      "torch.cfloat", "x.float()", "x.half()", "x.bfloat16()",
                                      "np.float32", "numpy.single", "'complex64'"])
def test_rl005_sees_every_sub_float64_spelling(tmp_path, spelling):
    f = tmp_path / "mod.py"
    f.write_text("import numpy as np\nimport torch\n# reprolint: host-float64\n"
                 f"def g(x):\n    return {spelling}, torch.float64, np.float64, x.double()\n")
    assert sites(check_file(f, all_rules())) == [("RL005", 5)]


# ---------------------------------------------------------------------------
# Suppression semantics
# ---------------------------------------------------------------------------


def test_suppression_with_reason_is_honored():
    assert check("suppressed_with_reason.py") == []


def test_suppression_without_reason_is_an_error_and_suppresses_nothing():
    assert sites(check("suppressed_no_reason.py")) == [(BAD_SUPPRESSION, 9), ("RL001", 9)]


def test_clean_file_has_no_findings():
    assert check("clean.py") == []


def test_suppression_is_rule_scoped(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(
        "# reprolint: host-path\n"
        "import time\n"
        "import torch\n"
        "# reprolint: monotonic-time\n"
        "def g(parts):\n"
        "    t = time.time()  # reprolint: ignore[RL005] -- wrong rule id\n"
        "    return torch.cat(parts), t\n"
    )
    assert sites(check_file(f, all_rules())) == [("RL001", 6), ("RL001", 7)]


def test_function_scoped_pragma_covers_only_its_function(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(
        "import torch\n"
        "def on_path(x):\n"
        "    # reprolint: host-path\n"
        "    return torch.zeros(3), x.item()\n"
        "def elsewhere(x):\n"
        "    return torch.zeros(3), x.item()\n"
    )
    assert sites(check_file(f, all_rules())) == [("RL001", 4)]


# ---------------------------------------------------------------------------
# Vocabularies: AST-read from the port's modules, equal to their runtime values
# ---------------------------------------------------------------------------


def test_load_stages_matches_the_port_trace_module():
    from repro_torch.serve.trace import STAGES

    assert load_stages() == tuple(STAGES)


def test_load_metrics_matches_the_port_obs_module():
    from repro_torch.serve.obs import METRICS

    assert load_metrics() == METRICS
    for name, spec in load_metrics().items():
        assert spec["kind"] in {"counter", "gauge", "histogram"}, name
        assert isinstance(spec["labels"], tuple), name


# ---------------------------------------------------------------------------
# The port's shipped tree: clean under its own linter, pragmas where declared
# ---------------------------------------------------------------------------


def test_port_tree_is_clean():
    findings = run(PORT_TREE)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_every_port_suppression_has_a_reason():
    paths = list(iter_py_files(PORT_TREE))
    assert len(paths) > 50
    for path in paths:
        assert parse_file(path).bare_suppression_lines == [], path


def _region_functions(rel, directive):
    """Names of the functions that lie inside ``directive`` regions of a port file."""
    ctx = parse_file(REPO / "src" / "repro_torch" / rel)
    regions = ctx.pragma_regions(directive)
    return {n.name for n in ast.walk(ctx.tree) if isinstance(n, ast.FunctionDef)
            and any(s <= n.lineno and n.end_lineno <= e for s, e in regions)}, ctx


@pytest.mark.parametrize("rel,names", [
    ("serve/engine.py", {"update_dataset"}),
    ("serve/workload.py", {"run_workloads", "_stream_permutation", "_stream_update",
                           "_stream_rsa"}),
])
def test_host_path_regions_are_the_references(rel, names):
    got, _ = _region_functions(rel, "host-path")
    assert names <= got
    ref = parse_file(REPO / "src" / "repro" / rel)
    ref_regions = ref.pragma_regions("host-path")
    want = {n.name for n in ast.walk(ref.tree) if isinstance(n, ast.FunctionDef)
            and any(s <= n.lineno and n.end_lineno <= e for s, e in ref_regions)}
    assert got == want


def test_batching_is_a_host_path_module():
    ctx = parse_file(REPO / "src" / "repro_torch" / "serve" / "batching.py")
    assert ctx.pragma_regions("host-path") == [(1, len(ctx.lines))]


def test_host_float64_covers_the_update_lineage_not_the_kernel_route():
    got, ctx = _region_functions("core/fastcv.py", "host-float64")
    assert {"update_plan", "downdate_plan", "sliding_window", "_append_inverse",
            "_downdate_inverse", "_mean_shift_inverse", "_finish_plan"} <= got
    assert not {"cv_errors_fused", "prepare", "cv_errors", "hat_matrix_dual"} & got
    line = next(i for i, t in enumerate(ctx.lines, 1) if "y.dtype == torch.float32" in t)
    assert not ctx.in_region("host-float64", line)


# ---------------------------------------------------------------------------
# Parity: the port's checker on the reference's fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rl002_stage_vocab.py", "rl003_metrics.py", "rl004_locks.py",
                                  "rl005_dtype.py", "suppressed_with_reason.py", "clean.py"])
def test_reference_fixtures_give_the_reference_sites(name):
    want = sites(ref_check_file(REF_FIXTURES / name, ref_all_rules()))
    assert sites(check_file(REF_FIXTURES / name, all_rules())) == want


def test_reference_host_fixtures_give_only_the_wall_clock():
    # eager jnp is the reference's vocabulary, not the port's: only the
    # shared time.time() sub-check and the bare suppression carry over
    assert sites(check_file(REF_FIXTURES / "rl001_host_jnp.py", all_rules())) == [("RL001", 20)]
    got = sites(check_file(REF_FIXTURES / "suppressed_no_reason.py", all_rules()))
    want = sites(ref_check_file(REF_FIXTURES / "suppressed_no_reason.py", ref_all_rules()))
    assert got == [(BAD_SUPPRESSION, 9)] and want == [(BAD_SUPPRESSION, 9), ("RL001", 9)]


@pytest.mark.parametrize("rule_id", ["RL001", "RL002", "RL003", "RL004", "RL005"])
def test_rule_table_lists_every_rule(rule_id):
    assert rule_id in {r.id for r in all_rules()}
    assert [r.id for r in all_rules()] == [r.id for r in ref_all_rules()]


# ---------------------------------------------------------------------------
# CLI: exit codes, JSON output, rule filter; stdlib only
# ---------------------------------------------------------------------------


def _cli(*args, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=env, cwd=cwd)


def test_cli_exits_zero_on_clean_and_one_on_every_seeded_fixture():
    assert _cli(str(FIXTURES / "clean.py")).returncode == 0
    seeded = sorted(FIXTURES.glob("rl00*.py"))
    assert len(seeded) == 5
    for path in seeded:
        proc = _cli(str(path))
        assert proc.returncode == 1, path.name
        assert path.name.split("_")[0].upper() in proc.stdout


def test_cli_default_paths_are_the_port_tree(tmp_path):
    proc = _cli()
    assert proc.returncode == 0, proc.stdout
    assert proc.stdout.strip() == "reprolint: 0 findings"
    # from a directory without the tree: the default paths yield nothing
    empty = _cli("--json", cwd=tmp_path)
    assert empty.returncode == 0 and json.loads(empty.stdout)["count"] == 0


def test_cli_json_output():
    proc = _cli("--json", str(FIXTURES / "rl005_dtype_torch.py"))
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert payload["count"] == 4
    assert {f["rule"] for f in payload["findings"]} == {"RL005"}
    assert all(f["path"].endswith("rl005_dtype_torch.py") for f in payload["findings"])


def test_cli_rule_filter_and_list():
    assert _cli("--rules", "RL005", str(FIXTURES / "rl001_host_torch.py")).returncode == 0
    assert _cli("--rules", "RL001,RL005", str(FIXTURES / "rl001_host_torch.py")).returncode == 1
    assert _cli("--rules", "RL999", str(FIXTURES / "clean.py")).returncode == 2
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    assert [ln.split()[0] for ln in listed.stdout.splitlines()] == [
        "RL001", "RL002", "RL003", "RL004", "RL005"]


def test_the_checker_imports_neither_torch_nor_the_reference():
    code = ("import sys, runpy\n"
            "sys.argv = ['reprolint', '--list-rules']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'repro'))\n"
            "print('IMPORTED', bad)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "IMPORTED []" in proc.stdout
