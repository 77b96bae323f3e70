"""repro_torch's isolation from the reference package, its kernel build
helper, and chip_smoke.py's refusal to run without a card — the parts of
the CUDA route that can be checked on a machine without nvcc or a GPU.
"""

import ast
import ctypes
import os
import re
import shutil
import stat
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + sorted((REPO / "examples" / "torch").glob("*.py"))
            + [REPO / "chip_smoke.py"])


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_the_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_the_import_check_covers_every_subpackage():
    """The check above reaches the LLM substrate's configs, models and
    launchers as well as the analysis packages and the kernels, the serve
    edges and their entry point, and the port's examples."""
    subpackages = {p.relative_to(PORT).parts[0] for p in _port_files() if p.is_relative_to(PORT)}
    assert {"configs", "models", "launch", "core", "rsa", "data", "kernels",
            "serve"} <= subpackages
    names = {p.relative_to(PORT).as_posix() for p in _port_files() if p.is_relative_to(PORT)}
    assert {"launch/serve.py", "launch/probe.py", "models/convert.py",
            "kernels/flash_attention/ops.py", "configs/gemma2_2b.py",
            "serve/engine.py", "serve/workload.py", "serve/api.py", "serve/aio.py",
            "serve/client.py", "serve/http.py", "launch/serve_cv.py"} <= names
    examples = {p.name for p in _port_files() if p.parent == REPO / "examples" / "torch"}
    assert {"quickstart.py", "eeg_permutation.py", "rsa_probe.py", "serve_quickstart.py",
            "streaming_quickstart.py", "http_quickstart.py", "async_stream.py"} <= examples


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True).stdout
    assert out.strip() == "[]"


# --------------------------------------------------------------- build ----

def _c_signatures():
    """{symbol: [parameter types]} of every extern "C" entry point in csrc."""
    sigs = {}
    for path in _build.CSRC.glob("*.cu"):
        exported = path.read_text().split('extern "C" {', 1)[1]
        for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", exported, re.M):
            sigs[name] = [" ".join(p.split()[:-1]) for p in params.split(",")]
    return sigs


def test_argtypes_table_matches_the_c_entry_points():
    sigs = _c_signatures()
    table = {s: a for per_kernel in _build.ARGTYPES.values() for s, a in per_kernel.items()}
    assert set(table) == set(sigs)
    for symbol, argtypes in table.items():
        params = sigs[symbol]
        assert len(params) == len(argtypes), symbol
        for ctype, param in zip(argtypes, params):
            if "*" in param:
                assert ctype is ctypes.c_void_p, (symbol, param)
            elif param == "float":
                assert ctype is ctypes.c_float, (symbol, param)
            else:
                assert param == "int" and ctype is ctypes.c_int, (symbol, param)
        assert params[-1] == "void*"        # the stream comes last
    assert set(_build.ARGTYPES) == set(_build.KERNELS) == set(_build.LAUNCHES)
    for kernel in _build.KERNELS:
        assert (_build.CSRC / f"{kernel}.cu").is_file()


def test_every_kernel_source_names_the_tpu_kernel_it_replaces():
    for kernel in _build.KERNELS:
        text = (_build.CSRC / f"{kernel}.cu").read_text()
        assert f"src/repro/kernels/{kernel}/{kernel}.py" in text
        assert "bounds it here" in text


def test_source_hash_is_stable_and_keyed_on_flags(monkeypatch):
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.source_hash() != h


def test_build_flags_target_hopper():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["gram"])
    assert not (tmp_path / "build").exists()


def _fake_nvcc(tmp_path, body):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return tmp_path / "cuda"


def test_failing_nvcc_raises_with_its_output(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, "echo 'error: no sm_90a here' >&2\n"
                                                             "exit 2\n")))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build(["gram", "foldsolve"])
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_runs_once_per_source_and_hash(monkeypatch, tmp_path):
    log = tmp_path / "calls"
    # the fake compiler writes its -o target and records the source it got
    body = ('out=""; prev=""\n'
            'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
            f'echo "$a" >> {log}\n'
            'echo ptxas info : Used 40 registers; : > "$out"\n')
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, body)))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    paths = _build.build()
    assert set(paths) == set(_build.KERNELS)
    for name, path in paths.items():
        assert path.is_file() and path.parent.name == _build.source_hash()
        assert "registers" in path.with_suffix(".log").read_text()
    assert sorted(Path(s).name for s in log.read_text().split()) == sorted(
        f"{k}.cu" for k in _build.KERNELS)
    _build.build()                                    # cached: nvcc not called again
    assert len(log.read_text().split()) == len(_build.KERNELS)


def test_reset_launches():
    _build.LAUNCHES["gram"] += 3
    _build.LAUNCH_SHAPES["gram", (8, 16, 1)] += 3
    _build.reset_launches()
    assert set(_build.LAUNCHES.values()) == {0} and not _build.LAUNCH_SHAPES


def test_launch_counts_each_launch_by_shape(monkeypatch):
    # a stand-in for libhat_apply's entry point: launch passes the pointers,
    # the sizes and the stream, and counts the launch under its int arguments
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    entry.argtypes = list(_build.ARGTYPES["hat_apply"]["hat_apply_f32"])
    monkeypatch.setitem(_build._libs, "hat_apply", types.SimpleNamespace(hat_apply_f32=entry))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    _build.reset_launches()
    dev = torch.device("cuda", 0)
    for b in (1024, 1024, 32):
        _build.launch("hat_apply", "hat_apply_f32", dev, 16, 32, None, 48, 787, b, 3)
    assert calls[0] == (16, 32, None, 48, 787, 1024, 3, 7)
    assert _build.LAUNCHES["hat_apply"] == 3
    assert dict(_build.LAUNCH_SHAPES) == {("hat_apply", (787, 1024, 3)): 2,
                                          ("hat_apply", (787, 32, 3)): 1}
    _build.reset_launches()


# ----------------------------------------------------------- chip_smoke ----

def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA it exits non-zero and prints no result line."""
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds only the script, it fails too."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
