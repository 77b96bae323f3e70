"""repro_torch.launch.serve_cv on the CPU (``--device cpu``) at the
reference CLI's small defaults (3 datasets of 96 samples, 64 workloads).

Each replay mode runs through ``main()`` and reports no new launch shape on
its warm replay; record / warm-up-from replays the recorded traffic with no
plan build; ``--debug-nans`` raises ``FloatingPointError`` naming the
evaluator at a planted NaN; ``--http 0`` serves over a socket as a
subprocess, shuts down on SIGTERM with exit 0, and a reboot from its plan
store and recorded traffic builds 0 plans. Without ``--device`` the CLI
takes the card and refuses to start without one.
"""

import os
import re
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import fastcv
from repro_torch.launch import serve_cv
from repro_torch.serve import HTTPClient, Workload

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


@pytest.mark.parametrize("mode", [[], ["--clients", "2"], ["--async", "4"], ["--rsa"],
                                  ["--warmup", "--pin", "--async", "8", "--metrics"],
                                  ["--data", "eeg", "--requests", "16"]],
                         ids=["replay", "clients", "async", "rsa", "warm_async", "eeg"])
def test_replay_modes_serve_warm_with_no_new_shape(mode, capsys):
    out = serve_cv.main(CPU + mode)
    text = capsys.readouterr().out
    assert out["warm_recompiles"] == 0
    assert re.search(r"recompiles on warm replay: 0\b", text)
    n_requests = 16 if "eeg" in mode else 64
    assert len(out["responses"]) == n_requests
    assert all(r is not None for r in out.get("threaded", out["responses"]))
    if "--async" in mode:
        assert "recompiles on async replay:" in text and "stream: done, p =" in text
    if "--warmup" in mode:
        assert out["async_recompiles"] == 0
        assert "stage latency" in text                         # --metrics
    if "--rsa" in mode:
        assert "RSA: best-model score mean" in text
    stats = out["engine"].stats()
    assert stats["plans_built"] == (4 if "--rsa" in mode else 3)


def test_window_advances_with_no_new_shape(capsys):
    out = serve_cv.main(CPU + ["--window", "3"])
    assert out["window_recompiles"] == 0
    assert out["engine"].stats()["plans_updated"] == 3
    assert "window: 3 advances" in capsys.readouterr().out


def test_record_then_warmup_from_builds_nothing_new(tmp_path, capsys):
    traffic = tmp_path / "traffic.json"
    store = tmp_path / "plans"
    first = serve_cv.main(CPU + ["--record-traffic", str(traffic), "--plan-store", str(store),
                                 "--save-plans"])
    assert traffic.is_file() and first["engine"].stats()["plans_built"] == 3
    out = serve_cv.main(CPU + ["--warmup-from", str(traffic), "--plan-store", str(store)])
    text = capsys.readouterr().out
    assert re.search(r"warmup-from .*: \d+ recorded entries, .* 0 plans built", text)
    s = out["engine"].stats()
    assert s["plans_built"] == 0 and s["store_hits"] == 3
    assert out["warm_recompiles"] == 0


def test_debug_nans_raises_at_a_planted_nan(monkeypatch):
    real = fastcv.make_eval_binary

    def planted(adjust_bias=True, fused=None):
        inner = real(adjust_bias=adjust_bias, fused=fused)
        return lambda plan, y: inner(plan, y) * torch.nan

    monkeypatch.setattr(fastcv, "make_eval_binary", planted)
    with pytest.raises(FloatingPointError, match=r"evaluator evals\('binary'"):
        serve_cv.main(CPU + ["--debug-nans", "--requests", "8"])
    out = serve_cv.main(CPU + ["--requests", "8"])             # without the flag: NaNs served
    assert any(bool(torch.isnan(r.values).any()) for r in out["responses"]
               if getattr(r, "task", None) == "binary")


def test_the_cli_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_cv.parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cv.main([])


def _boot(cmd, env):
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        m = re.search(r"listening on (http://\S+)", line)
        if m:
            return proc, m.group(1), lines
    proc.wait(timeout=60)
    raise AssertionError("serve_cv exited before listening:\n" + "".join(lines))


def _stop(proc, lines):
    proc.send_signal(signal.SIGTERM)
    rest, _ = proc.communicate(timeout=120)
    return proc.returncode, "".join(lines) + rest


def test_http_edge_shuts_down_on_sigterm_and_reboots_warm(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "2"}
    cli = [sys.executable, "-m", "repro_torch.launch.serve_cv", *CPU, "--http", "0",
           "--plan-store", str(tmp_path / "plans")]
    traffic = str(tmp_path / "traffic.json")
    y = np.where(np.arange(96) % 2 == 0, -1.0, 1.0)
    procs = []
    try:
        proc, url, lines = _boot(cli + ["--warmup", "--pin", "--save-plans",
                                        "--record-traffic", traffic], env)
        procs.append(proc)
        with HTTPClient(url) as hc:
            h = hc.datasets()[0]["handle"]
            cv, perm = hc.gather([Workload(kind="cv", dataset=h, y=y),
                                  Workload(kind="permutation", dataset=h, y=y, n_perm=64,
                                           seed=1)])
            assert hc.stats()["engine"]["plans_built"] == 3
        rc, text = _stop(proc, lines)
        assert rc == 0 and "http edge shut down" in text
        assert re.search(r"recorded \d+ \(task, bucket\) entries", text)

        proc, url, lines = _boot(cli + ["--warmup-from", traffic], env)
        procs.append(proc)
        with HTTPClient(url) as hc:
            assert hc.stats()["engine"]["plans_built"] == 0
            h = hc.datasets()[0]["handle"]
            cv2, perm2 = hc.gather([Workload(kind="cv", dataset=h, y=y),
                                    Workload(kind="permutation", dataset=h, y=y, n_perm=64,
                                             seed=1)])
            stats = hc.stats()["engine"]
            assert stats["plans_built"] == 0 and stats["store_hits"] == 3
        assert torch.equal(cv2.values, cv.values) and torch.equal(perm2.null, perm.null)
        rc, text = _stop(proc, lines)
        assert rc == 0 and "http edge shut down" in text
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.mark.parametrize("idle_open", [False, True], ids=["all_closed", "one_idle_open"])
def test_http_edge_shuts_down_while_connections_close(idle_open):
    """SIGTERM right after 200 keep-alive connections close (the server is
    still handling their EOFs), with or without one idle connection left
    open: the edge shuts down and exits 0 rather than waiting forever for a
    connection that is already gone or parked in its read."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "2"}
    cli = [sys.executable, "-m", "repro_torch.launch.serve_cv", *CPU, "--http", "0",
           "--datasets", "1", "--n", "32", "--p", "64"]
    proc, url, lines = _boot(cli, env)
    socks = []
    try:
        host, port = url.removeprefix("http://").rsplit(":", 1)
        for _ in range(200):
            s = socket.create_connection((host, int(port)))
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: edge\r\n\r\n")
            socks.append(s)
        for s in socks:
            assert s.recv(4096).startswith(b"HTTP/1.1 200")
        for s in socks[idle_open:]:
            s.close()
        rc, text = _stop(proc, lines)
        assert rc == 0 and "http edge shut down" in text
    finally:
        for s in socks:
            s.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
