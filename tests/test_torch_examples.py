"""Each example under examples/torch/ runs to its end with ``--device cpu``.

The examples start together (one process each) and each test reads its
example's exit code and a line of its output.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"
EXPECT = {
    "quickstart": "match to machine precision",
    "eeg_permutation": "subject 2:",
    "rsa_probe": "model-RDM comparison",
    "serve_quickstart": "1 plan build",
    "streaming_quickstart": "released stale versions",
    "http_quickstart": "wire result is bit-identical",
    "async_stream": "streamed permutation test: p =",
    "train_lm": "[train_lm] loss",
}
#: Arguments beside ``--device cpu``: train_lm's full-width xlstm-125m takes
#: a few seconds a step on one CPU thread, so it trains 6 short steps on a
#: 256-token vocabulary (its loss falls, or it exits non-zero), checkpoints
#: under a temporary directory.
ARGS = {"train_lm": ["--steps", "6", "--seq-len", "16", "--batch", "2", "--vocab", "256"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    args = {**ARGS, "train_lm": ARGS["train_lm"] + [
        "--checkpoint-dir", str(tmp_path_factory.mktemp("train_lm"))]}
    procs = {name: subprocess.Popen([sys.executable, str(EXAMPLES / f"{name}.py"),
                                     "--device", "cpu", *args.get(name, [])], cwd=REPO, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in EXPECT}
    out = {}
    try:
        for name, proc in procs.items():
            text, _ = proc.communicate(timeout=240)
            out[name] = (proc.returncode, text)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def test_every_example_is_covered():
    assert {p.stem for p in EXAMPLES.glob("*.py")} == set(EXPECT)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_example_runs_on_the_cpu(runs, name):
    rc, text = runs[name]
    assert rc == 0, text[-2000:]
    assert EXPECT[name] in text
