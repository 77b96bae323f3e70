"""repro_torch's training infrastructure against the reference on the CPU:
the token stream, checkpoints, the straggler monitor and slice queue, the
Trainer's restart and non-finite skipping, and ``launch.train``.

The token stream equals the reference's bit for bit; the monitor and the
queue are driven through the same sequences as the reference's and must
decide alike. A restarted Trainer resumes at its checkpoint's step with the
data cursor and ends equal, bit for bit, to an uninterrupted run.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.tokens import TokenStream as RefTokenStream
from repro.data.tokens import TokenStreamConfig as RefTokenStreamConfig
from repro.train.straggler import SliceQueue as RefSliceQueue
from repro.train.straggler import StepTimeMonitor as RefStepTimeMonitor
from repro_torch.configs.base import get_config
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.models import model as M
from repro_torch.optim import optimizer as O
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import steps
from repro_torch.train.straggler import SliceQueue, StepTimeMonitor
from repro_torch.train.trainer import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ token stream ----

@pytest.mark.parametrize("extra", [{}, {"num_codebooks": 4},
                                   {"vision_tokens": 6, "vision_dim": 8}],
                         ids=["text", "codebooks", "vision"])
def test_token_stream_equals_the_reference_bit_for_bit(extra):
    kw = dict(vocab_size=512, seq_len=16, global_batch=4, seed=3, **extra)
    ours = TokenStream(TokenStreamConfig(**kw), device="cpu")
    ref = RefTokenStream(RefTokenStreamConfig(**kw))
    for step in range(3):
        got, want = ours.next_batch(), ref.next_batch()
        assert set(got) == set(want)
        for k in want:
            assert got[k].device.type == "cpu"
            assert got[k].dtype == {"int32": torch.int32, "float32": torch.float32}[
                str(want[k].dtype)]
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert ours.checkpoint_state() == ref.checkpoint_state() == {"step": step + 1, "seed": 3}
    # per-shard batches and a restored cursor
    for shard in range(2):
        a = TokenStream(TokenStreamConfig(**kw), step=5, device="cpu").next_batch(shard, 2)
        b = RefTokenStream(RefTokenStreamConfig(**kw), step=5).next_batch(shard, 2)
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    back = TokenStream.restore(TokenStreamConfig(**kw), ours.checkpoint_state(), device="cpu")
    np.testing.assert_array_equal(back.next_batch()["tokens"].numpy(),
                                  np.asarray(ref.next_batch()["tokens"]))
    with pytest.raises(ValueError, match="seed changed"):
        TokenStream.restore(TokenStreamConfig(**kw), {"step": 1, "seed": 4}, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        ours.next_batch(0, 3)


# ------------------------------------------------------------- checkpoints ----

def _tree():
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(4, 5, generator=gen)
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)},
            "bf": (torch.randn(3, 7, generator=gen) * 1e3).to(torch.bfloat16),
            "st": O.OptState(step=torch.tensor(7, dtype=torch.int32), master={"w": w},
                             mu={"w": w * 0.5}, nu={"w": w * w}, err=None),
            "lst": [torch.zeros(2, dtype=torch.int8), torch.tensor(2.5, dtype=torch.float64)]}


def _leaves(tree):
    return ckpt.flatten(tree)


def test_checkpoint_roundtrip_with_bf16(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 7, tree, metadata={"cursor": 42})
    assert ckpt.latest_step(tmp_path) == 7
    like = {k: v for k, v in tree.items()}
    restored, meta = ckpt.restore(tmp_path, 7, like)
    assert meta == {"cursor": 42}
    assert isinstance(restored["st"], O.OptState) and restored["st"].err is None
    assert [n for n, _ in _leaves(restored)] == [n for n, _ in _leaves(tree)]
    for (name, got), (_, want) in zip(_leaves(restored), _leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype == torch.bfloat16 else want)
    manifest = (tmp_path / "step_00000007" / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest
    # numpy holds the bf16 tensor as its bits
    assert np.load(tmp_path / "step_00000007" / "bf.npy").dtype == np.int16


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.zeros(3)})
    (tmp_path / "step_00000002.tmp").mkdir()        # a crash mid-write of step 2
    (tmp_path / "step_00000003").mkdir()            # a directory without its manifest
    assert ckpt.latest_step(tmp_path) == 1
    assert ckpt.latest_step(tmp_path / "absent") is None


def test_checkpoint_gc(tmp_path):
    for s in (1, 2, 3, 4):
        ckpt.save(tmp_path, s, {"a": torch.zeros(2)}, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000004"]


def test_async_checkpoint_snapshots_by_copy(tmp_path, monkeypatch):
    """save_async copies before it returns: an in-place update made while the
    writer is held back does not reach the checkpoint (``t.cpu()`` of a CPU
    tensor would be the tensor itself)."""
    release = threading.Event()
    write = ckpt._write

    def held(*args):
        release.wait(timeout=30)
        return write(*args)

    monkeypatch.setattr(ckpt, "_write", held)
    w = torch.arange(8.0)
    bf = torch.ones(3, dtype=torch.bfloat16)
    ckpt.save_async(tmp_path, 5, {"w": w, "bf": bf})
    w.add_(100.0)
    bf.mul_(3)
    release.set()
    ckpt.wait_for_pending()
    assert ckpt.latest_step(tmp_path) == 5
    restored, _ = ckpt.restore(tmp_path, 5, {"w": w, "bf": bf})
    assert torch.equal(restored["w"], torch.arange(8.0))
    assert torch.equal(restored["bf"], torch.ones(3, dtype=torch.bfloat16))


def test_restore_onto_another_device(tmp_path):
    """``device`` places every tensor (here: ``like`` lives on the meta
    device, which holds no data, and the restore lands on the CPU)."""
    tree = _tree()
    ckpt.save(tmp_path, 3, tree)
    like = {k: v for k, v in tree.items()}
    like["a"] = torch.empty(2, 3, device="meta")
    like["bf"] = torch.empty(3, 7, dtype=torch.bfloat16, device="meta")
    restored, _ = ckpt.restore(tmp_path, 3, like, device="cpu")
    assert restored["a"].device.type == "cpu" and torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["bf"], tree["bf"])
    default, _ = ckpt.restore(tmp_path, 3, like)
    assert default["a"].device.type == "meta"


# ------------------------------------------------------------- stragglers ----

def test_step_time_monitor_decides_as_the_reference():
    rng = np.random.default_rng(0)
    times = list(rng.uniform(0.09, 0.11, 60))
    for i in (12, 30, 31, 55):
        times[i] *= 5                              # slow steps
    for kw in ({}, {"threshold": 2.0, "warmup_steps": 0, "window": 8}):
        ours, ref = StepTimeMonitor(**kw), RefStepTimeMonitor(**kw)
        assert ours.median is None and ref.median is None
        for i, t in enumerate(times):
            assert ours.record(i, float(t)) == ref.record(i, float(t))
            assert ours.median == ref.median
        assert ours.events == ref.events and len(ours.events) >= 3


def test_slice_queue_decides_as_the_reference():
    """One script of acquires, completions (late and duplicate ones too) and
    clock moves on both queues."""
    now = [0.0]
    ours = SliceQueue(5, lease_seconds=10.0, clock=lambda: now[0])
    ref = RefSliceQueue(5, lease_seconds=10.0, clock=lambda: now[0])
    script = [("acq", "pod0"), ("acq", "pod1"), ("acq", "pod2"), ("done", 1, "pod1"),
              ("tick", 11.0), ("acq", "pod3"), ("acq", "pod3"), ("done", 0, "pod0"),
              ("done", 0, "pod3"), ("acq", "pod1"), ("acq", "pod1"), ("tick", 30.0),
              ("acq", "pod4"), ("done", 1, "pod1"), ("acq", "pod4"), ("acq", "pod4"),
              ("acq", "pod4"), ("acq", "pod4")]
    got_ids = []
    for act in script:
        if act[0] == "tick":
            now[0] = act[1]
            continue
        if act[0] == "acq":
            a, b = ours.acquire(act[1]), ref.acquire(act[1])
            got_ids.append(a)
        else:
            a, b = ours.complete(act[1], act[2]), ref.complete(act[1], act[2])
        assert a == b, act
        assert ours.finished == ref.finished
    for s in got_ids:
        if s is not None and s not in ours.done:
            assert ours.complete(s, ours.leases[s].worker) == ref.complete(s, ref.leases[s].worker)
    assert ours.reassignments == ref.reassignments and ours.reassignments
    assert ours.done == ref.done and ours.finished == ref.finished


# ---------------------------------------------------------------- trainer ----

def _trainer(tmp_path, total, every, sub="ck", log_every=1):
    cfg = get_config("starcoder2-3b", smoke=True)
    opt_cfg = O.AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=20, schedule="cosine")
    scfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=1)
    tcfg = TrainerConfig(total_steps=total, log_every=log_every, checkpoint_every=every,
                         checkpoint_dir=str(tmp_path / sub))
    return Trainer(cfg, opt_cfg, tcfg, TokenStream(scfg, device="cpu"))


def _state_tensors(t: Trainer):
    return _leaves({"params": steps.trainable(t.params), "opt_state": t.opt_state})


def test_trainer_end_to_end_with_restart(tmp_path, capsys):
    """The reference's restart test (test_train_infra) on the port, then the
    restarted run against an uninterrupted one: the same losses, parameters
    and optimizer state, bit for bit."""
    t1 = _trainer(tmp_path, 10, 5, log_every=2)
    r1 = t1.run()
    assert r1["steps"] == 10 and np.isfinite(r1["final_loss"])
    assert ckpt.latest_step(tmp_path / "ck") == 10
    saved = [(n, x.clone()) for n, x in _state_tensors(t1)]

    t2 = _trainer(tmp_path, 16, 5, log_every=2)         # "crash" and restart
    assert t2.start_step == 10
    assert t2.stream.step == 10                          # data cursor restored
    assert "[trainer] restored step 10" in capsys.readouterr().out
    for (name, got), (_, want) in zip(_state_tensors(t2), saved):
        assert torch.equal(got, want), name              # restored = saved
    r2 = t2.run()
    assert r2["steps"] == 6
    assert r2["log"][-1]["loss"] < r1["log"][0]["loss"]  # training is learning
    assert set(r2) == {"final_loss", "steps", "skipped", "straggler_events", "wall_s", "log"}
    assert set(r2["log"][0]) == {"step", "loss", "grad_norm", "lr", "sec"}

    whole = _trainer(tmp_path, 16, 100, sub="whole")                # logs every step
    rw = whole.run()
    by_step = {e["step"]: e["loss"] for e in rw["log"]}
    assert {e["step"]: e["loss"] for e in r1["log"] + r2["log"]}.items() <= by_step.items()
    assert len(r2["log"]) == 4 and rw["final_loss"] == r2["final_loss"]
    for (name, got), (_, want) in zip(_state_tensors(t2), _state_tensors(whole)):
        assert torch.equal(got, want), name
    assert ckpt.latest_step(tmp_path / "whole") is None


def test_non_finite_step_leaves_no_trace(tmp_path, monkeypatch, capsys):
    """A NaN loss: the parameters and every optimizer tensor stay bitwise as
    they were, the step count too, and the batch is consumed."""
    t = _trainer(tmp_path, 4, 100)
    loss_fn = M.loss_fn
    poison = {2}                                  # the third call of loss_fn
    calls = []

    def maybe_nan(*args, **kwargs):
        loss, metrics = loss_fn(*args, **kwargs)
        calls.append(None)
        if len(calls) - 1 in poison:
            loss = loss * float("nan")
        return loss, metrics

    monkeypatch.setattr(M, "loss_fn", maybe_nan)
    step_fn = steps.make_train_step(t.cfg, t.opt_cfg)
    for _ in range(2):
        step_fn(t.params, t.opt_state, t.stream.next_batch(), skip_nonfinite=True)
    before = [(n, x.clone()) for n, x in _state_tensors(t)]
    m = step_fn(t.params, t.opt_state, t.stream.next_batch(), skip_nonfinite=True)
    assert m["skipped"] and not np.isfinite(float(m["loss"]))
    for (name, got), (_, want) in zip(_state_tensors(t), before):
        assert torch.equal(got, want), name
    assert int(t.opt_state.step) == 2 and t.stream.step == 3

    # through the Trainer: one skipped step of four, logged as such
    calls.clear()
    poison.clear()
    poison.add(1)
    t = _trainer(tmp_path, 4, 100, sub="ck2")
    r = t.run()
    assert r["skipped"] == 1 and int(t.opt_state.step) == 3 and t.stream.step == 4
    assert "[trainer] step 1: non-finite loss, skipped" in capsys.readouterr().out
    assert [e["step"] for e in r["log"]] == [0, 2, 3]


def test_launch_train_runs_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --arch gemma2-2b
    --smoke --steps 6``, checkpointing every 3 steps; run again with 8
    steps, it resumes at step 6."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
           "gemma2-2b", "--smoke", "--seq-len", "16", "--batch", "4",
           "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "3"]
    first = subprocess.run(cmd + ["--steps", "6"], cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=240)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "[train] arch=gemma2-2b-smoke" in first.stdout
    assert "[train] done: final_loss=" in first.stdout and "skipped=0" in first.stdout
    assert ckpt.latest_step(tmp_path / "ck") == 6
    again = subprocess.run(cmd + ["--steps", "8"], cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=240)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "[trainer] restored step 6" in again.stdout and "[trainer] step 7 " in again.stdout


def test_launch_train_flags_as_the_reference(monkeypatch, capsys):
    """MiniCPM trains on WSD by default, as in the reference; ``--help`` says
    that ``--profile``'s rules lay out nothing at world size 1, and the
    Trainer is handed the profile's rules."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train

    with pytest.raises(SystemExit):
        train.main(["--help"])
    assert "at world size 1" in " ".join(capsys.readouterr().out.split())
    seen = {}

    class Recorded:
        def __init__(self, cfg, opt_cfg, tcfg, stream, rules):
            seen.update(cfg=cfg, opt=opt_cfg, tcfg=tcfg, stream=stream, rules=rules)

        def run(self):
            return {"final_loss": 1.0, "wall_s": 0.0, "skipped": 0, "straggler_events": 0}

    monkeypatch.setattr(train, "Trainer", Recorded)
    train.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--steps", "40"])
    assert seen["opt"].schedule == "wsd" and seen["opt"].warmup_steps == 5
    assert seen["tcfg"].log_every == 2 and seen["stream"].device.type == "cpu"
    assert seen["rules"] == sh.rules_for("tp")
    train.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--profile", "dp"])
    assert seen["rules"] == sh.rules_for("dp") and seen["rules"].logical["heads"] is None
    train.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu", "--schedule", "const",
                "--compress-grads", "--set", "num_layers=2"])
    assert seen["opt"].schedule == "const" and seen["opt"].compress_grads
    assert seen["cfg"].num_layers == 2 and seen["stream"].cfg.num_codebooks == 2


def test_profile_rules_are_recorded_and_move_no_number_at_world_size_1(tmp_path):
    """``tp`` and ``dp`` train the smoke config to bit-identical losses and
    parameters in one process; each Trainer holds its profile's rules and
    writes them into its checkpoint's metadata."""
    from repro_torch.launch import sharding as sh

    def run(profile):
        cfg = get_config("gemma2-2b", smoke=True)
        opt_cfg = O.AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=20)
        scfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=1)
        tcfg = TrainerConfig(total_steps=3, log_every=1, checkpoint_every=3,
                             checkpoint_dir=str(tmp_path / profile))
        t = Trainer(cfg, opt_cfg, tcfg, TokenStream(scfg, device="cpu"),
                    rules=sh.rules_for(profile))
        return t, t.run()

    (tp, r_tp), (dp, r_dp) = run("tp"), run("dp")
    assert tp.rules == sh.rules_for("tp") and dp.rules == sh.rules_for("dp")
    assert [e["loss"] for e in r_tp["log"]] == [e["loss"] for e in r_dp["log"]]
    for (name, a), (_, b) in zip(_state_tensors(tp), _state_tensors(dp)):
        assert torch.equal(a, b), name
    for t, profile in ((tp, "tp"), (dp, "dp")):
        _, meta = ckpt.restore(tmp_path / profile, 3, t._state(), device="cpu")
        assert meta["sharding"] == sh.rules_for(profile).as_dict()
