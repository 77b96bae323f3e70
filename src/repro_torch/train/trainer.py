"""Training loop with fault tolerance: checkpoint/restart, straggler
monitoring, non-finite-step skipping.

The port of the reference's ``train/trainer.py``, with the same prints,
summary keys and log entries. A restarted job resumes from ``latest_step``
with its data cursor. The model lives on the stream's device; the train
step runs eagerly and in place, so a non-finite loss is caught before the
update is applied (the reference computes the update and discards it):
a skipped step leaves the parameters and the optimizer state as they were,
and its batch is consumed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import sharding as sh
from repro_torch.optim import optimizer as O
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import steps as steps_lib
from repro_torch.train.straggler import StepTimeMonitor

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    skip_nonfinite: bool = True
    straggler_threshold: float = 2.5


class Trainer:
    """``seed`` seeds the generator (on the stream's device) that draws the
    initial weights. ``rules`` are the sharding rules of the run
    (``launch.sharding.rules_for``; default the ``tp`` profile's): the
    trainer holds them as ``rules`` and writes them into every checkpoint's
    metadata. A run of one process lays out nothing, so they move no
    number."""

    def __init__(self, cfg: ArchConfig, opt_cfg: O.AdamWConfig,
                 tcfg: TrainerConfig, stream: TokenStream, seed: int = 0,
                 rules: Optional[sh.Rules] = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.rules = sh.DEFAULT_RULES if rules is None else rules
        self.stream = stream
        self.device = stream.device
        self.monitor = StepTimeMonitor(threshold=tcfg.straggler_threshold)
        self.metrics_log: list[dict] = []

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params, self.opt_state = steps_lib.init_train_state(
            cfg, opt_cfg, generator=gen, device=self.device)
        self._step_fn = steps_lib.make_train_step(cfg, opt_cfg)
        self.start_step = 0
        self._maybe_restore()

    def _state(self) -> dict:
        return {"params": steps_lib.trainable(self.params), "opt_state": self.opt_state}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- resume --
    def _maybe_restore(self):
        last = ckpt.latest_step(self.tcfg.checkpoint_dir)
        if last is None:
            return
        # through host memory into the tensors in place: the card never holds
        # two copies of the state (31 GB of f32 master and moments at gemma2-2b)
        restored, meta = ckpt.restore(self.tcfg.checkpoint_dir, last, self._state(),
                                      device="cpu")
        with torch.no_grad():
            for (_, dst), (_, src) in zip(ckpt.flatten(self._state()), ckpt.flatten(restored),
                                          strict=True):
                dst.copy_(src)
        self.start_step = last
        if "data" in meta:
            self.stream = TokenStream.restore(self.stream.cfg, meta["data"],
                                              device=self.device)
        print(f"[trainer] restored step {last} from {self.tcfg.checkpoint_dir}")

    def _checkpoint(self, step: int):
        ckpt.save_async(
            self.tcfg.checkpoint_dir, step, self._state(),
            metadata={"data": self.stream.checkpoint_state(),
                      "arch": self.cfg.name, "sharding": self.rules.as_dict()},
            keep=self.tcfg.keep_checkpoints)

    # --------------------------------------------------------------- loop --
    def run(self) -> dict:
        t_total = time.time()
        skipped = 0
        for step in range(self.start_step, self.tcfg.total_steps):
            batch = self.stream.next_batch()
            t0 = time.time()
            metrics = self._step_fn(self.params, self.opt_state, batch,
                                    skip_nonfinite=self.tcfg.skip_nonfinite)
            loss = float(metrics["loss"])
            self._sync()
            dt = time.time() - t0

            if metrics.get("skipped"):
                # fault tolerance: drop the update, keep going
                skipped += 1
                print(f"[trainer] step {step}: non-finite loss, skipped")
                continue

            if self.monitor.record(step, dt):
                print(f"[trainer] step {step}: straggler "
                      f"({dt:.2f}s vs median {self.monitor.median:.2f}s)")
            if step % self.tcfg.log_every == 0 or step == self.tcfg.total_steps - 1:
                entry = {"step": step, "loss": loss,
                         "grad_norm": float(metrics["grad_norm"]),
                         "lr": float(metrics["lr"]), "sec": dt}
                self.metrics_log.append(entry)
                print(f"[trainer] step {step} loss={loss:.4f} "
                      f"gnorm={entry['grad_norm']:.3f} lr={entry['lr']:.2e} "
                      f"({dt:.2f}s)")
            if (step + 1) % self.tcfg.checkpoint_every == 0:
                self._checkpoint(step + 1)

        ckpt.wait_for_pending()
        return {
            "final_loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
            "steps": self.tcfg.total_steps - self.start_step,
            "skipped": skipped,
            "straggler_events": len(self.monitor.events),
            "wall_s": time.time() - t_total,
            "log": self.metrics_log,
        }
