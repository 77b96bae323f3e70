"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        [--smoke] [--steps 200] [--seq-len 64] [--batch 8] [--device cpu]

The full configuration runs by default, on the card (attention through the
flash_attention kernel, its gradient through the plain version); ``--smoke``
takes the reduced one and ``--device cpu`` the plain versions on the CPU.
All fault-tolerance machinery is live: atomic async checkpoints, restart
(rerun the command, it resumes), straggler monitor, non-finite skipping.
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import apply_overrides, get_config, list_archs
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.optim import optimizer as O
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd", "const"])
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--profile", default="tp", choices=["tp", "dp"],
                    help="the sharding profile (launch.sharding.rules_for) whose rules the "
                    "Trainer holds and writes into its checkpoints; at world size 1 (the "
                    "only one this launcher runs) they lay out no tensor")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override field=value")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    dev = resolve_device(args.device)

    # MiniCPM ships with WSD (its paper's contribution); honour it by default
    schedule = args.schedule
    if args.arch == "minicpm-2b" and args.schedule == "cosine":
        schedule = "wsd"

    opt_cfg = O.AdamWConfig(lr_peak=args.lr, schedule=schedule,
                            warmup_steps=max(args.steps // 20, 5),
                            total_steps=args.steps,
                            compress_grads=args.compress_grads)
    scfg = TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, seed=0,
        num_codebooks=cfg.num_codebooks,
        vision_tokens=cfg.vision_tokens, vision_dim=cfg.vision_dim)
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.checkpoint_every,
                         checkpoint_dir=args.checkpoint_dir,
                         log_every=max(args.steps // 20, 1))

    print(f"[train] arch={cfg.name} params≈{cfg.param_count():,} "
          f"devices=1 device={dev} profile={args.profile}")
    trainer = Trainer(cfg, opt_cfg, tcfg, TokenStream(scfg, device=dev),
                      rules=sh.rules_for(args.profile))
    summary = trainer.run()
    print(f"[train] done: final_loss={summary['final_loss']:.4f} "
          f"wall={summary['wall_s']:.1f}s skipped={summary['skipped']} "
          f"stragglers={summary['straggler_events']}")


if __name__ == "__main__":
    main()
