"""End-to-end driver: train a ~100M-param LM for a few hundred steps.

Uses the xlstm-125m architecture at FULL width (768 d_model, 12 layers)
with the vocabulary cut to 2,048 and f32 weights, through the Trainer
(checkpointing, straggler monitor, WSD-capable optimizer, restart-safe data
cursor).

Run:  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] [--device cpu]

On the card by default; ``--device cpu`` runs the plain PyTorch versions
(use a short run there, e.g. ``--steps 8 --seq-len 16 --batch 2``).
"""

import argparse
import dataclasses

from repro_torch.configs.base import get_config
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.optim import optimizer as O
from repro_torch.train.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=2048,
                    help="reduced vocab keeps the step time sane; "
                    "model width/depth stay at the assigned 125M config")
    ap.add_argument("--checkpoint-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config("xlstm-125m")
    cfg = dataclasses.replace(cfg, vocab_size=args.vocab, dtype="float32",
                              param_dtype="float32")
    print(f"[train_lm] {cfg.name}: ~{cfg.param_count():,} params "
          f"(vocab reduced to {args.vocab}) on {args.device}")

    opt = O.AdamWConfig(lr_peak=3e-3, warmup_steps=20,
                        total_steps=args.steps, schedule="cosine")
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, seed=0), device=args.device)
    tcfg = TrainerConfig(total_steps=args.steps, log_every=20,
                         checkpoint_every=100,
                         checkpoint_dir=args.checkpoint_dir)
    summary = Trainer(cfg, opt, tcfg, stream).run()
    first, last = summary["log"][0]["loss"], summary["log"][-1]["loss"]
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} over "
          f"{summary['steps']} steps ({summary['wall_s']:.0f}s)")
    assert last < first, "training failed to reduce loss"


if __name__ == "__main__":
    main()
