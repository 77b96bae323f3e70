"""Layer-probe launcher: the paper's technique applied to model representations.

Extracts the residual stream after every block repeat of a transformer
(mean-pooled over the sequence), then runs an analytical-CV LDA
permutation test (Algorithm 1) on each point: the "classifier per time
point" of the paper's §2.13 becomes a probe per layer, with the same
K·T training-iteration explosion that Algorithm 1 collapses.

    PYTHONPATH=src python -m repro_torch.launch.probe --arch gemma2-2b \
        --n-per-class 48 --n-perm 200 [--smoke]

The full configuration runs by default, on the card (the forward through
the flash_attention kernel, the probes through gram, hat_apply and
foldsolve); ``--smoke`` takes the reduced one and ``--device cpu`` the
plain versions on the CPU.
"""

from __future__ import annotations

import argparse
from collections.abc import Sequence

import torch

from repro_torch.configs.base import ArchConfig, get_config, list_archs
from repro_torch.core import folds as foldlib
from repro_torch.core import permutation
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def layerwise_hidden_states(params: M.Model, tokens: torch.Tensor,
                            cfg: ArchConfig) -> torch.Tensor:
    """Forward pass capturing the residual stream after every block repeat.

    Returns (n_points, N, d_model) float32 — one feature set per repeat of
    the layer pattern (the tail is not a point), mean-pooled over the
    sequence in the compute dtype. Every block kind runs (attention,
    RG-LRU, MoE MLPs).
    """
    positions = M._positions(tokens.shape[-1], tokens.device)
    h = M._embed(params, tokens, cfg)
    pat, n_rep, _ = T._pattern_split(cfg)
    snaps = []
    for r in range(n_rep):
        for i in range(len(pat)):
            h = T.apply_block_full(params.blocks.layers[r * len(pat) + i], h, cfg,
                                   positions=positions)[0]
        snaps.append(h.mean(dim=1))
    return torch.stack(snaps).float()


def band_tokens(cfg: ArchConfig, n_per_class: int, seq_len: int, generator: torch.Generator):
    """Two synthetic "stimulus classes": sequences drawn from the lower and the
    upper half of the vocabulary. Returns (tokens (2n, S), labels ±1 f64)."""
    half_v = cfg.vocab_size // 2
    dev = generator.device
    tok_a = torch.randint(0, half_v, (n_per_class, seq_len), generator=generator, device=dev)
    tok_b = torch.randint(half_v, cfg.vocab_size, (n_per_class, seq_len), generator=generator,
                          device=dev)
    y = torch.cat([-torch.ones(n_per_class, dtype=torch.float64, device=dev),
                   torch.ones(n_per_class, dtype=torch.float64, device=dev)])
    return torch.cat([tok_a, tok_b]), y


def probe_points(feats: torch.Tensor, y: torch.Tensor, folds: foldlib.Folds,
                 lam: float | Sequence[float], n_perm: int) -> list:
    """One analytical permutation test per point, at float64, with one λ
    for every point or one per point (the residual stream's scale grows
    with depth); the point's index seeds its permutations."""
    lams = [lam] * feats.shape[0] if isinstance(lam, (int, float)) else list(lam)
    return [permutation.analytical_permutation_binary(
        feats[li].double(), y.double(), folds, lams[li], n_perm, seed=li,
        chunk=min(n_perm, 64)) for li in range(feats.shape[0])]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=list_archs())
    ap.add_argument("--n-per-class", type=int, default=48)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--n-perm", type=int, default=100)
    ap.add_argument("--folds", type=int, default=6)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(cfg, generator=gen, device=dev)
    tokens, y = band_tokens(cfg, args.n_per_class, args.seq_len, gen)
    feats = layerwise_hidden_states(params, tokens, cfg)
    f = foldlib.kfold(tokens.shape[0], args.folds, seed=0, device=dev)
    results = probe_points(feats, y, f, args.lam, args.n_perm)

    print(f"[probe] arch={cfg.name} layers(points)={feats.shape[0]} "
          f"N={tokens.shape[0]} P={feats.shape[2]} perms={args.n_perm} device={dev}")
    print("point | observed acc | p-value | null mean")
    for li, res in enumerate(results):
        print(f"{li:5d} | {float(res.observed):.3f}        | "
              f"{float(res.p):.4f}  | {float(res.null.mean()):.3f}")


if __name__ == "__main__":
    main()
