"""The benchmark's own inputs: simulated MEG subjects, folds and λ.

A frozen copy of the yardstick's data side, independent of the program:
the Wakeman-Henson face dataset is not available offline, so each subject
is simulated with its statistical shape (Treder 2018, §2.13): epochs from
-0.5 s to 1 s at 200 Hz over 380 channels, baseline-corrected on the
pre-stimulus interval, a class-specific N170-like component under
spatially correlated noise. Everything is drawn on the device from the
run's seed by ``torch.Generator``s, in a few large calls.

The same arrays go to the program and to the reference.
"""

from __future__ import annotations

import numpy as np
import torch


def subseed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of the run (subject i, folds of i, ...)."""
    state = np.random.SeedSequence([int(seed), *map(int, stream)]).generate_state(1, np.uint64)
    return int(state[0]) & 0x7FFF_FFFF_FFFF_FFFF


def n_times(cfg: dict) -> int:
    return int(round((cfg["t_max_s"] - cfg["t_min_s"]) * cfg["fs_hz"])) + 1


def simulate_epochs(seed: int, cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(epochs (N, channels, times) f32, classes (N,) int64) of one subject."""
    n, ch, c = cfg["n_trials"], cfg["n_channels"], cfg["num_classes"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    times = sample_times(cfg, device)
    patterns = torch.randn((c, ch), generator=gen, dtype=torch.float32, device=device)
    patterns = patterns / torch.linalg.norm(patterns, dim=1, keepdim=True)
    latencies = 0.17 + 0.03 * torch.arange(c, dtype=torch.float64, device=device)
    erp = torch.exp(-0.5 * ((times[None, :] - latencies[:, None]) / 0.05) ** 2) * (times > 0)
    signal = patterns[:, :, None] * erp.to(torch.float32)[:, None, :]          # (C, ch, t)
    classes = torch.arange(n, dtype=torch.int64, device=device) % c
    mix = torch.randn((ch, ch), generator=gen, dtype=torch.float32, device=device) / ch ** 0.5
    white = torch.randn((n, ch, times.numel()), generator=gen, dtype=torch.float32, device=device)
    epochs = torch.matmul(mix, white)                                          # (N, ch, t)
    del white
    epochs += cfg["snr"] * signal[classes]
    epochs -= epochs[:, :, times < 0].mean(dim=2, keepdim=True)
    return epochs, classes


def sample_times(cfg: dict, device) -> torch.Tensor:
    """Seconds from stimulus onset of each sample (float64; onset is 0)."""
    t = torch.arange(n_times(cfg), dtype=torch.float64, device=device)
    return t / cfg["fs_hz"] + cfg["t_min_s"]


def post_stimulus(cfg: dict, device) -> torch.Tensor:
    return torch.nonzero(sample_times(cfg, device) > 0).flatten()


def binary_labels(classes: torch.Tensor, cfg: dict) -> torch.Tensor:
    """±1 f32: the classes listed under ``positive_classes`` against the rest."""
    pos = torch.tensor(cfg["positive_classes"], device=classes.device)
    return torch.where(torch.isin(classes, pos), 1.0, -1.0).to(torch.float32)


def kfold(n: int, k: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(te (K, m), tr (K, N - m)) int32: a shuffled partition into K equal
    test folds; the N % K leftover samples train in every fold."""
    m = n // k
    perm = np.random.default_rng(seed).permutation(n)
    te = perm[: k * m].reshape(k, m).astype(np.int32)
    tr = np.empty((k, n - m), dtype=np.int32)
    for i in range(k):
        keep = np.ones(n, dtype=bool)
        keep[te[i]] = False
        tr[i] = np.nonzero(keep)[0]
    return te, tr


def trace_lambda(x: torch.Tensor) -> float:
    """λ = tr(G_c) / N of (N, P) features (or the mean over a leading grid
    dimension of (Q, N, P) features), summed in float64."""
    xc = x.to(torch.float64)
    xc = xc - xc.mean(dim=-2, keepdim=True)
    per = (xc * xc).sum(dim=(-2, -1)) / x.shape[-2]
    return float(per.mean())


class Subject:
    """One simulated subject in the layout a configuration asks for.

    ``x``: (N, P) spatio-temporal features, or (Q, N, P) for a time-point
    grid; ``y``: ±1 labels; ``classes``: int64 classes; ``te`` / ``tr``:
    the folds on the device (int32); ``lam``: λ = tr(G_c)/N.
    """

    def __init__(self, cfg: dict, seed: int, index: int, device):
        epochs, classes = simulate_epochs(subseed(seed, 1, index), cfg, device)
        if cfg["layout"] == "spatiotemporal":
            post = post_stimulus(cfg, device)
            self.x = epochs[:, :, post].permute(0, 2, 1).reshape(epochs.shape[0], -1).contiguous()
        elif cfg["layout"] == "timepoints":
            self.x = epochs.permute(2, 0, 1).contiguous()
        else:
            raise ValueError(f"unknown layout {cfg['layout']!r}")
        del epochs
        self.classes = classes
        self.y = binary_labels(classes, cfg)
        te, tr = kfold(cfg["n_trials"], cfg["folds"], subseed(seed, 2, index))
        self.te = torch.from_numpy(te).to(device)
        self.tr = torch.from_numpy(tr).to(device)
        self.lam = trace_lambda(self.x)
