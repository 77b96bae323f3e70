"""EEG/MEG-like dataset simulator mirroring the paper's §2.13 analysis.

The Wakeman-Henson dataset is not available offline, so the data are
synthesised with the same *statistical shape*: epoched recordings with 380
channels, 200 Hz sampling, epochs from -0.5 s to 1 s, a class-dependent
evoked response, and spatially correlated noise. The feature constructions:

  * per-timepoint features: 380 channels at one sample        (P = 380)
  * windowed features: channel amplitudes averaged in windows
    and concatenated: 100 ms → P = 3800, 200 ms → 1900, and one
    sample per window (5 ms) → 200 × 380 = 76,000

Sample times are computed as i / FS + T_MIN, so the stimulus onset is
exactly 0 and the post-stimulus interval holds 200 samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.common import resolve_device

__all__ = ["EEGDataset", "simulate_subject", "timepoint_features", "windowed_features"]

N_CHANNELS = 380
FS = 200.0
T_MIN, T_MAX = -0.5, 1.0


class EEGDataset(NamedTuple):
    epochs: torch.Tensor   # (n_trials, n_channels, n_times)
    y: torch.Tensor        # (n_trials,) int class labels
    times: torch.Tensor    # (n_times,) seconds relative to stimulus onset


def simulate_subject(seed: int, n_trials: int = 787, num_classes: int = 2,
                     snr: float = 0.5, dtype=torch.float32, *,
                     device=None) -> EEGDataset:
    """One subject's epoched data with a class-specific N170-like component."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_times = int(round((T_MAX - T_MIN) * FS)) + 1
    times = (torch.arange(n_times, dtype=torch.float64, device=dev) / FS + T_MIN).to(dtype)

    # class-specific spatial patterns and latencies (ERP component ~170 ms)
    patterns = torch.randn((num_classes, N_CHANNELS), generator=gen, dtype=dtype, device=dev)
    patterns = patterns / torch.linalg.norm(patterns, dim=1, keepdim=True)
    latencies = 0.17 + 0.03 * torch.arange(num_classes, dtype=dtype, device=dev)
    width = 0.05
    erp = torch.exp(-0.5 * ((times[None, :] - latencies[:, None]) / width) ** 2)
    erp = erp * (times[None, :] > 0)                     # causal
    signal = patterns[:, :, None] * erp[:, None, :]      # (C, ch, t)

    y = torch.arange(n_trials, dtype=torch.int32, device=dev) % num_classes
    # spatially correlated noise: white noise mixed through a random matrix
    mix = torch.randn((N_CHANNELS, N_CHANNELS), generator=gen, dtype=dtype,
                      device=dev) / N_CHANNELS ** 0.5
    white = torch.randn((n_trials, N_CHANNELS, n_times), generator=gen, dtype=dtype,
                        device=dev)
    epochs = snr * signal[y] + torch.einsum("cd,ndt->nct", mix, white)
    del white
    # baseline correction on the pre-stimulus interval (paper §2.13)
    pre = times < 0
    base = epochs[:, :, pre].mean(dim=2, keepdim=True)
    return EEGDataset(epochs - base, y, times)


def timepoint_features(ds: EEGDataset, t_index: int) -> torch.Tensor:
    """(n_trials, 380) — channel amplitudes at one time point."""
    return ds.epochs[:, :, t_index]


def windowed_features(ds: EEGDataset, window_ms: float) -> torch.Tensor:
    """Post-stimulus window-averaged amplitudes, concatenated over windows.

    Features are ordered window-major (all channels of window 0, then of
    window 1, ...), as the reference concatenates them.
    """
    t_post = torch.nonzero(ds.times > 0).flatten()
    samples_per_win = int(round(window_ms / 1000.0 * FS))
    n_win = len(t_post) // samples_per_win
    sl = t_post[: n_win * samples_per_win]
    n, ch = ds.epochs.shape[:2]
    win = ds.epochs[:, :, sl].reshape(n, ch, n_win, samples_per_win).mean(dim=3)
    return win.permute(0, 2, 1).reshape(n, n_win * ch)
