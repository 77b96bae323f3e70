"""A clean host-path module: the port's reprolint exits 0 here."""

import time

import numpy as np
import torch

# reprolint: host-path
# reprolint: monotonic-time
# reprolint: host-float64


def coalesce(blocks, device):
    batch = np.concatenate([np.asarray(b, dtype=np.float64) for b in blocks], axis=1)
    return torch.as_tensor(batch, dtype=torch.float64, device=device)


def deadline(window_s):
    return time.monotonic() + window_s
