"""Seeded RL001 violations: eager torch assembly, .item() and a wall clock."""

import time

import numpy as np
import torch
import torch.nn.functional as F

# reprolint: host-path
# reprolint: monotonic-time


def coalesce(blocks):
    batch = torch.cat(blocks, dim=1)  # seeded: RL001 (eager assembly)
    padded = F.pad(batch, (0, 3))  # seeded: RL001 (eager assembly)
    width = int(padded.sum().item())  # seeded: RL001 (.item() blocks the host)
    filler = torch.nn.functional.pad(padded, (1, 0))  # seeded: RL001 (eager assembly)
    ok = torch.as_tensor(np.concatenate([np.asarray(b) for b in blocks], axis=1))  # allowed
    also = torch.from_numpy(np.zeros((2, 3)))  # allowed
    return filler, ok, also, width


def deadline(window_s):
    return time.time() + window_s  # seeded: RL001 (wall clock)
