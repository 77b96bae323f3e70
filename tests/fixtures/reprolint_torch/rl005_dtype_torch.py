"""Seeded RL005 violations: sub-float64 dtypes in a host-float64 region."""

import numpy as np
import torch

# reprolint: host-float64


def correction(a, b):
    a64 = torch.as_tensor(a, dtype=torch.float64)  # allowed
    small = torch.as_tensor(b, dtype=torch.float32)  # seeded: RL005
    tiny = a64.half()  # seeded: RL005 (cast method)
    text = np.asarray(b).astype("float16")  # seeded: RL005 (string token)
    wide = np.asarray(a, dtype=np.float64)  # allowed
    return small, tiny, text, wide


def outside_the_region_is_still_the_module(x):
    return x.float()  # seeded: RL005 (module-scoped pragma)
