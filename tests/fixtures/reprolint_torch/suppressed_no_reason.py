"""A bare suppression: it suppresses nothing and is itself an RL000 error."""

import torch

# reprolint: host-path


def grow(x2, x_new):
    return torch.cat([x2, x_new])  # reprolint: ignore[RL001]
