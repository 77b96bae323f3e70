"""A violation suppressed *with* a justification: reprolint honors it."""

import torch

# reprolint: host-path


def grow(x2, x_new):
    return torch.cat([x2, x_new])  # reprolint: ignore[RL001] -- both already on the card
