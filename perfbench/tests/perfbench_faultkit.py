"""Breakers that the cells' fault files (``tests/faults/<cell>.py``) share.

A breaker takes a function of the timed path and returns what stands in
for it: an answer altered where it is produced, half of a batch left out
with the mean of the rest in its place, a draw that is not uniform.
"""

from __future__ import annotations

import torch


def altered(fn, alter):
    def wrapped(*args, **kw):
        return alter(fn(*args, **kw))
    return wrapped


def first_plus(delta):
    def alter(t):
        t = t.clone()
        t.view(-1)[0] += delta
        return t
    return alter


def pair_first(alter):
    return lambda pair: (alter(pair[0]), pair[1])


def next_class(pred):
    pred = pred.clone()
    pred.view(-1)[0] = (pred.view(-1)[0] + 1) % 3
    return pred


def half_then_mean(fn, dim_of_batch):
    """``fn`` over the first half of its batch; the mean of that half
    stands in for the rest."""
    def wrapped(*args, **kw):
        args = list(args)
        batch = args[dim_of_batch]
        half = fn(*args[:dim_of_batch], batch[: (batch.shape[0] + 1) // 2],
                  *args[dim_of_batch + 1:], **kw)
        rest = half.to(torch.float64).mean().to(half.dtype).expand(batch.shape[0] - half.shape[0])
        return torch.cat([half, rest])
    return wrapped


def half_null(null_binary):
    def wrapped(self, plan, y, perms, **kw):
        b = perms.shape[0]
        half = null_binary(self, plan, y, perms[: (b + 1) // 2], **kw)
        rest = half.to(torch.float64).mean().to(half.dtype).expand(b - half.shape[0])
        return torch.cat([half, rest])
    return wrapped


def rotated_draws(permutation_indices):
    """Every row the first row rotated: each row a permutation, none
    repeated while T < N, but not a uniform draw."""
    def wrapped(seed, n, n_perm, *, device=None):
        first = permutation_indices(seed, n, 1, device=device)[0]
        return torch.stack([first.roll(k) for k in range(n_perm)])
    return wrapped


def near_identity_draws(permutation_indices):
    """Every row the identity with two entries of a uniform row swapped in."""
    def wrapped(seed, n, n_perm, *, device=None):
        rows = permutation_indices(seed, n, n_perm, device=device)
        out = torch.arange(n, device=rows.device).repeat(n_perm, 1)
        a, b = rows[:, :1], rows[:, 1:2]
        out.scatter_(1, a, b)
        out.scatter_(1, b, a)
        return out
    return wrapped
