"""Broken timed paths of ``st76k.perm1000``: a null value altered, half of
a batch of draws left out with the mean of the rest in its place, and
draws that are permutations but not uniform."""

from perfbench_faultkit import (altered, first_plus, half_null, near_identity_draws,
                                rotated_draws)
from repro_torch.core import permutation
from repro_torch.serve.engine import CVEngine

FAULTS = {
    "null value altered": (permutation, "_fold_metric_binary",
                           lambda f: altered(f, first_plus(0.25))),
    "half the draws, their mean for the rest": (CVEngine, "null_binary", half_null),
    "draws rotated": (permutation, "permutation_indices", rotated_draws),
    "draws near the identity": (permutation, "permutation_indices", near_identity_draws),
}
