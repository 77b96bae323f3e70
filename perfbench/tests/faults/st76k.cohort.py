"""Broken timed paths of ``st76k.cohort``: the library's binary and
3-class CV, each answer altered where it is produced."""

from perfbench_faultkit import altered, first_plus, next_class, pair_first
from repro_torch.core import fastcv, multiclass

FAULTS = {
    "decision value altered": (fastcv, "binary_cv",
                               lambda f: altered(f, pair_first(first_plus(1.0)))),
    "class altered": (multiclass, "analytical_cv_multiclass",
                      lambda f: altered(f, pair_first(next_class))),
}
