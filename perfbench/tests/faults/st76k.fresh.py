"""Broken timed paths of ``st76k.fresh``: the served binary and 3-class
answers, each altered where it is produced."""

from perfbench_faultkit import altered, first_plus, next_class
from repro_torch.core import fastcv, multiclass

FAULTS = {
    "decision value altered": (fastcv, "binary_dvals", lambda f: altered(f, first_plus(1.0))),
    "class altered": (multiclass, "batch_predict", lambda f: altered(f, next_class)),
}
