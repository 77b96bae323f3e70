"""Broken timed paths of ``tp380.grid``: a point's accuracy altered, half
of the points left out with the mean of the rest in their place."""

from perfbench_faultkit import altered, first_plus, half_then_mean
from repro_torch.core import multidim

FAULTS = {
    "point accuracy altered": (multidim, "cv_grid", lambda f: altered(f, first_plus(0.25))),
    "half the points, their mean for the rest": (multidim, "cv_grid",
                                                 lambda f: half_then_mean(f, 0)),
}
