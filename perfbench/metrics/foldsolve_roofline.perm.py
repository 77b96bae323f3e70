"""foldsolve_roofline.perm: the least time the H100 needs for the window's
fold solves (counts.kernels.foldsolve, from the shapes of the program's
``foldsolve`` launches) over the device time of the fold-solve kernel.

Kernels summed (a rename leaves the metric silent): KERNELS.
"""

from counts import kernels as counts

KERNELS = ("foldsolve_kernel",)


def read(run):
    trace = run.device_trace
    if trace is None:
        return None
    seconds = trace.seconds_of(KERNELS)
    itemsize = run.config["itemsize"]
    bound = sum(count * counts.foldsolve(shape[0], shape[1], shape[2], itemsize)[0]
                for (kernel, shape), count in run.launches.items() if kernel == "foldsolve")
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None
