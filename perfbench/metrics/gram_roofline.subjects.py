"""gram_roofline.subjects: the least time the H100 needs for the window's
Gram products (counts.kernels.gram, from the shapes of the program's
``gram`` launches) over the device time of the gram kernels.

Kernels summed (a rename leaves the metric silent): KERNELS.
"""

from counts import kernels as counts

KERNELS = ("upper_gram_tc_kernel", "gram_reduce_kernel")


def read(run):
    trace = run.device_trace
    if trace is None:
        return None
    seconds = trace.seconds_of(KERNELS)
    itemsize = run.config["itemsize"]
    bound = sum(count * counts.gram(shape[0], shape[1], itemsize)[0]
                for (kernel, shape), count in run.launches.items() if kernel == "gram")
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None
