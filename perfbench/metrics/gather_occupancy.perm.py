"""gather_occupancy.perm: requests per server gather window, the mean of the
program's ``gather_window_occupancy`` histogram over the window."""


def read(run):
    count, total = run.counters.get("gather_window_occupancy", (0, 0.0))
    return total / count if count else None
