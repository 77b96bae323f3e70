"""perm_per_s: permuted label vectors cross-validated in the window (T for
each completed request) over the window's seconds (host clock). The run's
check holds the count to the engine's ``labels_evaluated``."""


def read(run):
    return sum(r.units.get("perms", 0) for r in run.done()) / run.window_s
