"""grid_plan_ms: a grid point's plan build, the program's ``hat_matrix`` and
``fold_factors`` spans summed over the window, over its ``grid_point``
spans."""

PLAN = ("hat_matrix", "fold_factors")


def read(run):
    points = sum(1 for name, _, _ in run.spans if name == "grid_point")
    seconds = sum(t1 - t0 for name, t0, t1 in run.spans if name in PLAN)
    return 1e3 * seconds / points if points else None
