"""grid_point_ms: a grid request's service time (the program's spans but
the queue wait, ``batch_wait``) over its grid points, mean over requests."""


from harness.data import n_times


def read(run):
    points = n_times(run.config)
    per = [sum(v for k, v in r.timings.items() if k != "batch_wait") / points
           for r in run.done() if r.units.get("subjects") and r.timings]
    return 1e3 * sum(per) / len(per) if per else None
