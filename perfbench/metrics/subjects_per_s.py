"""subjects_per_s: complete subject analyses of the window over the
window's seconds (host clock; the window ends with its last request)."""


def read(run):
    return sum(r.units.get("subjects", 0) for r in run.done()) / run.window_s
