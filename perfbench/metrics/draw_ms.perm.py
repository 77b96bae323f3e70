"""draw_ms.perm: the program's ``draw`` spans (the permutation draws, inside
``null_chunk``) summed over the window, over the permutation requests that
completed."""


def read(run):
    done = sum(1 for r in run.done() if r.units.get("perms"))
    seconds = sum(t1 - t0 for name, t0, t1 in run.spans if name == "draw")
    return 1e3 * seconds / done if done and seconds > 0 else None
