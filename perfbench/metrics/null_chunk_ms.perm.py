"""null_chunk_ms.perm: the program's ``null_chunk`` spans (draws and null
evaluation) summed for each permutation request, mean over requests."""


def read(run):
    per = [r.timings["null_chunk"] for r in run.done()
           if r.units.get("perms") and r.timings and "null_chunk" in r.timings]
    return 1e3 * sum(per) / len(per) if per else None
