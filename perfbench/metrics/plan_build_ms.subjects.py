"""plan_build_ms.subjects: the program's ``plan_build`` spans of a subject
request, summed over its workloads, mean over the requests that built one."""


def read(run):
    per = [r.timings["plan_build"] for r in run.done()
           if r.units.get("subjects") and r.timings and "plan_build" in r.timings]
    return 1e3 * sum(per) / len(per) if per else None
