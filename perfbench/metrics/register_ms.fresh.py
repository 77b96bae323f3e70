"""register_ms.fresh: the benchmark's own span around
``AsyncEngineServer.register`` (device copy and host fingerprint), mean
over the window's requests."""


def read(run):
    per = [r.extra["register_s"] for r in run.done() if "register_s" in r.extra]
    return 1e3 * sum(per) / len(per) if per else None
