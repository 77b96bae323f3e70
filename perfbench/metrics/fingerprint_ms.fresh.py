"""fingerprint_ms.fresh: the program's ``fingerprint`` spans (the host copy
and digest of X that a registration makes), mean over the window's
registrations: sum over count of the engine's
``stage_latency_seconds{stage="fingerprint"}`` histogram. Tracing is
turned on after warm-up, so the histogram holds the window's
registrations alone; a program without the stage leaves it empty."""


def read(run):
    engine = (run.state or {}).get("engine")
    if engine is None or "stage_latency_seconds" not in engine.metrics:
        return None
    snap = engine.metrics.get("stage_latency_seconds").snapshot(stage="fingerprint")
    return 1e3 * snap["sum"] / snap["count"] if snap["count"] else None
