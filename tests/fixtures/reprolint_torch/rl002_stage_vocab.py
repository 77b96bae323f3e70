"""Seeded RL002 violations: stage strings outside the port's STAGES."""


def instrument(tracer, tr, registry, dt):
    with tracer.span("kernel_launch"):  # seeded: RL002 (not a stage)
        pass
    tr.add("evaluate", dt)  # seeded: RL002 (not a stage)
    registry.observe("stage_latency_seconds", dt, stage="sync")  # seeded: RL002
    with tracer.span("eval"):  # allowed: in STAGES
        pass
    tr.add("null_chunk", dt)  # allowed: in STAGES
    with span("draw"), span("grid_point"):  # allowed: port-only stages (core's bare hook)
        pass
    with tracer.span("hat_matrix"), tracer.span("fold_factors"):  # allowed: port-only stages
        pass
    tr.add("fingerprint", dt)  # allowed: a port-only stage
    registry.observe("stage_latency_seconds", dt, stage="gather")  # allowed: port-only
    with tracer.shared("eval", [tr], "cpu"):  # allowed: in STAGES
        pass
    with tracer.shared("kernel_launch", [tr], "cpu"):  # seeded: RL002 (not a stage)
        pass
    with span("warp_speed"):  # seeded: RL002 (core's bare hook, not a stage)
        pass
