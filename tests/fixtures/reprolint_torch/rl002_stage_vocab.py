"""Seeded RL002 violations: stage strings outside the port's STAGES."""


def instrument(tracer, tr, registry, dt):
    with tracer.span("kernel_launch"):  # seeded: RL002 (not a stage)
        pass
    tr.add("evaluate", dt)  # seeded: RL002 (not a stage)
    registry.observe("stage_latency_seconds", dt, stage="sync")  # seeded: RL002
    with tracer.span("eval"):  # allowed: in STAGES
        pass
    tr.add("null_chunk", dt)  # allowed: in STAGES
