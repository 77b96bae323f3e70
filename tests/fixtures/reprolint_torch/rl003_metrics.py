"""Seeded RL003 violations: undeclared names, label drift, cardinality."""


def instrument(metrics, w, device):
    metrics.inc("kernel_launches_total")  # seeded: RL003 (undeclared name)
    metrics.inc("requests_total", estimator=w.estimator)  # seeded: RL003 (missing label key)
    metrics.inc(
        "requests_total", kind=str(device), estimator=w.estimator
    )  # seeded: RL003 (unbounded label value)
    metrics.observe("requests_total", 2.0)  # seeded: RL003 (counter observed)
    metrics.gauge("plan_update_rank", "drifted")  # seeded: RL003 (histogram as a gauge)
    metrics.inc("requests_total", kind=w.kind, estimator=w.estimator)  # allowed
    metrics.observe("plan_update_rank", 4.0)  # allowed
