"""subject_p95_ms: 95th percentile over every subject analysis of the
window, each from its start to its synchronised result
(``harness.readers.p95_ms``)."""

from harness.readers import p95_ms


def read(run):
    return p95_ms(run, "subjects")
