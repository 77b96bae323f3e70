"""request_p95_ms.subjects: 95th percentile over every subject request of
the traced window, from the client's submit to its answer
(``harness.readers.p95_ms``)."""

from harness.readers import p95_ms


def read(run):
    return p95_ms(run, "subjects")
