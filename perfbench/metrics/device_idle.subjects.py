"""device_idle.subjects: share of a subject cell's traced window in which
no kernel ran on the device (``harness.readers.device_idle``)."""

from harness.readers import device_idle as read  # noqa: F401
