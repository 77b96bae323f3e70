"""device_idle.perm: share of the permutation cell's traced window in which
no kernel ran on the device (``harness.readers.device_idle``)."""

from harness.readers import device_idle as read  # noqa: F401
