"""Seeded RL004 violations: guarded attrs mutated outside their lock."""

import threading


class LaunchLedger:
    _GUARDED_BY = {"launches": "_lock", "_shapes": "_lock"}
    _LOCKED_HELPERS = ("_trim",)

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0  # allowed: __init__ is exempt
        self._shapes = []

    def record(self, shape):
        self.launches += 1  # seeded: RL004 (no lock)
        self._shapes.append(shape)  # seeded: RL004 (no lock)

    def record_locked(self, shape):
        with self._lock:
            self.launches += 1  # allowed
            self._shapes.append(shape)  # allowed
        self._shapes.clear()  # seeded: RL004 (after the with-block)

    def _trim(self):
        del self._shapes[:-8]  # allowed: declared lock-held helper
