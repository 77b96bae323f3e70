"""Straggler detection and mitigation.

Two mechanisms, matched to the two workload families:

1. **Step-time monitor** (synchronous SPMD training): per-step wall times
   feed a robust EWMA; a step slower than ``threshold × median`` marks the
   step a straggler event. Mitigations at fleet scale are (a) flagging the
   slow pod for the scheduler, (b) micro-batch rebalancing away from it,
   (c) checkpoint-and-restart without it (elastic). Here the detector +
   policy decisions are implemented and unit-tested; the actuation is the
   cluster scheduler's job.

2. **Work-queue reassignment** (the paper's permutation testing, which is
   embarrassingly parallel over permutation slices): slices are leased to
   workers with deadlines; expired leases are re-queued, so a dead or slow
   pod only delays its own slice until another pod picks it up. Exactly
   the property that makes Algorithm 1/2 a great 1000-node workload
   (DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

__all__ = ["StepTimeMonitor", "SliceQueue"]


class StepTimeMonitor:
    """Rolling-median step-time straggler detector."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 warmup_steps: int = 3):
        self.window = window
        self.threshold = threshold
        self.warmup = warmup_steps
        self.times: deque[float] = deque(maxlen=window)
        self.events: list[dict] = []
        self._seen = 0

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self._seen += 1
        if self._seen <= self.warmup:           # compile/init steps
            return False
        flagged = False
        if len(self.times) >= 5:
            med = sorted(self.times)[len(self.times) // 2]
            if seconds > self.threshold * med:
                flagged = True
                self.events.append({"step": step, "seconds": seconds,
                                    "median": med})
        self.times.append(seconds)
        return flagged

    @property
    def median(self) -> Optional[float]:
        if not self.times:
            return None
        return sorted(self.times)[len(self.times) // 2]


@dataclasses.dataclass
class _Lease:
    slice_id: int
    worker: str
    deadline: float


class SliceQueue:
    """Deadline-leased work queue for permutation/searchlight slices."""

    def __init__(self, n_slices: int, lease_seconds: float = 60.0,
                 clock=time.monotonic):
        self.todo: deque[int] = deque(range(n_slices))
        self.lease_seconds = lease_seconds
        self.leases: dict[int, _Lease] = {}
        self.done: set[int] = set()
        self.reassignments: list[tuple[int, str]] = []
        self._clock = clock

    def acquire(self, worker: str) -> Optional[int]:
        self._expire()
        if not self.todo:
            return None
        s = self.todo.popleft()
        self.leases[s] = _Lease(s, worker, self._clock() + self.lease_seconds)
        return s

    def complete(self, slice_id: int, worker: str) -> bool:
        """False if the lease had already expired and been reassigned."""
        lease = self.leases.get(slice_id)
        if lease is None or lease.worker != worker:
            return slice_id in self.done   # late duplicate: idempotent
        del self.leases[slice_id]
        self.done.add(slice_id)
        return True

    def _expire(self):
        now = self._clock()
        for s, lease in list(self.leases.items()):
            if lease.deadline < now:
                del self.leases[s]
                if s not in self.done:
                    self.todo.append(s)
                    self.reassignments.append((s, lease.worker))

    @property
    def finished(self) -> bool:
        self._expire()
        return not self.todo and not self.leases
