"""The device side of a traced run, from ``torch.profiler``.

Only device activity is recorded (kernels, copies, sets: no host ops, so
the trace costs the host little), over the last :data:`PROFILE_SECONDS`
of the window and its drain: the trace is read once the window has
closed, so its processing, which grows with the number of device ops,
stays out of the window and inside a run's time limit. The device clock
is tied to the host's ``perf_counter`` by a marker kernel launched right
after a synchronise where the trace starts. From the trace:

* busy seconds: the union of every device operation's interval in the
  window (kernels, copies, sets);
* the idle share: the part of the window in which no kernel ran (a copy
  keeps the copy engine busy, not the SMs);
* device seconds by operation name (kernels summed by name);
* gaps with no kernel running, each labelled by the innermost host span
  (the harness's own or the program's) that holds the gap's midpoint;
  queue waits (``batch_wait``) label nothing: they say what a request
  waited for, not what the host was doing.
"""

from __future__ import annotations

import collections
import dataclasses
import time

#: seconds at the end of the window that the device trace covers
PROFILE_SECONDS = 10.0


@dataclasses.dataclass
class DeviceTrace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_busy_s: float = 0.0
    by_name: dict = dataclasses.field(default_factory=dict)   # name -> (seconds, count)
    gaps: list = dataclasses.field(default_factory=list)      # (seconds, label), longest first
    events: int = 0
    read_s: float = 0.0
    start_s: float = 0.0

    @staticmethod
    def warm() -> None:
        """A throwaway trace of one kernel in set-up: the profiler's first
        start loads and initialises the tracing library, which takes
        seconds and must not fall into the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        t = time.perf_counter()
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        self.start_s = self._t0 - t
        torch.cuda._sleep(1000)          # the marker: the trace's first device op

    def stop(self, host_spans) -> "DeviceTrace":
        """End the trace once what was launched has run and read it (after
        the window): ``host_spans`` label its gaps."""
        import torch

        torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        self._prof.stop()
        events = _device_events(self._prof)
        self._prof = None
        self.read_s = time.perf_counter() - self._t1
        if not events:
            raise RuntimeError("the profiler recorded no device operation in the window")
        marker = next((e for e in events if "spin" in e[0]), events[0])
        dev0 = marker[1]
        self.window_s = self._t1 - self._t0
        dev1 = dev0 + self.window_s
        by_name = collections.defaultdict(lambda: [0.0, 0])
        intervals, kernels = [], []
        for name, s, e in events:
            if not dev0 <= s < dev1:
                continue
            # an op started in the window counts whole by name, and within
            # the window towards busy time
            by_name[name][0] += e - s
            by_name[name][1] += 1
            e = min(e, dev1)
            intervals.append((s, e))
            if not name.startswith(("Memcpy", "Memset")):
                kernels.append((s, e))
        self.by_name = {k: tuple(v) for k, v in by_name.items()}
        self.events = len(intervals)
        self.busy_s = sum(e - s for s, e in _merge(sorted(intervals)))
        merged = _merge(sorted(kernels))
        self.kernel_busy_s = sum(e - s for s, e in merged)
        edges = [dev0] + [x for iv in merged for x in iv] + [dev1]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        spans = sorted((sp for sp in host_spans if sp[0] != "batch_wait"),
                       key=lambda sp: sp[2] - sp[1])                # innermost first
        self.gaps = [(length, _label(spans, self._t0 + (start - dev0) + length / 2))
                     for length, start in gaps[:10]]
        return self

    @property
    def idle_share(self) -> float:
        """Share of the window in which no kernel ran."""
        return 1.0 - self.kernel_busy_s / self.window_s

    def seconds_of(self, names) -> float:
        """Device seconds of the operations whose names contain any of ``names``."""
        return sum(sec for op, (sec, _) in self.by_name.items() if any(n in op for n in names))

    def top_ops(self, n: int = 10) -> list:
        ops = sorted(self.by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:n]
        return [[op, sec] for op, (sec, _) in ops]


def _device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start s, end s) of every device operation, start order."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start = ev.start_ns() * 1e-9
        out.append((ev.name(), start, start + ev.duration_ns() * 1e-9))
    out.sort(key=lambda e: e[1])
    return out


def _merge(intervals):
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(spans, t: float) -> str:
    for name, s, e in spans:
        if s <= t <= e:
            return name
    return "between spans"
