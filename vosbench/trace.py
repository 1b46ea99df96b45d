"""Host spans and the device trace, and the arithmetic that reduces them.

`Spans` records the benchmark's own spans around its calls into the
program, by the host clock, in every run; in a traced run each span is also
a `torch.profiler.record_function` range, so that the device trace knows
what the host was doing. `DeviceTrace` runs `torch.profiler` (CUDA activity
through CUPTI) over a segment of work before the window and reduces its device operations:
the busy union, the time and count of each kernel by name, and the idle
gaps labelled by the innermost benchmark span open at their middle.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def idle_gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The gaps in [start, end] that no interval covers."""
    gaps, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [(s, e) for s, e in gaps if e > s]


def label_gaps(gaps, spans, default: str = "none") -> dict[str, float]:
    """Idle seconds by the label of the innermost span (the latest to start
    among those open) at each gap's middle."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out = collections.Counter()
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label = default
        for name, a, b in reversed(spans[: bisect.bisect_right(starts, mid)]):
            if b >= mid:
                label = name
                break
        out[label] += e - s
    return dict(out)


class Spans:
    """Named host spans: their total seconds by name, and, where `profiled`,
    profiler ranges of the same names."""

    def __init__(self):
        self.total = collections.Counter()
        self.profiled = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.profiled:
            import torch

            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.total[name] += time.perf_counter() - t0


class DeviceTrace:
    """`torch.profiler` over a traced segment of work: `start()`, `stop()`,
    then `reduce()`. `stop()` hands the spans on empty, so that the window
    after the segment has its own."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.window = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.spans.profiled = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window = time.perf_counter() - self._t0
        self.spans.profiled = False
        self.names = set(self.spans.total)
        self.spans.total.clear()
        self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """Busy and window seconds, kernels, seconds and calls by name, and
        idle seconds by host span; device times in seconds."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        named = self.names
        # The spans' own ranges also appear on the device's timeline
        # (annotations, not operations): left out by name.
        device = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in events
                  if e.device_type == DeviceType.CUDA and e.name not in named]
        host = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in events
                if e.device_type == DeviceType.CPU and e.name in named]
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for name, s, e in device:
            by_name[name][0] += e - s
            by_name[name][1] += 1
        intervals = [(s, e) for _, s, e in device]
        out = {"window_s": self.window, "busy_s": union_length(intervals), "kernels": len(device),
               "by_name": dict(by_name), "idle": {}}
        if host:
            start = min(s for _, s, _ in host)
            end = max(e for _, _, e in host)
            out["idle"] = label_gaps(idle_gaps(intervals, start, end), host)
        return out
