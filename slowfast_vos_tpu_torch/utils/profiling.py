"""Profiling: the port's tracer, a stage timer and a `torch.profiler` trace.

`TRACER` is the port's one tracer. It is off by default; `TRACER.enable()`
switches it on and `TRACER.disable()` off. The port's layer boundaries
call it:

* `TRACER.span(name)` around a layer's work: each span records its name,
  its start and end (`time.perf_counter_ns`), its thread, its parent (the
  enclosing span on the same thread) and the id of its unit of work. A
  span opened with `unit=True` (one `infer_sequence` call, one training
  step, one decoded sequence) starts a new unit; the spans its thread opens
  after it, inside it or not, share its id until the thread starts
  another. While a `torch.profiler` is active a span is also a
  `record_function` range of the same name, so that the device trace knows
  what the host was doing.
* `TRACER.count(name, n)` at the same boundaries: counts by name.
* `TRACER.mark(stage)` between the device stages of a superchunk or a
  training step. A mark records a timing event
  (`torch.cuda.Event(enable_timing=True, external=True)`) on the current
  stream, and only while the runner of `models/graphs.py` or
  `train/graphs.py` captures a graph with the tracer on
  (`TRACER.recording`): the capture records the events as graph nodes, so
  every replay records them again. Before the graph's next replay, and at
  `take()`, the runner's `StageClock` asks whether the last replay has
  finished (`query()`, no synchronize); if it has, the times between its
  events are added to the stage totals of the graph's label, and if not,
  that replay goes unread. The graph keys hold the tracer's state at
  capture, so a graph with marks is never replayed untraced and one
  without never runs traced.

When the tracer is off, a span costs one flag test and returns a shared
no-op context, and a count or a mark does nothing. Spans stay in memory, the
newest `capacity` of them; totals by name (calls, seconds, self seconds:
the duration less what the span's children cover) count every span.
`take()` returns what was recorded since the last `take()` (or
`enable()`), and clears it: spans, totals, counters, stage times, the spans
still open, and `ops/cuda_build.py::launches` as it reads now.

`StageTimer` is the port's copy of `slowfast_vos_tpu/utils/profiling.py`'s
timer, whose stages are tracer spans too. Where the JAX timer blocks on a
stage's results, this one synchronizes the CUDA devices that hold them;
results on the CPU are ready when returned.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch
import torch.autograd.profiler as autograd_profiler

_NOOP = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int  # `threading.get_ident()` of the thread that ran it
    parent: int | None  # id of the enclosing span on the same thread
    unit: int  # id of the unit of work (0: before any unit on the thread)


class _Span:
    """One span being timed: the context `Tracer.span` returns when on."""

    __slots__ = ("tracer", "name", "unit_root", "id", "parent", "unit", "start", "child_ns", "range", "local")

    def __init__(self, tracer: "Tracer", name: str, unit_root: bool):
        self.tracer, self.name, self.unit_root = tracer, name, unit_root

    def __enter__(self):
        tr = self.tracer
        self.local = local = tr._thread_local()
        self.id = next(tr._ids)
        self.parent = local.stack[-1].id if local.stack else None
        if self.unit_root:
            local.unit = next(tr._units)
        self.unit = local.unit
        self.child_ns = 0
        self.range = None
        if autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = tr._clock()
        local.stack.append(self)  # started first: `take()` may read it from another thread
        return self

    def __exit__(self, *exc_info):
        tr = self.tracer
        end = tr._clock()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        stack = self.local.stack
        stack.pop()
        duration = end - self.start
        if stack:
            stack[-1].child_ns += duration
        tr._close(SpanRecord(self.id, self.name, self.start, end, threading.get_ident(), self.parent, self.unit),
                  duration - self.child_ns)
        return False


class StageClock:
    """The timing events of one captured graph's stage marks, and whether a
    replay's events wait to be read. `label` names the graph in the stage
    totals; the first event is the capture's start."""

    def __init__(self, tracer: "Tracer", label: str):
        self.tracer, self.label = tracer, label
        self.events: list[tuple[str, torch.cuda.Event]] = []
        self.pending = False

    def mark(self, stage: str) -> None:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self.events.append((stage, event))

    def replayed(self) -> None:
        """After a replay: its events wait to be read."""
        self.pending = True
        self.tracer._replayed(self)

    def read(self) -> None:
        """Add the last replay's stage times to the totals if it has
        finished (no synchronize), else count it unread."""
        if not self.pending:
            return
        self.pending = False
        if not self.events[-1][1].query():
            self.tracer._read(self, None)
            return
        times = [(stage, start.elapsed_time(end)) for (_, start), (stage, end) in zip(self.events, self.events[1:])]
        self.tracer._read(self, times)


class Tracer:
    """Spans, counters and device stage times of the port (module docstring).
    `clock` is for tests; `capacity` bounds the spans kept."""

    def __init__(self, clock=time.perf_counter_ns, capacity: int = 1 << 16):
        self.on = False
        self._clock = clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._units = itertools.count(1)
        self._stacks: dict[int, tuple[threading.Thread, list]] = {}
        self._records: collections.deque = collections.deque(maxlen=capacity)
        self._clear()

    def _clear(self) -> None:
        self._t0 = self._clock()
        self._records.clear()
        self._dropped = 0
        self._totals: dict[str, list] = {}  # name -> [calls, ns, self ns]
        self._counters: collections.Counter = collections.Counter()
        self._stages: dict[str, dict] = {}
        self._pending: set = set()

    def enable(self) -> None:
        """Switch the tracer on, from empty."""
        with self._lock:
            self._clear()
        self.on = True

    def disable(self) -> None:
        """Switch the tracer off; what it holds waits for `take()`."""
        self.on = False

    # -- spans and counters ------------------------------------------------

    def span(self, name: str, unit: bool = False):
        """A context that times the block as span `name`; `unit=True` starts
        a unit of work. A shared no-op context when the tracer is off."""
        if not self.on:
            return _NOOP
        return _Span(self, name, unit)

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            with self._lock:
                self._counters[name] += n

    def _thread_local(self):
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.unit = [], 0
            with self._lock:
                self._stacks[threading.get_ident()] = (threading.current_thread(), local.stack)
        return local

    def _close(self, record: SpanRecord, self_ns: int) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self._dropped += 1
            self._records.append(record)
            total = self._totals.setdefault(record.name, [0, 0, 0])
            total[0] += 1
            total[1] += record.end_ns - record.start_ns
            total[2] += self_ns

    # -- device stage marks --------------------------------------------------

    def stage_clock(self, label: str) -> StageClock | None:
        """A clock for a graph about to be captured, or None when off."""
        return StageClock(self, label) if self.on else None

    @contextlib.contextmanager
    def recording(self, clock: StageClock | None):
        """While the block captures a graph, this thread's marks record
        events into `clock` (None: no marks), after a start event."""
        if clock is None:
            yield
            return
        self._local.clock = clock
        try:
            clock.mark("")
            yield
        finally:
            self._local.clock = None

    def mark(self, stage: str) -> None:
        """End of device stage `stage` in the graph being captured."""
        if self.on:
            clock = getattr(self._local, "clock", None)
            if clock is not None:
                clock.mark(stage)

    def _stage_totals(self, label: str) -> dict:
        return self._stages.setdefault(label, {"replays": 0, "samples": 0, "unread": 0, "ms": {}})

    def _replayed(self, clock: StageClock) -> None:
        with self._lock:
            self._stage_totals(clock.label)["replays"] += 1
            self._pending.add(clock)

    def _read(self, clock: StageClock, times) -> None:
        with self._lock:
            self._pending.discard(clock)
            totals = self._stage_totals(clock.label)
            if times is None:
                totals["unread"] += 1
                return
            totals["samples"] += 1
            for stage, ms in times:
                totals["ms"][stage] = totals["ms"].get(stage, 0.0) + ms

    # -- snapshot -------------------------------------------------------------

    def take(self) -> dict:
        """What was recorded since the last `take()` or `enable()`, then
        cleared. Replays whose events have finished are read first; the
        others count as unread. Times in seconds, stage times in ms:

        * `t0_ns`, `t1_ns`: the interval the snapshot covers;
        * `spans`: `SpanRecord`s as dicts, oldest first (`dropped`: how many
          fell out of the buffer); `open`: spans still open, as dicts with
          their name, start, thread and id;
        * `totals`: by span name, `calls`, `total_s`, `self_s`;
        * `counters`: by name; `launches`: `cuda_build.launches`, as it reads;
        * `stages`: by graph label, `replays`, `samples` (replays read),
          `unread`, and `ms`, each stage's milliseconds summed over the
          samples;
        * `main_thread`: the main thread's id."""
        from slowfast_vos_tpu_torch.ops import cuda_build

        with self._lock:
            pending = list(self._pending)
        for clock in pending:
            clock.read()
        now = self._clock()
        with self._lock:
            alive = {}
            for ident, (thread, stack) in self._stacks.items():
                if stack or thread.is_alive():
                    alive[ident] = (thread, stack)
            self._stacks = alive
            snapshot = {
                "t0_ns": self._t0, "t1_ns": now, "main_thread": threading.main_thread().ident,
                "spans": [r._asdict() for r in self._records], "dropped": self._dropped,
                "open": [{"name": s.name, "start_ns": s.start, "thread": ident, "id": s.id}
                         for ident, (_, stack) in alive.items() for s in list(stack)],
                "totals": {k: {"calls": c, "total_s": ns * 1e-9, "self_s": self_ns * 1e-9}
                           for k, (c, ns, self_ns) in self._totals.items()},
                "counters": dict(self._counters),
                "launches": {str(k): v for k, v in cuda_build.launches.items()},
                "stages": {k: {**v, "ms": dict(v["ms"])} for k, v in self._stages.items()},
            }
            self._clear()
            self._t0 = now
        return snapshot


TRACER = Tracer()


def _wait(result) -> None:
    """Synchronize every CUDA device that holds a tensor of `result` (a
    tensor, or lists, tuples and dicts of them)."""
    stack, devices = [result], set()
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulate wall time per named stage, waiting for device results.
    Each stage is also a span of `TRACER`."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        with TRACER.span(name):
            t0 = time.time()
            yield
            if result is not None:
                _wait(result)
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def time(self, name: str, fn, *args, **kwargs):
        with TRACER.span(name):
            t0 = time.time()
            out = fn(*args, **kwargs)
            _wait(out)
            self.totals[name] += time.time() - t0
            self.counts[name] += 1
        return out

    def summary(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }

    def report(self):
        for k, v in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            print(f"{k:30s} {v['total_s']:8.3f}s  ({v['calls']} calls, {v['mean_s']*1e3:.1f} ms/call)")


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Capture a `torch.profiler` trace of the block into `log_dir` (a
    Chrome trace, for Perfetto or TensorBoard), CUDA activity included where
    a card is present; the JAX package's `xla_trace`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof
