"""Profiling helpers.

The port's copy of `slowfast_vos_tpu/utils/profiling.py`: a stage timer,
and a `torch.profiler` trace in place of the JAX package's `xla_trace`.
Where the JAX timer blocks on a stage's results, this one synchronizes the
CUDA devices that hold them; results on the CPU are ready when returned.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


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
    """Accumulate wall time per named stage, waiting for device results."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.time()
        yield
        if result is not None:
            _wait(result)
        self.totals[name] += time.time() - t0
        self.counts[name] += 1

    def time(self, name: str, fn, *args, **kwargs):
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
