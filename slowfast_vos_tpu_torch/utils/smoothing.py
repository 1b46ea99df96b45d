"""Windowed metric smoothing and periodic progress logging.

The port's copy of `slowfast_vos_tpu/utils/smoothing.py`, the equivalent of
the vendored `SmoothedValue` / `MetricLogger.log_every`
(`code/maskrcnn/utils.py:13-76,149-236`). Cross-process reduction is a
`torch.distributed` all-reduce when a process group is initialized, and a
no-op otherwise.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque

import numpy as np
import torch


class SmoothedValue:
    """Track a series with a sliding window; report median/avg/global avg."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.window.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum (count, total) over the process group; a no-op without one.
        The window stays per process, as in the reference."""
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()):
            return
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor([self.count, self.total], dtype=torch.float64, device=device)
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self):
        return float(np.median(self.window)) if self.window else 0.0

    @property
    def avg(self):
        return float(np.mean(self.window)) if self.window else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return float(np.max(self.window)) if self.window else 0.0

    @property
    def value(self):
        return self.window[-1] if self.window else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class ProgressLogger:
    """`MetricLogger`-style: accumulate SmoothedValues, print every N steps
    with iteration timing and ETA."""

    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        if name in ("meters", "delimiter"):
            raise AttributeError(name)
        return self.meters[name]

    def __str__(self):
        return self.delimiter.join(f"{k}: {v}" for k, v in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        total = len(iterable) if hasattr(iterable, "__len__") else None
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = start
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i - 1)
                    print(f"{header} [{i}/{total}] eta: {eta:.0f}s {self} time: {iter_time}")
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}")
            end = time.time()
        print(f"{header} Total time: {time.time() - start:.1f}s")
