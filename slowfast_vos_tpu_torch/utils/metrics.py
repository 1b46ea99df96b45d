"""Scalar metrics logging.

The port's copy of `slowfast_vos_tpu/utils/metrics.py`. The reference logs
batch/epoch losses and eval times to TensorBoard
(`code/train.py:82,103,109-111`) and deletes the log directory when it is
imported (`helpers/constants.py:14-15`). Here: an append-only JSON-lines
file (one object per scalar, tagged with step and wall time), plus an
optional TensorBoard event-file sink (`tensorboard=True`, which imports
`torch.utils.tensorboard` only then); a fresh run writes new files instead
of deleting history. `enabled=False` makes a logger that writes nothing
(the ranks other than 0 of a data-parallel run).
"""
from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str = "run", tensorboard: bool = False, enabled: bool = True):
        self.enabled = enabled
        self._tb = self._f = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.path = os.path.join(log_dir, f"{run_name}-{stamp}.jsonl")
        if tensorboard:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(log_dir, f"tb-{run_name}-{stamp}"))
        self._f = open(self.path, "a")

    def scalar(self, tag: str, value, step: int):
        if not self.enabled:
            return
        self._f.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step), "time": time.time()})
            + "\n"
        )
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def scalars(self, values: dict, step: int, prefix: str = ""):
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
