"""Multi-process runs of the PyTorch port on the CPU, for the
`tests/test_torch_parallel_*.py` files.

`run_workers` starts N fresh interpreters as the ranks of a `gloo` process
group on 127.0.0.1 (RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT, as
`torchrun` sets them), each running the same script body after a prelude
that joins the group. The workers import torch, numpy and the port only
(this module too, which imports nothing else). Inputs and results travel as
`torch.save` files in the work directory. Each worker has its own timeout,
so a hang fails the test instead of eating the suite's time limit.

`tiny_pipeline` is the port's side of the driver tests' tiny set-up
(60x100 frames, min 64 / max 128, `TINY_CFG`, f32 on the CPU), which
`tests/torch_port_common.py` builds beside the JAX package.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import torch

from slowfast_vos_tpu_torch.models.config import DetectionConfig
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent

TINY_CFG = DetectionConfig(
    rpn_pre_nms_top_n_train=64,
    rpn_post_nms_top_n_train=32,
    rpn_pre_nms_top_n_test=64,
    rpn_post_nms_top_n_test=32,
    box_batch_size_per_image=32,
    mask_train_rois=8,
    detections_per_img=5,
    max_gt=3,
)
TINY_HW = (60, 100)


def tiny_pipeline(slow=1, fast=3, superchunk=4, use_slow_fast=True, device="cpu"):
    """(pipe, model): the port's f32 pipeline at the tiny set-up."""
    return build_pipeline(
        slow, fast, TINY_HW, min_size=64, max_size=128, cfg=TINY_CFG, dtype=torch.float32,
        device=device, use_slow_fast=use_slow_fast, superchunk=superchunk,
    )


PRELUDE = """
import os, sys
import torch
torch.set_num_threads(2)
from slowfast_vos_tpu_torch.parallel.distributed import get_rank, get_world_size, init_distributed_mode
assert init_distributed_mode(backend="gloo", verbose=False)
RANK = get_rank()
WORK = os.environ["WORK_DIR"]
"""

EPILOGUE = """
torch.distributed.destroy_process_group()
print(f"WORKER_OK rank={RANK}", force=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(body: str, work_dir: Path, n: int = 2, timeout: float = 240.0, env: dict | None = None) -> list[str]:
    """Run `body` (Python source, dedented) on `n` ranks of a gloo group.
    Fails, killing every worker, when one exits non-zero, does not print
    its WORKER_OK line, or outlives `timeout` seconds. Returns the
    workers' outputs."""
    work_dir = Path(work_dir)
    script = work_dir / "worker.py"
    script.write_text(PRELUDE + textwrap.dedent(body) + EPILOGUE)
    port = free_port()
    procs, logs = [], []
    for rank in range(n):
        worker_env = dict(os.environ)
        worker_env.update({
            "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(n),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORK_DIR": str(work_dir),
            "PYTHONPATH": os.pathsep.join([str(REPO), str(TESTS), worker_env.get("PYTHONPATH", "")]),
            **(env or {}),
        })
        logs.append(work_dir / f"rank{rank}.log")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(script)], env=worker_env, cwd=str(work_dir),
                stdout=log, stderr=subprocess.STDOUT,
            ))
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {rank} did not finish in {timeout} s") from None
            out = logs[rank].read_text()
            outs.append(out)
            assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
            assert f"WORKER_OK rank={rank}" in out, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def tiny_build(slow, fast, original_hw, *, device, dtype=None, use_slow_fast=True):
    """`slowfast_vos_tpu_torch.cli.build` at the tiny set-up (f32,
    superchunk 4), for CLIs driven in a worker."""
    assert tuple(original_hw) == TINY_HW
    return tiny_pipeline(slow, fast, use_slow_fast=use_slow_fast, device=device)
