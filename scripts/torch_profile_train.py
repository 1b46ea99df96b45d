#!/usr/bin/env python3
"""Where the time of one training step goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_train.py

Builds chip_smoke.py's training set-up (DAVIS 480x854, SlowFast 3-3, bf16,
default DetectionConfig, seeded random weights, one seeded window of moving
blobs) and one `Trainer` on the card's default path, CUDA graphs
(`train/graphs.py`), takes two warm-up steps on each path, then

1. runs graph steps with the port's tracer on (`utils/profiling.py::
   TRACER`; the first step captures the graphs anew with their stage
   marks): the gradient and update graphs' device milliseconds by stage a
   replay, read from the timing events the graphs record, and the host
   spans' seconds a step;
2. runs one more step of each path, unwrapped, under `torch.profiler`: its
   wall, the device's busy and idle share of it, the kernels with the
   most device time, and the device time of K6's kernels (train-mode
   BatchNorm, `csrc/batch_norm.cu`) beside PyTorch's generic elementwise
   and reduction kernels, which is what is left of the BN's plain path
   and of everything else such kernels compute;
3. times whole steps of both paths in turns (eager, graphs, graphs, eager,
   ...), synchronized around each step: the median of each; then each
   path's peak allocated device memory over one step.

Prints the card's name and power limit and one JSON line. Needs CUDA.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_profile_pipeline import device_profile, print_split, tracer_split  # noqa: E402

from slowfast_vos_tpu_torch import data  # noqa: E402
from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod  # noqa: E402
from slowfast_vos_tpu_torch.train import Trainer  # noqa: E402

RUNS, TOP, TURNS = 3, 20, 10
# Kernels by name, in order of precedence: K6's own first (one kernel a call
# each way).
KERNEL_GROUPS = {
    "K6 forward": ("bn_forward_kernel",),
    "K6 backward": ("bn_backward_kernel",),
    "generic elementwise": ("elementwise_kernel",),
    "generic reduction": ("reduce_kernel",),
}


def training_window():
    """chip_smoke.py's window: the second of a seeded 8-frame sequence."""
    images, ids = data.draw_sequence(np.random.default_rng(7), 8, 480, 854, 2)
    return list(data.train_windows(data.sequence_arrays(images, ids, 8), fast=3))[1]


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_train: CUDA is not available", file=sys.stderr)
        return 1
    pipe, model = pipeline_mod.build_pipeline(3, 3, (480, 854), dtype=torch.bfloat16, device="cuda", superchunk=8)
    pipeline_mod.init_weights(model, seed=0)
    trainer = Trainer(pipe, seed=0)
    runner = trainer.graphs

    def eager_step():
        trainer.graphs = None  # the eager path of the same trainer
        try:
            trainer.step(batch)
        finally:
            trainer.graphs = runner

    paths = {"eager": eager_step, "graphs": lambda: trainer.step(batch)}
    batch = training_window()
    for _ in range(2):  # warm-up: kernel build, cuDNN algorithm choice, the captures
        for step in paths.values():
            step()
    split = tracer_split(paths["graphs"], RUNS)
    print_split(split)
    profiles = {}
    for name, step in paths.items():
        profiles[name] = prof = device_profile(step, TOP, KERNEL_GROUPS)
        print(f"{name}: wall {prof.get('wall_ms')} ms, device busy {prof.get('device_busy_ms')} ms, "
              f"busy share {prof.get('busy_share')}, {prof.get('kernel_launches')} device kernels")
        for k in prof.get("top_kernels", []):
            print(f"  kernel {k['ms']:9.3f} ms {k['share']:6.1%} x{k['calls']:<5d} {k['name']}")
        for g, v in prof.get("groups", {}).items():
            print(f"  group {v['ms']:9.3f} ms x{v['calls']:<5d} {g}")
    turns = {name: [] for name in paths}
    for i in range(TURNS):
        for name in (paths if i % 2 == 0 else reversed(paths)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths[name]()
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) * 1e3)
    step_ms = {name: float(np.median(v)) for name, v in turns.items()}
    print("whole steps in turns, median ms: " + ", ".join(f"{k} {v:.2f}" for k, v in step_ms.items()))
    peak_gib = {}
    for name, step in paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak_gib[name] = torch.cuda.max_memory_allocated() / 2**30
    print("peak allocated device memory over one step, GiB: " + ", ".join(f"{k} {v:.3f}" for k, v in peak_gib.items()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "tracer": split,
                      "profiles": profiles, "step_ms": step_ms, "step_ms_runs": turns, "peak_gib": peak_gib,
                      "capture_s": {"gradient": [g.capture_s for g in runner.graphs.values()],
                                    "update": runner.update.capture_s}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
