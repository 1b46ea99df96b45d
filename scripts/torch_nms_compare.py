#!/usr/bin/env python3
"""The NMS kernel (K3) against the plain fixpoint, end to end, on one NVIDIA GPU.

    python3 scripts/torch_nms_compare.py [--runs 5]

Builds chip_smoke.py's phase 2 pipeline (DAVIS 480x854, SlowFast 3-3, bf16,
superchunk 8, seeded random weights, its 20-frame seeded clip) and phase 3's
trainer (default DetectionConfig, one seeded window), and times two NMS
paths in one process, in turns (plain, kernel, kernel, plain, `--runs`
rounds):

- "kernel": what every caller runs, `nms_mask(algorithm="auto")`, which
  launches K3 on the card;
- "plain": every NMS through `algorithm="fixpoint"`, the path the port took
  on the card before K3 (the same answer; a host synchronize per iteration).

Checks that both give the same detections bit for bit, then prints
`infer_sequence` frames/s and `Trainer.step` ms (synchronized around each
call; medians), the card's name and power limit, and one JSON line. Needs
CUDA.
"""
import argparse
import contextlib
import functools
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_profile_train import training_window  # noqa: E402

from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod  # noqa: E402
from slowfast_vos_tpu_torch.models import rpn  # noqa: E402
from slowfast_vos_tpu_torch.ops import nms  # noqa: E402
from slowfast_vos_tpu_torch.train import Trainer  # noqa: E402

FRAMES, SUPERCHUNK = 20, 8  # chip_smoke.py's main path


@contextlib.contextmanager
def nms_path(name: str):
    """Within the block, every NMS of the port takes the `name` path:
    "kernel" (as shipped) or "plain" (the fixpoint on the card)."""
    nms_mask = nms.nms_mask
    if name == "plain":
        rpn.nms_mask = nms.nms_mask = functools.partial(nms_mask, algorithm="fixpoint")
    try:
        yield
    finally:
        rpn.nms_mask = nms.nms_mask = nms_mask


def in_turns(fns: dict, runs: int) -> dict:
    """{path: [seconds of each call]}, the paths in turns (plain, kernel,
    kernel, plain, ...), synchronized around each call."""
    times = {name: [] for name in fns}
    for r in range(runs):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            with nms_path(name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[name]()
                torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5, help="rounds of each path (in turns)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_nms_compare: CUDA is not available", file=sys.stderr)
        return 1

    pipe, model = pipeline_mod.build_pipeline(3, 3, (480, 854), dtype=torch.bfloat16, device="cuda",
                                              superchunk=SUPERCHUNK)
    pipeline_mod.init_weights(model, seed=0)
    clip = np.random.default_rng(1).integers(0, 256, (FRAMES, 480, 854, 3), dtype=np.uint8)
    dets = {}
    for name in ("plain", "kernel"):  # warm-up, and the detections of each path
        with nms_path(name):
            dets[name] = pipe.infer_sequence(clip)
    same = all(sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
               for a, b in zip(dets["plain"], dets["kernel"]))
    print(f"detections of the two paths equal bit for bit: {same}")
    infer = in_turns({name: lambda: pipe.infer_sequence(clip) for name in ("plain", "kernel")}, args.runs)
    fps = {k: FRAMES / statistics.median(v) for k, v in infer.items()}
    for k, v in infer.items():
        print(f"infer_sequence {FRAMES} frames, superchunk {SUPERCHUNK}, {k}: "
              f"{', '.join(f'{t:.4f}' for t in v)} s -> {fps[k]:.2f} frames/s (median)")
    del pipe, model

    tpipe, tmodel = pipeline_mod.build_pipeline(3, 3, (480, 854), dtype=torch.bfloat16, device="cuda",
                                                superchunk=SUPERCHUNK)
    pipeline_mod.init_weights(tmodel, seed=0)
    trainer, batch = Trainer(tpipe, seed=0), training_window()
    for name in ("plain", "kernel"):
        with nms_path(name):
            trainer.step(batch)
    train = in_turns({name: lambda: trainer.step(batch) for name in ("plain", "kernel")}, args.runs)
    step_ms = {k: 1e3 * statistics.median(v) for k, v in train.items()}
    for k, v in train.items():
        print(f"Trainer.step, {k}: {', '.join(f'{1e3 * t:.2f}' for t in v)} ms -> {step_ms[k]:.2f} ms (median)")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "frames": FRAMES, "superchunk": SUPERCHUNK,
        "detections_equal": same, "infer_s": infer, "frames_per_s": fps, "step_s": train, "step_ms": step_ms,
    }))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
