#!/usr/bin/env python3
"""Where the time of one training step goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_train.py

Builds chip_smoke.py's training set-up (DAVIS 480x854, SlowFast 3-3, bf16,
default DetectionConfig, seeded random weights, one seeded window of moving
blobs), takes two warm-up steps, then

1. runs steps with every stage of the loss, the backward and the optimizer
   step wrapped in a synchronize at both ends, timed on the host clock
   (median over the runs);
2. runs one more step, unwrapped, under `torch.profiler`: the device's busy
   and idle share of the step and the kernels with the most device time.

Prints the card's name and power limit and one JSON line. Needs CUDA.
"""
import argparse
import collections
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

from torch_profile_pipeline import TimedTransform, device_profile, timed  # noqa: E402

from slowfast_vos_tpu_torch import data  # noqa: E402
from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod  # noqa: E402
from slowfast_vos_tpu_torch.train import Trainer  # noqa: E402
from slowfast_vos_tpu_torch.train import train_step as train_step_mod  # noqa: E402

STAGE_FUNCS = ("filter_proposals", "rpn_loss", "select_training_samples", "multiscale_roi_align",
               "fastrcnn_loss", "project_masks_on_boxes", "maskrcnn_loss")
MODEL_METHODS = ("backbone_feats", "rpn_predict", "enhance", "box_predict", "mask_predict")
RUNS, TOP = 3, 20


def training_window():
    """chip_smoke.py's window: the second of a seeded 8-frame sequence."""
    images, ids = data.draw_sequence(np.random.default_rng(7), 8, 480, 854, 2)
    return list(data.train_windows(data.sequence_arrays(images, ids, 8), fast=3))[1]


def one_step(trainer, batch, totals=None):
    """`Trainer.step` with its loss, backward and optimizer step apart."""
    clock = timed if totals is not None else (lambda name, fn, _: fn)
    draws = trainer.make_draws(int(batch["boxes"].shape[1]))
    trainer.model.train()
    try:
        total, _ = clock("loss", trainer.loss, totals)(batch, draws)
        clock("backward", total.backward, totals)()
    finally:
        trainer.model.eval()
    clock("optimizer", trainer.optimizer.step, totals)()
    trainer.optimizer.zero_grad(set_to_none=True)


def stage_times(trainer, batch, runs: int) -> dict:
    """Median over `runs` of each stage's seconds in one step. `loss` holds
    the loss's stages, so the table subtracts them from it."""
    saved = {n: getattr(train_step_mod, n) for n in STAGE_FUNCS}
    model = trainer.model
    per_run = []
    try:
        for _ in range(runs):
            totals = collections.Counter()
            for n, fn in saved.items():
                setattr(train_step_mod, n, timed(n, fn, totals))
            for n in MODEL_METHODS:
                setattr(model, n, timed(n, getattr(type(model), n).__get__(model), totals))
            transform, trainer.pipe.transform = trainer.pipe.transform, TimedTransform(trainer.pipe.transform, totals)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_step(trainer, batch, totals)
            torch.cuda.synchronize()
            totals["total"] = time.perf_counter() - t0
            trainer.pipe.transform = transform
            for n in MODEL_METHODS:
                delattr(model, n)
            inner = sum(v for k, v in totals.items() if k not in ("total", "loss", "backward", "optimizer"))
            totals["loss other"] = totals.pop("loss") - inner
            totals["other"] = totals["total"] - sum(v for k, v in totals.items() if k != "total")
            per_run.append(totals)
    finally:
        for n, fn in saved.items():
            setattr(train_step_mod, n, fn)
    return {k: float(np.median([r[k] for r in per_run])) for k in per_run[0]}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_train: CUDA is not available", file=sys.stderr)
        return 1
    pipe, model = pipeline_mod.build_pipeline(3, 3, (480, 854), dtype=torch.bfloat16, device="cuda", superchunk=8)
    pipeline_mod.init_weights(model, seed=0)
    trainer = Trainer(pipe, seed=0)
    batch = training_window()
    for _ in range(2):  # warm-up: kernel build, cuDNN algorithm choice
        one_step(trainer, batch)
    stages = stage_times(trainer, batch, RUNS)
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"stage {k:24s} {v * 1e3:9.2f} ms  {v / stages['total']:6.1%}")
    prof = device_profile(lambda: one_step(trainer, batch), TOP)
    print(f"device busy {prof.get('busy_share')}")
    for k in prof.get("top_kernels", []):
        print(f"kernel {k['ms']:9.3f} ms {k['share']:6.1%} x{k['calls']:<5d} {k['name']}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "stages_ms": {k: v * 1e3 for k, v in stages.items()},
                      "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
