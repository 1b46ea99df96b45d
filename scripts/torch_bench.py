#!/usr/bin/env python3
"""Benchmark of the PyTorch port: clip-batched SlowFast Mask R-CNN inference
throughput on one NVIDIA GPU (the port's `bench.py`).

Metric: frames/s of the full VOS inference pipeline (`Pipeline.infer_sequence`:
transform -> frozen backbone -> RPN -> whole-clip SlowFast fusion -> RoI
heads -> mask paste at original resolution) on DAVIS-resolution (480x854)
clips, default 3-3 configuration with `detections_per_img=10`, bf16, seeded
random weights: the per-frame work of the reference's evaluation loop
(`code/helpers/davis_evaluate.py:29-44`). Host clock around each call of a
64-frame clip (the call returns its detections on the host); `value` is the
best of `--runs`, `median` and `runs` beside it.

`vs_baseline`: the reference reports full DAVIS-2016 val evaluation wall
times (1376 frames) per configuration on its GPU (`BASELINE.md`,
Experiments.tex; 544 s for 3-3, ~2.53 frames/s); `vs_baseline` is our
frames/s over the reference's.

`device_fps`: every superchunk's window uploaded to the card first, the
timed loop runs only the superchunks and ends in one synchronize.
`graphs`: both numbers are taken on the pipeline's default path on the card,
one CUDA graph replay per superchunk (`models/graphs.py`); the record says
which path ran, so no eager number is read as a graph one.
`--train` runs on the trainer's default path on the card too, one CUDA
graph replay per half of a step (`train/graphs.py`), and its record says
so in `graphs`.
`device_mfu`: the model's analytic FLOPs per frame times `device_median`
over the H100 SXM's dense bf16 tensor-core peak.

Prints one JSON line per configuration (re-printed with the device
columns), with the card's name and power limit as nvidia-smi gives them.
`--train` prints one line of training throughput instead. Needs CUDA: it
exits non-zero on a host without it.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Full-val DAVIS-2016 eval wall times per config (1376 frames), reference
# GPU (`final_report/chapters/Experiments.tex:20-24`).
REFERENCE_WALL_S = {"1-1": 477.0, "3-3": 544.0, "7-7": 853.0, "1-7": 528.0, "3-7": 584.0}
CONFIGS = [(1, 1), (3, 3), (7, 7), (1, 7), (3, 7)]

# Dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet, 700 W).
H100_SXM_BF16_FLOPS = 989e12

# Model FLOPs per frame: analytic required FLOPs of backbone + FPN + RPN +
# enhance + heads at the 768x1344 canvas (`scripts/profile_flops.py`, which
# counts the model, not a device); implementation overheads are left out,
# so they lower `device_mfu`.
FLOPS_PER_FRAME = {
    "1-1": 675.3e9,
    "3-3": 842.7e9,
    "7-7": 1187.0e9,
    "1-7": 709.0e9,
    "3-7": 872.2e9,
}
HW = (480, 854)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _pipeline(slow: int, fast: int):
    from slowfast_vos_tpu_torch.models.pipeline import build_pipeline, init_weights

    pipe, model = build_pipeline(slow=slow, fast=fast, original_hw=HW)
    init_weights(model, seed=0)
    return pipe


def device_fps(pipe, clip: np.ndarray, runs: int):
    """(best, median) frames/s with every superchunk's window on the card
    before the clock starts; one synchronize (the
    scores' sum) per run."""
    import torch

    t = clip.shape[0]
    use_carry = pipe.sf.fast > 1
    prepared = [
        pipe.chunk_inputs(clip, c, c > 0 and use_carry) for c in range(0, t, pipe.superchunk)
    ]

    @torch.inference_mode()
    def run_once() -> float:
        carry, total = None, 0.0
        for images, valid in prepared:
            outs, next_carry = pipe._run(images, valid, carry)
            carry = next_carry if use_carry else None
            total = total + outs[1].float().sum()  # scores: depend on the whole chunk
        return float(total)

    run_once()
    fps = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run_once()
        fps.append(t / (time.perf_counter() - t0))
    return max(fps), float(np.median(fps))


def bench_config(slow: int, fast: int, *, runs: int, device_name: str) -> dict:
    pipe = _pipeline(slow, fast)
    clip = np.random.default_rng(63).integers(0, 255, (64, *HW, 3), dtype=np.uint8)
    pipe.infer_sequence(clip)  # warm-up: every superchunk shape of the timed clip

    fps_runs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        dets = pipe.infer_sequence(clip)
        dt = time.perf_counter() - t0
        assert len(dets) == clip.shape[0]
        fps_runs.append(clip.shape[0] / dt)

    config = f"{slow}-{fast}"
    ref_fps = 1376.0 / REFERENCE_WALL_S[config]
    fps = max(fps_runs)
    record = {
        "metric": "inference_frames_per_sec_per_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / ref_fps, 3),
        "median": round(float(np.median(fps_runs)), 3),
        "runs": [round(f, 3) for f in fps_runs],
        "config": config,
        "superchunk": pipe.superchunk,
        "graphs": pipe.graphs is not None,
        "card": device_name,
    }
    # Printed before the device columns, so a failure there still leaves a record.
    print(json.dumps(record), flush=True)
    dev_best, dev_median = device_fps(pipe, clip, runs)
    record["device_fps"] = round(dev_best, 3)
    record["device_median"] = round(dev_median, 3)
    record["device_mfu"] = round(FLOPS_PER_FRAME[config] * dev_median / H100_SXM_BF16_FLOPS, 4)
    print(json.dumps(record), flush=True)
    return record


def bench_train(slow: int, fast: int, device_name: str, steps: int = 8) -> dict:
    """Training throughput of the unsupervised step: one window of 2 centre
    frames + the halo of moving blobs (`data.train_windows`), 480x854, bf16,
    default DetectionConfig; one warm-up step, then `steps` steps with one
    synchronize at the end."""
    import torch

    from slowfast_vos_tpu_torch import data
    from slowfast_vos_tpu_torch.train import Trainer

    pipe = _pipeline(slow, fast)
    trainer = Trainer(pipe, lr=1e-3)
    images, ids = data.draw_sequence(np.random.default_rng(63), 8, *HW, 2)
    seq = data.sequence_arrays(images, ids, pipe.cfg.max_gt)
    batch = list(data.train_windows(seq, fast=pipe.sf.fast, n_center=trainer.n_center))[1]
    trainer.step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.step(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    record = {
        "metric": "train_frames_per_sec_per_chip",
        "value": round(trainer.n_center / dt, 3),
        "unit": "frames/s",
        "step_ms": round(dt * 1e3, 2),
        "config": f"{slow}-{fast}",
        "graphs": trainer.graphs is not None,
        "card": device_name,
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--slow", type=int, default=3)
    ap.add_argument("--fast", type=int, default=3)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--all-configs", action="store_true",
                    help="bench every published config (1-1/3-3/7-7/1-7/3-7), one JSON line each")
    ap.add_argument("--train", action="store_true", help="training throughput of one step instead")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench: CUDA is not available; the benchmark runs only on an NVIDIA GPU")
    device_name = card()
    if args.train:
        return [bench_train(args.slow, args.fast, device_name)]
    configs = CONFIGS if args.all_configs else [(args.slow, args.fast)]
    return [bench_config(s, f, runs=args.runs, device_name=device_name) for s, f in configs]


if __name__ == "__main__":
    main()
