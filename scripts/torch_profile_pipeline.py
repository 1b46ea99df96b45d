#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main path, on one NVIDIA GPU.

    python3 scripts/torch_profile_pipeline.py

Builds the full-width pipeline (DAVIS 480x854, SlowFast 3-3, bf16, seeded
random weights), warms it up, then

1. runs `infer_sequence` with every stage wrapped in a synchronize at both
   ends and timed on the host clock (stages run back to back, so their
   times add up to the run's; the synchronizes remove any overlap between
   stages);
2. runs it once more, unwrapped, under `torch.profiler`: the device's busy
   and idle share of the run and the kernels with the most device time.

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

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod  # noqa: E402

STAGE_FUNCS = ("filter_proposals", "multiscale_roi_align", "postprocess_detections", "paste_masks_in_image", "packbits")
MODEL_METHODS = ("backbone_feats", "rpn_predict", "enhance", "box_predict", "mask_predict")
FRAMES, SUPERCHUNK = 20, 8  # chip_smoke.py's main path
RUNS, TOP = 3, 15


def timed(name, fn, totals):
    def wrapper(*args, **kw):
        key = f"{name}{kw['output_size']}" if name == "multiscale_roi_align" else name
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        totals[key] += time.perf_counter() - t0
        return out
    return wrapper


class TimedTransform:
    """The pipeline's transform, its call timed, everything else delegated."""

    def __init__(self, transform, totals):
        self._transform, self._call = transform, timed("transform", transform.__call__, totals)

    def __call__(self, images):
        return self._call(images)

    def __getattr__(self, name):
        return getattr(self._transform, name)


def stage_times(pipe, clip, runs: int) -> dict:
    """Median over `runs` of each stage's seconds in one `infer_sequence`."""
    saved = {n: getattr(pipeline_mod, n) for n in STAGE_FUNCS}
    per_run = []
    try:
        for _ in range(runs):
            totals = collections.Counter()
            for n, fn in saved.items():
                setattr(pipeline_mod, n, timed(n, fn, totals))
            for n in MODEL_METHODS:
                setattr(pipe.model, n, timed(n, getattr(type(pipe.model), n).__get__(pipe.model), totals))
            transform, pipe.transform = pipe.transform, TimedTransform(pipe.transform, totals)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.infer_sequence(clip)
            torch.cuda.synchronize()
            totals["total"] = time.perf_counter() - t0
            pipe.transform = transform
            for n in MODEL_METHODS:
                delattr(pipe.model, n)
            totals["other"] = totals["total"] - sum(v for k, v in totals.items() if k != "total")
            per_run.append(totals)
    finally:
        for n, fn in saved.items():
            setattr(pipeline_mod, n, fn)
    return {k: float(np.median([r[k] for r in per_run])) for k in per_run[0]}


def device_profile(run, top: int) -> dict:
    """One call of `run` under torch.profiler: busy share of the window
    (union of kernel intervals over the host-clock window) and top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"busy_share": "not measured (the profiler recorded no device activity)"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s

    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    total_dev = sum(us for us, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "busy_share": busy / wall_us,
        "kernel_time_ms": total_dev / 1e3,
        "kernel_launches": len(kernels),
        "top_kernels": [
            {"name": name[:90], "ms": us / 1e3, "share": us / total_dev, "calls": n}
            for name, (us, n) in ranked[:top]
        ],
    }


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_pipeline: CUDA is not available", file=sys.stderr)
        return 1

    pipe, model = pipeline_mod.build_pipeline(
        3, 3, (480, 854), dtype=torch.bfloat16, device="cuda", superchunk=SUPERCHUNK
    )
    pipeline_mod.init_weights(model, seed=0)
    clip = np.random.default_rng(1).integers(0, 256, (FRAMES, 480, 854, 3), dtype=np.uint8)
    pipe.infer_sequence(clip)  # warm-up: kernel build, cuDNN algorithm choice
    stages = stage_times(pipe, clip, RUNS)
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"stage {k:24s} {v * 1e3:9.2f} ms  {v / stages['total']:6.1%}")
    prof = device_profile(lambda: pipe.infer_sequence(clip), TOP)
    print(f"device busy {prof.get('busy_share')}")
    for k in prof.get("top_kernels", []):
        print(f"kernel {k['ms']:9.3f} ms {k['share']:6.1%} x{k['calls']:<5d} {k['name']}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "frames": FRAMES, "superchunk": SUPERCHUNK,
        "stages_ms": {k: v * 1e3 for k, v in stages.items()}, "profile": prof,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
