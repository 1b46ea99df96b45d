#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main path, on one NVIDIA GPU.

    python3 scripts/torch_profile_pipeline.py

Builds the full-width pipeline (DAVIS 480x854, SlowFast 3-3, bf16, seeded
random weights) on both paths over one model: the CUDA graphs (the default
on the card, one replay per superchunk) and the eager path (`graphs=False`),
warms both up, then

1. runs `infer_sequence` on the graph path with the port's tracer on
   (`utils/profiling.py::TRACER`; the first run captures the graphs anew
   with their stage marks): each graph's device milliseconds by stage a
   replay, read from the timing events the graph records, and the host
   spans' seconds a run;
2. runs each path once more, unwrapped, under `torch.profiler`: the
   device's busy and idle share of the run and the kernels with the most
   device time;
3. times both paths' whole runs in turns (host clock, synchronized).

Every number is labelled with the path that ran. Prints the card's name and
power limit and one JSON line. Needs CUDA.
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
from slowfast_vos_tpu_torch.utils.profiling import TRACER  # noqa: E402

FRAMES, SUPERCHUNK = 20, 8  # chip_smoke.py's main path
RUNS, TOP = 3, 15


def tracer_split(run, runs: int) -> dict:
    """`run()` once with the port's tracer on, which captures its graphs
    with their stage marks, then `runs` more times: each graph's device ms
    by stage a read replay (`stages_ms`, by graph label) and the spans'
    seconds a run (`spans_s`)."""
    TRACER.enable()
    try:
        run()
        TRACER.take()
        for _ in range(runs):
            run()
        torch.cuda.synchronize()
        snap = TRACER.take()
    finally:
        TRACER.disable()
    return {"stages_ms": {label: {k: v / st["samples"] for k, v in st["ms"].items()}
                          for label, st in snap["stages"].items() if st["samples"]},
            "spans_s": {k: v["total_s"] / runs for k, v in snap["totals"].items()}}


def print_split(split: dict) -> None:
    for label, stages in split["stages_ms"].items():
        print(f"stages (device, a replay) {label}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    for k, v in sorted(split["spans_s"].items(), key=lambda kv: -kv[1]):
        print(f"span {k:28s} {v * 1e3:9.3f} ms a run")


def device_profile(run, top: int, groups: dict | None = None) -> dict:
    """One call of `run` under torch.profiler: busy share of the window
    (union of kernel intervals over the host-clock window) and top kernels;
    with `groups` ({group: name substrings}), the device ms and calls of
    each group's kernels too, a kernel going to the first group one of
    whose substrings its name holds."""
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
    grouped = {g: {"ms": 0.0, "calls": 0} for g in groups or {}}
    for name, (us, n) in by_name.items():
        g = next((g for g, subs in (groups or {}).items() if any(sub in name for sub in subs)), None)
        if g is not None:
            grouped[g]["ms"] += us / 1e3
            grouped[g]["calls"] += n
    return {
        "groups": grouped,
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
    paths = {"eager": pipeline_mod.Pipeline(model, pipe.transform, superchunk=SUPERCHUNK, graphs=False),
             "graphs": pipe}
    clip = np.random.default_rng(1).integers(0, 256, (FRAMES, 480, 854, 3), dtype=np.uint8)
    for p in paths.values():
        p.infer_sequence(clip)  # warm-up: kernel build, cuDNN set-up, graph capture
    split = tracer_split(lambda: paths["graphs"].infer_sequence(clip), RUNS)
    print_split(split)
    profiles = {}
    for name, p in paths.items():
        profiles[name] = prof = device_profile(lambda: p.infer_sequence(clip), TOP)
        print(f"{name}: wall {prof.get('wall_ms')} ms, device busy {prof.get('busy_share')}")
        for k in prof.get("top_kernels", []):
            print(f"{name}: kernel {k['ms']:9.3f} ms {k['share']:6.1%} x{k['calls']:<5d} {k['name']}")
    walls = {name: [] for name in paths}
    for _ in range(RUNS):
        for name, p in paths.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.infer_sequence(clip)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    wall_ms = {name: float(np.median(v)) for name, v in walls.items()}
    print("whole runs in turns (median of %d): " % RUNS + ", ".join(
        f"{name} {ms:.2f} ms ({FRAMES / ms * 1e3:.2f} frames/s)" for name, ms in wall_ms.items()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "frames": FRAMES, "superchunk": SUPERCHUNK,
        "tracer": split, "profile": profiles,
        "wall_ms_in_turns": wall_ms, "walls_ms": walls,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
