#!/usr/bin/env python3
"""The port's in-process device parallelism against its serial loop, on
every visible NVIDIA GPU of one host.

    python3 scripts/torch_parallel_scaling.py [--sequences 8] [--frames 64]
        [--osvos-sequences 4] [--osvos-frames 24] [--items 8] [--superchunk 32]

Builds the full-width pipeline (SlowFast 3-3, 480x854, bf16, default
DetectionConfig, seeded random weights) on cuda:0 and writes two synthetic
2016 val trees (one object per sequence) into a temporary directory under
`build/`. With all visible GPUs as the device list, it times in turns
(serial, parallel, parallel, serial), on the host clock around work that
ends on the host:

  inference   `infer_sequence` over the clips one after another, against
              `DeviceParallelInference.infer_group` over groups of them
              (in memory: no decode, no PNGs);
  extraction  `extract_masks(device_parallel=False)`, the default, against
              `device_parallel=True` (groups over every GPU): decode,
              inference and PNG writing, the part of `davis_evaluation`
              that the device list changes (its scoring runs serially);
  osvos       `run_osvos_for_all_sequences(device_parallel=False)` against
              the default where a process sees several GPUs (lockstep
              groups): fine-tunes of one epoch of `--items` items under SF
              with their two evaluations.

Each parallel result is checked against the serial one: detections bit for
bit, the PNG trees byte for byte, the OSVOS results (but for their wall
times) equal; a mismatch makes the script exit 1. Warm-up first: one
superchunk and one OSVOS update on every device. Prints each turn's
seconds, the speed-up of each pair, every card's name and power limit, and
one JSON line. Needs two or more GPUs.
"""
import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from slowfast_vos_tpu_torch.data import draw_sequence, make_synthetic_davis  # noqa: E402
from slowfast_vos_tpu_torch.eval import glue  # noqa: E402
from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod  # noqa: E402
from slowfast_vos_tpu_torch.ops.cuda_build import BUILD_DIR  # noqa: E402
from slowfast_vos_tpu_torch.parallel import DeviceParallelInference, make_mesh  # noqa: E402
from slowfast_vos_tpu_torch.train import osvos  # noqa: E402

HW = (480, 854)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    return time.perf_counter() - t0, out


def in_turns(serial, parallel, same, name):
    """Time serial, parallel, parallel, serial; fail unless every parallel
    result is `same` as the serial one."""
    walls = {"serial": [], "parallel": []}
    results = {}
    for kind in ("serial", "parallel", "parallel", "serial"):
        wall, results[kind] = timed(serial if kind == "serial" else parallel)
        walls[kind].append(wall)
        if "serial" in results and "parallel" in results and not same(results["serial"], results["parallel"]):
            raise SystemExit(f"{name}: the parallel result differs from the serial one")
    speedups = [s / p for s, p in zip(walls["serial"], walls["parallel"])]
    print(f"{name}: serial {', '.join(f'{w:.3f}' for w in walls['serial'])} s, parallel "
          f"{', '.join(f'{w:.3f}' for w in walls['parallel'])} s, speed-up "
          f"{', '.join(f'{x:.3f}' for x in speedups)}", flush=True)
    return {"serial_s": walls["serial"], "parallel_s": walls["parallel"], "speedup": speedups}


def same_dets(a, b):
    return len(a) == len(b) and all(
        len(x) == len(y) and all(sorted(f) == sorted(g) and all(np.array_equal(f[k], g[k]) for k in g)
                                 for f, g in zip(x, y))
        for x, y in zip(a, b))


def same_tree(a: Path, b: Path) -> bool:
    files = sorted(p.relative_to(a) for p in a.rglob("*.png"))
    return bool(files) and files == sorted(p.relative_to(b) for p in b.rglob("*.png")) and all(
        (a / f).read_bytes() == (b / f).read_bytes() for f in files)


def without_times(results):
    return {s: {e: {k: v for k, v in r.items() if k != "eval_time"} for e, r in per.items()}
            for s, per in results.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--osvos-sequences", type=int, default=4)
    ap.add_argument("--osvos-frames", type=int, default=24)
    ap.add_argument("--items", type=int, default=8)
    ap.add_argument("--superchunk", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_parallel_scaling: needs two or more CUDA devices", file=sys.stderr)
        return 1
    devices = make_mesh()
    pipe, model = pipeline_mod.build_pipeline(3, 3, HW, dtype=torch.bfloat16, device="cuda:0",
                                              superchunk=args.superchunk)
    pipeline_mod.init_weights(model, seed=0)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    clips = [draw_sequence(rng, args.frames, *HW, 2)[0] for _ in range(args.sequences)]
    groups = [clips[s : s + len(devices)] for s in range(0, len(clips), len(devices))]
    out = {"devices": len(devices), "sequences": args.sequences, "frames": args.frames,
           "superchunk": args.superchunk}

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="parallel_scaling_", dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        eval_root, osvos_root = str(tmp / "eval"), str(tmp / "osvos")
        make_synthetic_davis(eval_root, num_sequences=args.sequences, frames=args.frames, hw=HW, num_objects=1,
                             year="2016", subset="val", seed=7)
        make_synthetic_davis(osvos_root, num_sequences=args.osvos_sequences, frames=args.osvos_frames, hw=HW,
                             num_objects=1, year="2016", subset="val", seed=9)

        # Warm-up: one superchunk on every device, and a lockstep group of
        # 2-item fine-tunes (cuDNN's first backward on every device).
        dp = DeviceParallelInference(pipe, devices)
        timed(lambda: dp.infer_group([clips[0][: args.superchunk]] * len(devices)))
        osvos.train_osvos_sequences_lockstep(
            pipe, start, davis_root=osvos_root, sequence_names=["synth00"], results_root=str(tmp / "warm"),
            cfg=osvos.ExperimentConfig(freeze="SF", epochs=1), items_per_epoch=2, devices=devices)

        out["inference"] = in_turns(
            lambda: [pipe.infer_sequence(c) for c in clips],
            lambda: [d for g in groups for d in dp.infer_group(g)],
            same_dets, f"inference of {args.sequences} x {args.frames} frames")

        runs = iter(range(4))

        def extraction(device_parallel):
            tree = tmp / f"tree{next(runs)}"
            glue.extract_masks(pipe, eval_root, str(tree), year="2016", device_parallel=device_parallel)
            return tree

        out["extraction"] = in_turns(
            lambda: extraction(False), lambda: extraction(True), same_tree,
            f"extract_masks of {args.sequences} x {args.frames} frames")

        osvos_runs = iter(range(4))
        cfg = osvos.ExperimentConfig(freeze="SF", epochs=1)

        def osvos_all(device_parallel):
            r = next(osvos_runs)
            return osvos.run_osvos_for_all_sequences(
                pipe, start, davis_root=osvos_root, results_root=str(tmp / f"osvos_res{r}"),
                output_json=str(tmp / f"osvos{r}.json"), cfg=cfg, items_per_epoch=args.items,
                device_parallel=device_parallel)

        out["osvos"] = in_turns(
            lambda: osvos_all(False), lambda: osvos_all(None),
            lambda s, p: without_times(s) == without_times(p),
            f"run_osvos_for_all_sequences of {args.osvos_sequences} x {args.osvos_frames} frames, {args.items} items")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    out["cards"] = smi
    for line in smi:
        print(line)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
