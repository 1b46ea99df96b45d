#!/usr/bin/env python3
"""Time builds of the RoIAlign kernel against each other on one NVIDIA GPU.

    python3 scripts/torch_roi_align_compare.py [--baseline NAME=SOURCE.cu ...] [--rounds 3]

Builds, with nvcc into a temporary directory, this checkout's
`slowfast_vos_tpu_torch/csrc/roi_align.cu` ("current") and each --baseline
source (any source with the same C interface, e.g. an older commit's
`roi_align.cu`, an edited copy with other tile sizes, or a copy with a
part of the work cut out, to see what that part costs). Each build is
held against the plain version in f32 (atol 1e-5 + rtol 1e-5) and bf16
(atol 1e-5 + rtol 2^-8, against the plain version in f32 on the same
inputs) on chip_smoke.py's synthetic rois: f32 and bf16 at pool7, then at
pool14, build after build. Then every build's kernel alone (levels
precomputed) is timed with CUDA events (`chip_smoke.device_ms`), bf16, 256
channels, at both pools, on the synthetic rois and on one superchunk's
rois from the main path (`chip_smoke.main_path_rois`), builds in turns:
A B C, C B A, ... for --rounds rounds (0: checks only). Prints the card's
name and power limit and one JSON line with the median of each build's
times and, under "disagree", the builds that failed a check: they are
timed all the same, and the script then exits 1. Needs CUDA.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import ctypes

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod  # noqa: E402
from slowfast_vos_tpu_torch.ops import cuda_build  # noqa: E402
from slowfast_vos_tpu_torch.ops import roi_align as ra  # noqa: E402


def build(name: str, source: pathlib.Path, out_dir: pathlib.Path) -> ctypes.CDLL:
    lib = out_dir / f"{name}.so"
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {name} ptxas: {line.strip()}", flush=True)
    return ra.bind(ctypes.CDLL(str(lib)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[], help="NAME=SOURCE.cu")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_roi_align_compare: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    specs = [("current", cuda_build.CSRC / "roi_align.cu")]
    specs += [(n, pathlib.Path(p).resolve()) for n, p in (b.split("=", 1) for b in args.baseline)]
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(name, src, pathlib.Path(tmp)) for name, src in specs}

        sc = chip_smoke.SC
        pipe, model = pipeline_mod.build_pipeline(3, 3, (480, 854), dtype=torch.bfloat16, device="cuda", superchunk=sc)
        pipeline_mod.init_weights(model, seed=0)
        clip = np.random.default_rng(1).integers(0, 256, (sc, 480, 854, 3), dtype=np.uint8)
        main_rois = chip_smoke.main_path_rois(pipeline_mod, pipe, clip)
        del pipe, model

        gen = torch.Generator(device="cuda").manual_seed(3)
        rng = np.random.default_rng(3)
        feats16 = chip_smoke.pyramid(sc, 256, gen, torch.bfloat16)
        feats32 = [f.float() for f in feats16]
        result, disagree = {}, set()
        for out_size, n in ((7, 1000), (14, 10)):
            for roi_set, rois in (("synthetic", chip_smoke.rois_for(sc, n, rng)), ("main_path", main_rois[out_size])):
                levels = ra.fpn_level_assignment(rois.reshape(-1, 4)).contiguous()
                if roi_set == "synthetic":
                    want32 = ra.multiscale_roi_align_plain(feats32, rois, output_size=out_size)
                    want16 = ra.multiscale_roi_align_plain([f.float() for f in feats16], rois, output_size=out_size)
                    for name, lib in libs.items():
                        for feats, want, rtol in ((feats32, want32, 1e-5), (feats16, want16, 2.0**-8)):
                            got = ra.launch_kernel(feats, rois, levels, ra.ROI_SCALES, out_size, lib).float()
                            err = (got - want).abs()
                            ok = bool((err <= 1e-5 + rtol * want.abs()).all())
                            print(f"check pool{out_size} {name} {feats[0].dtype}: max abs err {err.max().item():.3e} "
                                  f"(atol 1e-5 + rtol {rtol:.3g}) ok {ok}", flush=True)
                            if not ok:
                                disagree.add(name)
                times = {name: [] for name in libs}
                order = list(libs)
                for rnd in range(args.rounds * 2):
                    for name in order if rnd % 2 == 0 else order[::-1]:
                        fn = lambda lib=libs[name]: ra.launch_kernel(feats16, rois, levels, ra.ROI_SCALES, out_size, lib)  # noqa: E731
                        times[name].append(chip_smoke.device_ms(fn))
                if not args.rounds:
                    continue
                key = f"pool{out_size}_{roi_set}"
                result[key] = {name: statistics.median(v) for name, v in times.items()}
                result[key + "_all"] = times
                print(f"time {key} {list(rois.shape[:2])}: " + ", ".join(
                    f"{name} {statistics.median(v):.4f} ms (min {min(v):.4f}, max {max(v):.4f})" for name, v in times.items()
                ), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    result["disagree"] = sorted(disagree)
    print(json.dumps(result))
    return 1 if disagree else 0


if __name__ == "__main__":
    sys.exit(main())
