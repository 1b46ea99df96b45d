#!/usr/bin/env python3
"""Time builds of the RoIAlign kernels against each other on one NVIDIA GPU.

    python3 scripts/torch_roi_align_compare.py [--baseline NAME=SOURCE.cu ...] [--rounds 3]

Builds, with nvcc into a temporary directory, this checkout's
`slowfast_vos_tpu_torch/csrc/roi_align.cu` ("current") and each --baseline
source (an older commit's `roi_align.cu`, an edited copy with other tile
sizes, or a copy with a part of the work cut out, to see what that part
costs), e.g.

    git show 414f066:slowfast_vos_tpu_torch/csrc/roi_align.cu > build/atomic.cu
    python3 scripts/torch_roi_align_compare.py --baseline atomic=build/atomic.cu

(`build/` is gitignored, so such copies stay out of commits).

Forward (K1): each build is held against the plain version in f32 (atol
1e-5 + rtol 1e-5) and bf16 (atol 1e-5 + rtol 2^-8, against the plain
version in f32 on the same inputs) on chip_smoke.py's synthetic rois at
pool7 [8, 1000] and pool14 [8, 10], then its kernel alone (levels
precomputed) is timed, bf16, 256 channels, on the synthetic rois and on
one superchunk's rois from the main path (`chip_smoke.main_path_rois`).

Backward (K5), for each build that has one: held per pixel against the
plain backward (within 1e-6 + rtol B, B the plain backward of |g|; rtol
1e-5 in f32, 2^-8 in bf16) at pool7 [2, 512] and pool14 [2, 128], on
synthetic rois and on the rois of one full-width train step
(`chip_smoke.train_path_rois`), printing whether two calls give the same
bits; then timed alone (levels precomputed), bf16, 256 channels, on both
roi sets. A build is called by its own convention: this checkout's
(`roi_align.launch_backward`, scratch from
`sfvos_roi_align_backward_scratch_bytes`) or the atomic one of commit
414f066 and before (the caller zeroes f32 buffers that the kernel adds
into, and gives bf16 ones for the cast); the timed call includes that
caller's allocations and zeroing.

Every time is CUDA events around queued calls (`chip_smoke.device_ms`),
builds in turns: A B C, C B A, ... for --rounds rounds (0: checks only).
Prints the card's name and power limit and one JSON line with the median
of each build's times and, under "disagree", the builds that failed a
check: they are timed all the same, and the script then exits 1. Needs
CUDA.
"""
import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from slowfast_vos_tpu_torch import data  # noqa: E402
from slowfast_vos_tpu_torch import train as train_mod  # noqa: E402
from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod  # noqa: E402
from slowfast_vos_tpu_torch.ops import cuda_build  # noqa: E402
from slowfast_vos_tpu_torch.ops import roi_align as ra  # noqa: E402

LEVEL_HWS = chip_smoke.LEVEL_HWS


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


def backward_caller(lib: ctypes.CDLL):
    """fn(g, rois, levels, output_size) -> level gradients through `lib`'s
    backward, by its own convention; None where it has no backward."""
    if hasattr(lib, "sfvos_roi_align_backward_scratch_bytes"):
        return lambda g, rois, levels, out: ra.launch_backward(g, rois, levels, LEVEL_HWS, ra.ROI_SCALES, out, lib)
    if not hasattr(lib, "sfvos_roi_align_backward"):
        return None
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.sfvos_roi_align_backward
    fn.argtypes = [vp] * 11 + [ci] * 8 + [cf] * 4 + [ci] * 6 + [vp]
    fn.restype = ci

    def atomic(g, rois, levels, out):
        t, n = rois.shape[:2]
        c = g.shape[-1]
        bf16 = g.dtype == torch.bfloat16
        grads = [torch.zeros((t, h, w, c), dtype=torch.float32, device=g.device) for h, w in LEVEL_HWS]
        outs = [torch.empty((t, h, w, c), dtype=torch.bfloat16, device=g.device) for h, w in LEVEL_HWS] if bf16 else None
        rc = fn(g.data_ptr(), rois.data_ptr(), levels.data_ptr(), *[x.data_ptr() for x in grads],
                *([x.data_ptr() for x in outs] if bf16 else [None] * 4), *[d for hw in LEVEL_HWS for d in hw],
                *[float(s) for s in ra.ROI_SCALES], t, t * n, n, c, out, int(bf16),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"backward launch failed: {lib.sfvos_cuda_error_string(rc).decode()}")
        return outs if bf16 else grads

    return atomic


def in_turns(fns: dict, rounds: int) -> dict:
    """Device ms of each call, A B C, C B A, ... for `rounds` rounds."""
    times = {name: [] for name in fns}
    order = list(fns)
    for rnd in range(rounds * 2):
        for name in order if rnd % 2 == 0 else order[::-1]:
            times[name].append(chip_smoke.device_ms(fns[name]))
    return times


def report(result: dict, key: str, rois, times: dict) -> None:
    if not any(times.values()):
        return
    result[key] = {name: statistics.median(v) for name, v in times.items()}
    result[key + "_all"] = times
    print(f"time {key} {list(rois.shape[:2])}: " + ", ".join(
        f"{name} {statistics.median(v):.4f} ms (min {min(v):.4f}, max {max(v):.4f})" for name, v in times.items()
    ), flush=True)


def forward(libs: dict, rounds: int, result: dict, disagree: set) -> None:
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
            fns = {name: (lambda lib=lib: ra.launch_kernel(feats16, rois, levels, ra.ROI_SCALES, out_size, lib))
                   for name, lib in libs.items()}
            report(result, f"pool{out_size}_{roi_set}", rois, in_turns(fns, rounds))


def backward(libs: dict, rounds: int, result: dict, disagree: set) -> None:
    callers = {name: fn for name, fn in ((n, backward_caller(lib)) for n, lib in libs.items()) if fn is not None}
    train_rois = chip_smoke.train_path_rois(pipeline_mod, train_mod, data)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(6)
    rng = np.random.default_rng(6)
    for out_size, n in ((7, 512), (14, 128)):
        for roi_set, rois in (("synthetic", chip_smoke.rois_for(2, n, rng)), ("train_path", train_rois[out_size])):
            levels = ra.fpn_level_assignment(rois.reshape(-1, 4)).contiguous()
            g32 = torch.randn((*rois.shape[:2], out_size, out_size, 256), generator=gen, device="cuda")
            for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-8)):
                gd = g32.to(dtype)
                want = ra.multiscale_roi_align_backward_plain(gd.float(), rois, LEVEL_HWS, output_size=out_size)
                bound = ra.multiscale_roi_align_backward_plain(gd.float().abs(), rois, LEVEL_HWS, output_size=out_size)
                for name, fn in list(callers.items()):
                    try:
                        got = fn(gd, rois, levels, out_size)
                        again = fn(gd, rois, levels, out_size)
                    except RuntimeError as exc:  # a build that cannot launch is reported and not timed
                        print(f"check backward pool{out_size} {roi_set} {name}: {exc}", flush=True)
                        disagree.add(name)
                        del callers[name]
                        continue
                    worst = max(float(((a.float() - b).abs() / (1e-6 + rtol * c)).max())
                                for a, b, c in zip(got, want, bound))
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    print(f"check backward pool{out_size} {roi_set} {name} {dtype}: largest share of the per-pixel "
                          f"tolerance {worst:.3f} (1e-6 + {rtol:.3g} B), two calls bitwise equal {same}", flush=True)
                    if worst > 1.0:
                        disagree.add(name)
                del want, bound
            g16 = g32.to(torch.bfloat16)
            fns = {name: (lambda fn=fn: fn(g16, rois, levels, out_size)) for name, fn in callers.items()}
            report(result, f"backward_pool{out_size}_{roi_set}", rois, in_turns(fns, rounds))


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
    result, disagree = {}, set()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(name, src, pathlib.Path(tmp)) for name, src in specs}
        forward(libs, args.rounds, result, disagree)
        backward(libs, args.rounds, result, disagree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    result["disagree"] = sorted(disagree)
    print(json.dumps(result))
    return 1 if disagree else 0


if __name__ == "__main__":
    sys.exit(main())
