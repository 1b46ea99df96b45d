#!/usr/bin/env python3
"""Time builds of the NMS kernel (K3) against each other and against the plain fixpoint, on one NVIDIA GPU.

    python3 scripts/torch_nms_compare.py [--baseline NAME=SOURCE.cu ...] [--rounds 3] [--runs 5]
                                         [--clusters 4,8,16]

Builds, with nvcc into a temporary directory, this checkout's
`slowfast_vos_tpu_torch/csrc/nms.cu` ("current") and each --baseline
source: an older commit's `nms.cu` or an edited copy, e.g. the two-kernel
build of commit 0eae7c5,

    git show 0eae7c5:slowfast_vos_tpu_torch/csrc/nms.cu > build/k3_pr9.cu
    python3 scripts/torch_nms_compare.py --baseline pr9=build/k3_pr9.cu

(`build/` is gitignored, so such copies stay out of commits). A build is
called by its own convention: this checkout's (`nms.nms_cuda(..., lib=)`:
the boxes, effective scores and order in, the keep mask out) or the
two-kernel one of 0eae7c5 (boxes and flags gathered into score order by
`score_order`, a bitmask scratch of P * N * ceil(N/64) * 8 bytes, the
alive flags scattered back), each inside an `nms_mask` of its own.

Kernel (the first part): on chip_smoke.py's NMS_SHAPES (quantized
synthetic candidates: the RPN at inference [8, 5, 1000] and in a train step
[2, 5, 2000], thr 0.7; class-keyed [8, 1000] and [1, 8192], thr 0.5), on
the RPN's [32, 5, 1000] at the CLIs' superchunk 32, and on
the candidates of phase 2's and phase 3's own NMS calls, each build's
`nms_mask` is held index for index against the fixpoint; then the kernel
alone (inputs precomputed) and the whole `nms_mask` are timed, CUDA events
around queued calls (`chip_smoke.device_ms`), builds in turns A B C, C B
A, ... for --rounds rounds; the device kernels each build's `nms_mask`
launches per call are counted (torch.profiler). --clusters times the
current build alone at every shape with K3's cluster size forced to each
value listed (the route follows it), in turns.

End to end (--runs rounds, 0 skips it): chip_smoke.py's phase 2 pipeline
(DAVIS 480x854, SlowFast 3-3, bf16, superchunk 8, seeded random weights,
its 20-frame seeded clip) and phase 3's trainer (default DetectionConfig,
one seeded window), with every NMS of the port through one path at a
time, in turns (plain, kernel, baselines..., then reversed): "plain" is
`algorithm="fixpoint"`, "kernel" the shipped `nms_mask`, and one path per
baseline. Checks that every path gives the same detections bit for bit,
then prints `infer_sequence` frames/s and `Trainer.step` ms (synchronized
around each call; medians).

Prints the card's name and power limit and one JSON line; exits 1 if a
build disagrees with the fixpoint or the detections differ. Needs CUDA.
"""
import argparse
import contextlib
import ctypes
import functools
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from torch_profile_train import training_window  # noqa: E402

from slowfast_vos_tpu_torch import data  # noqa: E402
from slowfast_vos_tpu_torch import train as train_mod  # noqa: E402
from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod  # noqa: E402
from slowfast_vos_tpu_torch.models import rpn  # noqa: E402
from slowfast_vos_tpu_torch.ops import cuda_build  # noqa: E402
from slowfast_vos_tpu_torch.ops import nms  # noqa: E402
from slowfast_vos_tpu_torch.train import Trainer  # noqa: E402

FRAMES, SUPERCHUNK = 20, chip_smoke.SC  # chip_smoke.py's main path
CLI_RPN = ("rpn inference sc32", (32, 5), 1000, 0.7, False)  # filter_proposals at the CLIs' superchunk 32


def build(name: str, source: pathlib.Path, out_dir: pathlib.Path) -> ctypes.CDLL:
    lib = out_dir / f"{name}.so"
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  {name} ptxas: {line.strip()}", flush=True)
    return ctypes.CDLL(str(lib))


def two_kernel_mask(lib: ctypes.CDLL):
    """(nms_mask, kernel alone) through a build of 0eae7c5's convention:
    `sfvos_nms(boxes, valid, problems, n, thr, scratch, bytes, alive,
    stream)` on boxes and flags in score order."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sfvos_nms.argtypes = [vp, vp, ci, ci, ctypes.c_float, vp, ctypes.c_longlong, vp, vp]
    lib.sfvos_nms.restype = ci
    lib.sfvos_cuda_error_string.argtypes = [ci]
    lib.sfvos_cuda_error_string.restype = ctypes.c_char_p

    def alone(sboxes, svalid, thr):
        n = sboxes.shape[-2]
        alive = torch.empty(svalid.shape, dtype=torch.bool, device=svalid.device)
        if alive.numel() == 0:
            return alive
        problems = alive.numel() // n
        nbytes = problems * n * -(-n // 64) * 8
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=svalid.device)
        rc = lib.sfvos_nms(sboxes.data_ptr(), svalid.data_ptr(), problems, n, thr, scratch.data_ptr(), nbytes,
                           alive.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"NMS kernel launch failed: {lib.sfvos_cuda_error_string(rc).decode()}")
        return alive

    def mask(boxes, scores, valid=None, *, iou_threshold=0.5, block_size=128, algorithm="auto"):
        if algorithm != "auto":
            return nms.nms_mask(boxes, scores, valid, iou_threshold=iou_threshold, block_size=block_size,
                                algorithm=algorithm)
        order, sboxes, svalid = nms.score_order(boxes, scores, valid)
        alive = alone(sboxes, svalid, iou_threshold)
        return torch.zeros_like(alive).scatter(-1, order, alive), order

    return mask, alone


def callers(libs: dict) -> dict:
    """{build: (nms_mask, fn(boxes, scores, valid, thr) -> the kernel alone
    on precomputed inputs, timed by the caller)}."""
    out = {}
    for name, lib in libs.items():
        if hasattr(lib, "sfvos_nms_prepare"):
            nms.bind(lib)
            mask = functools.partial(current_mask, lib=lib)

            def alone_on(boxes, scores, valid, thr, lib=lib):
                eff, order = nms.effective_order(scores, valid)
                return lambda: nms.nms_cuda(boxes, eff, order, thr, lib=lib)
        else:
            mask, alone = two_kernel_mask(lib)

            def alone_on(boxes, scores, valid, thr, alone=alone):
                _, sboxes, svalid = nms.score_order(boxes, scores, valid)
                return lambda: alone(sboxes, svalid, thr)
        out[name] = (mask, alone_on)
    return out


def current_mask(boxes, scores, valid=None, *, iou_threshold=0.5, block_size=128, algorithm="auto", lib=None):
    """`nms_mask` with the kernel of build `lib` on CUDA tensors."""
    if algorithm != "auto":
        return nms.nms_mask(boxes, scores, valid, iou_threshold=iou_threshold, block_size=block_size,
                            algorithm=algorithm)
    eff, order = nms.effective_order(scores, valid)
    return nms.nms_cuda(boxes.contiguous(), eff.contiguous(), order, iou_threshold, lib=lib), order


def in_turns(fns: dict, rounds: int) -> dict:
    """Device ms of each call, A B C, C B A, ... for `rounds` rounds."""
    times = {name: [] for name in fns}
    order = list(fns)
    for rnd in range(rounds * 2):
        for name in order if rnd % 2 == 0 else order[::-1]:
            times[name].append(chip_smoke.device_ms(fns[name]))
    return times


def kernel_part(builds: dict, cases: list, rounds: int, clusters: list, result: dict, disagree: set) -> None:
    for tag, (boxes, scores, valid, thr) in cases:
        n = valid.shape[-1]
        want = nms.nms_mask(boxes, scores, valid, iou_threshold=thr, algorithm="fixpoint")
        for name, (mask, _) in builds.items():
            keep, order = mask(boxes, scores, valid, iou_threshold=thr)
            again = mask(boxes, scores, valid, iou_threshold=thr)
            ok = torch.equal(keep, want[0]) and torch.equal(order, want[1])
            same = torch.equal(keep, again[0])
            print(f"check {tag} {list(valid.shape)} {name}: index-exact with the fixpoint {ok}, two calls bitwise "
                  f"equal {same}", flush=True)
            if not (ok and same):
                disagree.add(name)
        rec = {"shape": list(valid.shape), "thr": thr, "route": nms.route(n), "cluster": nms.cluster_size(n),
               "max_active_clusters": nms._prepared(nms._library(), torch.cuda.current_device(), n,
                                                    nms.cluster_size(n), nms.route(n) == "global")}
        print(f"config {tag}: {rec['route']} route, cluster of {rec['cluster']}, the card holds "
              f"{rec['max_active_clusters']} such clusters at once", flush=True)
        alone = {name: a(boxes, scores, valid, thr) for name, (_, a) in builds.items()}
        full = {name: (lambda m=m: m(boxes, scores, valid, iou_threshold=thr)) for name, (m, _) in builds.items()}
        rec["alone_ms"] = in_turns(alone, rounds)
        rec["nms_mask_ms"] = in_turns(full, rounds)
        rec["device_launches_per_call"] = {name: chip_smoke.kernel_ms_by_name(fn, ())[1] for name, fn in full.items()}
        for key in ("alone_ms", "nms_mask_ms"):
            print(f"time {tag} {list(valid.shape)} {key[:-3]}: " + ", ".join(
                f"{name} {statistics.median(v):.4f} ms (min {min(v):.4f}, max {max(v):.4f})"
                for name, v in rec[key].items()), flush=True)
        print(f"launches {tag}: device kernels per nms_mask call " +
              ", ".join(f"{k} {v:g}" for k, v in rec["device_launches_per_call"].items()), flush=True)
        if clusters:
            picked = nms.cluster_size
            eff, order = nms.effective_order(scores, valid)
            fns = {}
            for c in clusters:
                def run(c=c):
                    nms.cluster_size = lambda _n: c
                    try:
                        return nms.nms_cuda(boxes, eff, order, thr)
                    finally:
                        nms.cluster_size = picked
                if not torch.equal(run(), want[0]):
                    print(f"check {tag} cluster {c}: disagrees with the fixpoint", flush=True)
                    disagree.add(f"current cluster {c}")
                fns[f"cluster {c}"] = run
            rec["alone_ms_by_cluster"] = in_turns(fns, rounds)
            print(f"time {tag} alone by cluster size: " + ", ".join(
                f"{k} {statistics.median(v):.4f} ms" for k, v in rec["alone_ms_by_cluster"].items()), flush=True)
        result.setdefault("kernel", {})[tag] = rec


@contextlib.contextmanager
def nms_path(mask):
    """Within the block, every NMS of the port goes through `mask` (an
    `nms_mask`), or the shipped one where `mask` is None."""
    shipped = nms.nms_mask
    if mask is not None:
        rpn.nms_mask = nms.nms_mask = mask
    try:
        yield
    finally:
        rpn.nms_mask = nms.nms_mask = shipped


def paths_in_turns(fns: dict, paths: dict, runs: int) -> dict:
    """{path: [seconds of each call]}, the paths in turns, synchronized
    around each call."""
    times = {name: [] for name in fns}
    for r in range(runs):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            with nms_path(paths[name]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[name]()
                torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return times


def end_to_end(builds: dict, runs: int, result: dict) -> bool:
    paths = {"plain": functools.partial(nms.nms_mask, algorithm="fixpoint"), "kernel": None}
    paths.update({name: mask for name, (mask, _) in builds.items() if name != "current"})
    pipe, model = pipeline_mod.build_pipeline(3, 3, (480, 854), dtype=torch.bfloat16, device="cuda",
                                              superchunk=SUPERCHUNK)
    pipeline_mod.init_weights(model, seed=0)
    clip = np.random.default_rng(1).integers(0, 256, (FRAMES, 480, 854, 3), dtype=np.uint8)
    dets = {}
    for name, mask in paths.items():  # warm-up, and the detections of each path
        with nms_path(mask):
            dets[name] = pipe.infer_sequence(clip)
    same = all(sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
               for other in dets.values() for a, b in zip(dets["plain"], other))
    print(f"detections of the {len(paths)} paths equal bit for bit: {same}")
    infer = paths_in_turns({name: lambda: pipe.infer_sequence(clip) for name in paths}, paths, runs)
    fps = {k: FRAMES / statistics.median(v) for k, v in infer.items()}
    for k, v in infer.items():
        print(f"infer_sequence {FRAMES} frames, superchunk {SUPERCHUNK}, {k}: "
              f"{', '.join(f'{t:.4f}' for t in v)} s -> {fps[k]:.2f} frames/s (median)")
    del pipe, model

    tpipe, tmodel = pipeline_mod.build_pipeline(3, 3, (480, 854), dtype=torch.bfloat16, device="cuda",
                                                superchunk=SUPERCHUNK)
    pipeline_mod.init_weights(tmodel, seed=0)
    trainer, batch = Trainer(tpipe, seed=0), training_window()
    for mask in paths.values():
        with nms_path(mask):
            trainer.step(batch)
    train = paths_in_turns({name: lambda: trainer.step(batch) for name in paths}, paths, runs)
    step_ms = {k: 1e3 * statistics.median(v) for k, v in train.items()}
    for k, v in train.items():
        print(f"Trainer.step, {k}: {', '.join(f'{1e3 * t:.2f}' for t in v)} ms -> {step_ms[k]:.2f} ms (median)")
    result.update({"frames": FRAMES, "superchunk": SUPERCHUNK, "detections_equal": same, "infer_s": infer,
                   "frames_per_s": fps, "step_s": train, "step_ms": step_ms})
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[], help="NAME=SOURCE.cu")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of the kernel timings (in turns)")
    ap.add_argument("--runs", type=int, default=5, help="rounds of each end-to-end path (in turns); 0 skips them")
    ap.add_argument("--clusters", default="", help="cluster sizes to time the current build at, e.g. 4,8,16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_nms_compare: CUDA is not available", file=sys.stderr)
        return 1

    specs = [("current", cuda_build.CSRC / "nms.cu")]
    specs += [(n, pathlib.Path(p).resolve()) for n, p in (b.split("=", 1) for b in args.baseline)]
    clusters = [int(c) for c in args.clusters.split(",") if c]
    result, disagree = {"device": torch.cuda.get_device_name(0)}, set()
    with tempfile.TemporaryDirectory() as tmp:
        builds = callers({name: build(name, src, pathlib.Path(tmp)) for name, src in specs})
        # The main path's own candidates: one superchunk of phase 2, one step of phase 3.
        pipe, model = pipeline_mod.build_pipeline(3, 3, (480, 854), dtype=torch.bfloat16, device="cuda",
                                                  superchunk=SUPERCHUNK)
        pipeline_mod.init_weights(model, seed=0)
        clip = np.random.default_rng(1).integers(0, 256, (SUPERCHUNK, 480, 854, 3), dtype=np.uint8)
        _, main_nms = chip_smoke.main_path_rois(pipeline_mod, pipe, clip)
        del pipe, model
        *_, trainer, batch, _ = chip_smoke.full_width_trainer(pipeline_mod, train_mod, data)
        with chip_smoke.keeping_nms_inputs() as train_nms:
            trainer.step(batch)
        del trainer, batch
        torch.cuda.empty_cache()
        rng = np.random.default_rng(31)
        cases = [(f"synthetic {name}", chip_smoke.nms_case(rng, lead, n, thr, keyed))
                 for name, lead, n, thr, keyed in (*chip_smoke.NMS_SHAPES, CLI_RPN)]
        cases += [("main_path rpn", main_nms["rpn"]), ("main_path class_keyed", main_nms["class_keyed"]),
                  ("train_path rpn", train_nms["rpn"])]
        kernel_part(builds, cases, args.rounds, clusters, result, disagree)
        same = end_to_end(builds, args.runs, result) if args.runs else True

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    result.update({"card": card, "disagree": sorted(disagree)})
    print(json.dumps(result))
    return 0 if same and not disagree else 1


if __name__ == "__main__":
    sys.exit(main())
