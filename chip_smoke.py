#!/usr/bin/env python3
"""Drive the PyTorch port of SlowFast Mask R-CNN on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   - compile every hand-written kernel of `slowfast_vos_tpu_torch/csrc`
             with nvcc (one process per source, all started together), with
             each kernel's registers and spills;
2. main    - `build_pipeline(3, 3, (480, 854), bf16)` with seeded random
             weights, `infer_sequence` over a 20-frame clip (first, carry and
             ragged-tail superchunks) on the CUDA graph path, the default on
             the card (each key's first superchunk eager, then captured;
             later ones replayed), launch counts read around that run
             (NMS twice and K8 61 times per superchunk), frames/s, peak
             device memory; one
             superchunk's real proposals and detection boxes, and the
             candidates of its two NMS calls, are kept (on the eager path,
             same model) for phases 4 and 6;
3. train   - `Trainer` on the same full-width model (default
             DetectionConfig: 2000 proposals, 512 box and 128 mask rois per
             frame), 8 steps on one seeded window of moving blobs from
             `train_windows` (2 centre frames + halo) on the card's default
             path (the first step eager and captured, then CUDA graph
             replays), launch counts read around those steps (forward and
             backward kernel at both pools and K3 in every step, K6's
             forward and backward 32 times each, replays included), finite
             losses, trainable weights moved, frozen
             ones and FrozenBatchNorm buffers bit-identical, SlowFast running
             statistics moved, ms/step and peak device memory, then
             `infer_sequence` on the trained model; the first step's sampled
             rois and RPN NMS candidates are kept for phases 4 and 6;
4. kernels - hold each kernel against its plain PyTorch version at the main
             path's shapes (DAVIS 480x854 -> 768x1344 canvas, superchunk 8:
             [8, 1000] proposals for the 7x7 pool, [8, 10] detections for the
             14x14 pool, 256 channels), in f32 (TF32 off) and bf16, on
             synthetic rois with the edge cases and on the main path's own
             rois, and at 40 channels on the synthetic rois; the backward
             kernel likewise at the train path's shapes ([2, 512] and
             [2, 128] rois), per pixel against the plain backward, and
             bitwise equal over two calls on the train path's rois; the NMS
             kernel index-exact against the plain fixpoint on phases 2 and
             3's own candidates, at the main path's shapes on quantized
             boxes and scores (ties), at block edges, at the boundary of
             its shared and global routes and on edge cases,
             bitwise equal over two calls, and its path run under the sync
             debug mode "error" (no host synchronize);
5. reference - a small f32 input through the same entry point on the card
             and on the CPU (the plain versions), compared; and tiny f32
             train steps on both, same weights and draws: the default
             freeze, OSVOS's SF (the backbone trains) and the pretrain
             Mask R-CNN (no SlowFast, trainable_backbone_layers 3);
6. timings - each kernel on both roi sets, with and without the level
             assignment, against its bound and its plain version (the
             forward also against its per-roi footprint); the NMS kernel at
             its four shapes, alone and with the sort around it, its
             device launches per call, route and cluster size, against its
             bound and the plain fixpoint;
7. drivers - the three drivers at full width (480x854, bf16, default
             DetectionConfig, seeded weights) on synthetic DAVIS trees
             written at run time (2017 train: 2 sequences x 8 frames, 2
             objects; 2016 val: 1 sequence x 16 frames, two superchunks):
             `train_unsupervised` for 2 epochs of 3 windows with its
             evaluation before and after each, then resumed for a third;
             the checkpoint restored bit for bit; evaluation frames/s with
             and without PNG writing and scoring; the ground truth as a
             prediction scoring J&F 1.0; `train_osvos_sequence` under SF
             (4 items, 2 updates); `train_maskrcnn` (3 steps of 2 frames)
             and `extract_rpn_proposals`. Launch counts of both kernels at
             both pools are read around each driver; ms/step, wall seconds
             and peak device memory are printed;
8. cli     - the CLIs (`scripts/torch_*.py`) as the reference's chain, each
             through `main(argv)` at the same width on trees like phase 7's:
             the Mask R-CNN fine-tune (1 epoch) and its proposal dump;
             unsupervised training (1 epoch) from that checkpoint, whose
             `slow_fast.*` the loader must report untouched; evaluation of
             `ckpt_best`; extraction, and the scorer on the extracted tree
             (J&F equal to the evaluation's within 1e-6); OSVOS single (4
             items); the overlay dump; the trained weights as a reference
             `.pth` (prefixed keys, `num_batches_tracked`) through the
             evaluation (no unused key, the same J&F); one real subprocess
             of `scripts/torch_evaluate.py`; `torch_bench.py --runs 2` and
             `--train`. Wall seconds and launch counts of each CLI;
9. parallel - the parallel layer at the same width on trees like phase
             7's: two ranks of one process group on the one card, worker
             processes of this script started once (nccl is tried first and
             refuses two ranks on one GPU, so they run on gloo with the
             tensors on the card): 3 data-parallel steps (the loss against
             the mean of both windows' single-window losses at the same
             weights and draws, the ranks' parameters bit-equal after every
             step), `train_unsupervised` data parallel for 1 epoch of 3
             windows (a wrap-filled group; identical histories, checkpoints
             on rank 0 only), the sharded `davis_evaluation` of 3 sequences
             (the PNG tree byte-identical to the serial one, the same J&F)
             and the sharded `run_osvos_for_all_sequences` of 2 sequences
             of 4 items (the merged JSON equal to the serial run's); a
             one-rank nccl group's 2 DP steps, then 5 warm serial and DP
             steps in turns on one window and draws; in this process
             `DeviceParallelInference` over [cuda:0, cuda:0] on ragged clips
             (detections equal to serial bit for bit) and lockstep OSVOS of
             2 members (each equal to its serial fine-tune), members on
             their own host threads. Launch counts of each rank and
             sub-step, ms per DP step, the one-rank group's warm DP and
             serial steps in turns, wall seconds. Two ranks on one card
             show correctness and overhead, not scaling;
10. nms blocked - the NMS kernel and the blocked sweep against the
             fixpoint at N = 8192 (index-exact, times, peak memory);
11. graphs - the superchunk's CUDA graphs against the eager path on one
             model at full width, at superchunk 8 over 20 frames and at 32
             over 64: bit for bit with and without instance masks (first
             and warm graph runs), launches counted per
             replay (K8's too), the host's part of a run under the sync debug mode
             "error" on both paths, peak device memory of each path, frames/s
             in turns and capture times; other weights loaded in place
             replayed with no new capture, a replaced parameter recaptured.
             Phases 2 and 7-9 run on the graph path already.
12. train graphs - the training step's CUDA graphs against the eager path
             at full width: unsupervised (accumulate 1), OSVOS (1 centre
             frame, accumulate 2, freeze SF) and the Mask R-CNN fine-tune
             (backbone trains, LambdaLR warm-up, two canvases), 8 calls
             each from one saved state and seed, twice eagerly and once on
             graphs: losses, gradients, weights after each update, SlowFast
             running statistics, the samplers' draws and the generator
             bit for bit where the eager runs agree, else within their
             spread; inference graphs captured before training replaying
             the trained weights; launches recorded per replay; the host's
             part of a warm step under the sync debug mode "error" on both
             paths; ms/step in turns, capture times and both memory peaks;
             reserved memory over successive OSVOS trainers. Phases 3, 7
             and 9 train on step graphs already.
13. bn     - K6, SlowFast's train-mode BatchNorm (`csrc/batch_norm.cu`), on
             phase 3's own inputs: one eager step of phase 3's set-up keeps
             all 32 calls (8 BatchNorms x 4 FPN levels, bf16), their inputs
             and the gradients their outputs receive (and those gradients'
             layouts); each call's bytes and its launch plan each way
             (`ops/batch_norm.py::plan`: on-chip or stream route, grid,
             slots); per call the forward kernel against the plain forward
             and float64 statistics, the normalize and the backward kernel
             against their plain versions on the same inputs; one device
             kernel a call each way, by name (torch.profiler over the 32
             calls); device times of the kernels, the plain versions and
             `F.batch_norm` (forward and backward) per call at P2's `bn_s1`
             [4, 192, 192, 336] and summed over the step, against the
             bounds.
14. k7     - K7, ViTDet's attention with decomposed relative positions
             (`csrc/attention.cu`), at ViTDet-B's shapes (12 heads
             of 64; global blocks N = 4096, window blocks 25 windows of
             N = 196 a frame): against the plain version in float32 on the
             same bf16 inputs (2 frames), one launch a call by the counter
             and one device kernel by name, no allocation of N^2 elements;
             device time a frame at a superchunk's 34 frames, against the
             bound (operations at 989 TFLOP/s against q, k, v, o and both
             terms at 3.35 TB/s), the plain version's (2 frames), and as a
             yardstick only `scaled_dot_product_attention` with the bias
             materialized (`library_ms`, 2 frames; the port never calls
             it).
             `python3 chip_smoke.py k7` runs this phase alone.
15. k8     - K8, the backbone's convolution epilogue
             (`csrc/conv_epilogue.cu`), at every call of the folded
             ResNet-50 + FPN on a first superchunk (34 frames, 768x1344,
             bf16; 61 calls): each call's shape against the backbone's own
             (`cuda_build.launches["epilogue"]` over one forward); at each
             call's shape, residual and ReLU, K8 against its plain version
             (one bf16 ulp) and its device time in place, as the backbone runs it,
             against its byte bound (x, the residual, y at 3.35 TB/s), the
             plain version's and the form the fold replaced as a yardstick
             (`x * w + b`, the residual add and the ReLU as PyTorch's own
             passes, bf16); per call and summed over the superchunk.
             `python3 chip_smoke.py k8` runs this phase alone.

Prints one JSON line of kernel records, the card's name and power limit, and
as its last line {"ok": true, "device": {...}}. Exits non-zero, with no
result line, where CUDA is absent or any phase fails.
"""
import collections
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
CANVAS = (768, 1344)  # 480x854 resized to 749x1333, padded to /64
LEVEL_HWS = [(CANVAS[0] // s, CANVAS[1] // s) for s in (4, 8, 16, 32)]
SC = 8
TRAIN_STEPS = 8
DRIVER_HW = (480, 854)  # DAVIS 480p
GRAD_SHARE = 1e-3  # tests/test_torch_train.py's gradient tolerance
# Kernel launch keys (`cuda_build.launches`): K1 and K5 at both pools, K3,
# K6's forward and backward.
BN_KEYS = ("bn", ("backward", "bn"))
LAUNCH_KEYS = (7, 14, ("backward", 7), ("backward", 14), "nms", *BN_KEYS)
FORWARD_KEYS = (7, 14, "nms")  # what inference launches
NO_SLOWFAST_KEYS = LAUNCH_KEYS[:5]  # what the Mask R-CNN fine-tune launches: it has no SlowFast
BN_PER_STEP = 32  # K6 calls a train step makes, forward and backward: 8 BatchNorms x 4 FPN levels
K8_PER_BACKBONE = 61  # K8 calls of a backbone forward: the stem, 16 blocks x 3, 4 downsamples, 8 FPN convolutions
INFER_KEYS = (*FORWARD_KEYS, "epilogue")  # what a ResNet pipeline's inference launches, K8 included


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def pyramid(t: int, c: int, gen: torch.Generator, dtype) -> list[torch.Tensor]:
    ch, cw = CANVAS
    return [
        torch.randn((t, ch // s, cw // s, c), generator=gen, device="cuda").to(dtype)
        for s in (4, 8, 16, 32)
    ]


def rois_for(t: int, n: int, rng: np.random.Generator) -> torch.Tensor:
    """Proposal-like boxes on the canvas, with rois that make duplicate and
    degenerate taps in every frame."""
    ch, cw = CANVAS
    xy = rng.uniform(-40, [cw, ch], (t, n, 2))
    wh = rng.uniform(1, 500, (t, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    extra = np.array([
        [100.0, 50.0, 130.0, 700.0],     # tall, > 20:1
        [10.0, 300.0, 1300.0, 340.0],    # wide, > 30:1
        [200.0, 200.0, 200.6, 200.4],    # sub-pixel
        [50.0, 50.0, 50.0, 50.0],        # zero area
        [-300.0, -200.0, 20.0, 10.0],    # mostly off-canvas: invalid samples
        [1330.0, 760.0, 1500.0, 900.0],  # past the bottom-right corner
        [100.0, 762.0, 106.0, 768.0],    # samples in (H-1, H]: clamped, lo == hi
        [0.0, 0.0, 1340.0, 760.0],       # P5, 28 distinct x taps at pool7
        [300.0, 300.0, 330.0, 329.0],    # P2, a bin per ~1 px
    ])
    boxes[:, : min(n, len(extra))] = extra[: min(n, len(extra))]
    return torch.from_numpy(boxes.astype(np.float32)).cuda()


def call_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median host-clock time of one call of `fn`, synchronized around each:
    what a caller waits, host overhead of the wrapper included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, runs: int = 20, attempts: int = 3) -> float:
    """Device time of one call of `fn`: CUDA events around `runs` calls
    queued back to back behind a spin kernel, so the host's launch overhead
    is hidden and the device runs the calls without gaps. Where the spin
    ended before the host had queued every call (a host stall), the
    measurement is thrown away and taken again behind a spin four times as
    long; fails if that happens `attempts` times."""
    host_ms = call_ms(fn, runs=3, warmup=1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(attempts):
        torch.cuda.synchronize()
        # ~2 cycles/ns: twice the queueing time, then four times more per retry
        torch.cuda._sleep((int(4e6 * host_ms * runs) + 10**7) * 4**attempt)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / runs
    check(False, "device_ms: the host queued the calls slower than the spin kernel ran")


def roi_align_bound(ra, feats, rois, out_size) -> tuple[float, str]:
    """Least time for this call on an H100: bytes (each output once, the
    feature pixels this run's taps touch once, rois and levels once) over
    the memory rate, against f32 operations (4 multiply-adds per valid sample
    and channel) over the f32 rate."""
    c, elem = feats[0].shape[-1], feats[0].element_size()
    grid = ra.sample_grid([f.shape[1:3] for f in feats], rois, ra.ROI_SCALES, out_size, 2)
    valid = grid["my"][:, :, None] & grid["mx"][:, None, :]  # [M, S, S]
    touched = torch.zeros(sum(f.shape[0] * f.shape[1] * f.shape[2] for f in feats), dtype=torch.bool, device="cuda")
    for ya in ("y0", "y1"):
        for xa in ("x0", "x1"):
            idx = grid["base"][:, None, None] + grid[ya][:, :, None] * grid["width"][:, None, None] + grid[xa][:, None, :]
            touched[idx[valid]] = True
    m = rois.shape[0] * rois.shape[1]
    nbytes = m * out_size * out_size * c * elem + int(touched.sum()) * c * elem + m * (16 + 4)
    flops = 8 * int(valid.sum()) * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def distinct_taps(lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Distinct taps of each roi's valid samples on one axis: [M, S] -> [M]."""
    big = torch.iinfo(lo.dtype).max
    srt = torch.cat([torch.where(valid, lo, big), torch.where(valid, hi, big)], 1).sort(1).values
    new = torch.ones_like(srt, dtype=torch.bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return (new & (srt != big)).sum(1)


def roi_align_footprint(ra, feats, rois, out_size) -> int:
    """Bytes the kernel moves through L2: each roi's own distinct taps
    (rows x columns) x C x element size, plus the output."""
    c, elem = feats[0].shape[-1], feats[0].element_size()
    grid = ra.sample_grid([f.shape[1:3] for f in feats], rois, ra.ROI_SCALES, out_size, 2)
    ny = distinct_taps(grid["y0"], grid["y1"], grid["my"])
    nx = distinct_taps(grid["x0"], grid["x1"], grid["mx"])
    m = rois.shape[0] * rois.shape[1]
    return int((ny * nx).sum()) * c * elem + m * out_size * out_size * c * elem


def phase_build(cuda_build) -> None:
    sources = sorted(p.name for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        results = list(pool.map(cuda_build.build, sources))
    for src, (path, secs, compiler_log) in zip(sources, results):
        log(f"build: {src} -> {path.name} in {secs:.1f} s")
        for line in compiler_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build: all kernels in {time.perf_counter() - t0:.1f} s")


def phase_kernels(ra, main_rois: dict) -> dict:
    """Kernel vs plain version at both pools, f32 and bf16, on synthetic
    rois and on the main path's own, at 256 channels (whole channel slices)
    and on the synthetic rois at 40 (a partial slice, and in f32 a partial
    one of 16-byte vectors). Returns the largest bf16 max abs error of each
    pool."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    pyramids = {c: pyramid(SC, c, gen, torch.float32) for c in (256, 40)}
    errs = {}
    for out_size, n in ((7, 1000), (14, 10)):
        syn = rois_for(SC, n, rng)
        for c, roi_set, rois in ((256, "synthetic", syn), (256, "main-path", main_rois[out_size]), (40, "synthetic", syn)):
            feats32 = pyramids[c]
            feats16 = [f.to(torch.bfloat16) for f in feats32]
            tag = f"pool{out_size} {roi_set} [{rois.shape[0]},{rois.shape[1]}] C={c}"
            got = ra.roi_align_cuda(feats32, rois, output_size=out_size)
            want = ra.multiscale_roi_align_plain(feats32, rois, output_size=out_size)
            torch.cuda.synchronize()
            err = (got - want).abs()
            # f32: same sample coordinates bit for bit, sums in another order.
            atol, rtol = 1e-5, 1e-5
            ok = bool((err <= atol + rtol * want.abs()).all())
            log(f"kernel {tag} f32: max abs err {err.max().item():.3e}, "
                f"max rel err {(err / want.abs().clamp(min=1e-3)).max().item():.3e} (tol atol {atol} + rtol {rtol})")
            check(ok, f"{tag} f32 kernel disagrees with the plain version")

            got = ra.roi_align_cuda(feats16, rois, output_size=out_size).float()
            want = ra.multiscale_roi_align_plain([f.float() for f in feats16], rois, output_size=out_size)
            torch.cuda.synchronize()
            err = (got - want).abs()
            # bf16 in, f32 accumulation, one rounding of the output to bf16.
            atol, rtol = 1e-5, 2.0**-8
            ok = bool((err <= atol + rtol * want.abs()).all())
            errs[out_size] = max(errs.get(out_size, 0.0), err.max().item())
            log(f"kernel {tag} bf16: max abs err {err.max().item():.3e}, "
                f"max rel err {(err / want.abs().clamp(min=1e-3)).max().item():.3e} "
                f"(tol atol {atol} + rtol 2^-8, vs the plain version in f32 on the same bf16 inputs)")
            check(ok, f"{tag} bf16 kernel disagrees with the plain version")
    return errs


@contextlib.contextmanager
def keeping_rois(module):
    """Within the block, `module.multiscale_roi_align` keeps the first rois
    it pools at each output size in the dict it yields."""
    kept, pool = {}, module.multiscale_roi_align

    def keep(feats, rois, *args, output_size, **kw):
        kept.setdefault(output_size, rois.detach().contiguous().clone())
        return pool(feats, rois, *args, output_size=output_size, **kw)

    module.multiscale_roi_align = keep
    try:
        yield kept
    finally:
        module.multiscale_roi_align = pool


@contextlib.contextmanager
def keeping_nms_inputs():
    """Within the block, the first candidates of each NMS call site are kept
    in the dict it yields, as (boxes, scores, valid, iou_threshold): "rpn"
    (`filter_proposals`' `nms_mask`) and "class_keyed"
    (`postprocess_detections`' `batched_nms_mask`, boxes offset by label)."""
    from slowfast_vos_tpu_torch.models import rpn
    from slowfast_vos_tpu_torch.ops import nms

    kept, nms_mask = {}, nms.nms_mask

    def keeper(site):
        def keep(boxes, scores, valid, **kw):
            kept.setdefault(site, (*(x.detach().clone() for x in (boxes, scores, valid)), kw["iou_threshold"]))
            return nms_mask(boxes, scores, valid, **kw)
        return keep

    rpn.nms_mask, nms.nms_mask = keeper("rpn"), keeper("class_keyed")
    try:
        yield kept
    finally:
        rpn.nms_mask = nms.nms_mask = nms_mask


def main_path_rois(pipeline_mod, pipe, clip) -> tuple[dict, dict]:
    """The rois of the first superchunk that `infer_sequence` pools: its
    proposals (7x7 pool) and its detection boxes (14x14 pool); and the
    candidates of its two NMS calls (`keeping_nms_inputs`)."""
    with keeping_rois(pipeline_mod) as kept, keeping_nms_inputs() as nms_inputs:
        pipe.infer_sequence(clip[:SC])
    return kept, nms_inputs


def check_detections(dets: list, frames: int, d: int) -> None:
    """`infer_sequence`'s contract at DAVIS 480x854: one dict per frame, D
    finite detections with boxes on the frame, a union mask per frame."""
    check(len(dets) == frames, f"{len(dets)} frames out")
    for det in dets:
        check(det["boxes"].shape == (d, 4) and det["scores"].shape == (d,), "detection shapes")
        check(det["union_mask"].shape == (480, 854), "union mask shape")
        check(np.isfinite(det["boxes"]).all() and np.isfinite(det["scores"]).all(), "non-finite detections")
        check(((det["boxes"] >= 0) & (det["boxes"] <= [854 + 1e-3, 480 + 1e-3] * 2)).all(), "boxes off the frame")


def phase_main(ra, pipeline_mod) -> tuple[dict, dict, dict]:
    pipe, model = pipeline_mod.build_pipeline(
        slow=3, fast=3, original_hw=(480, 854), dtype=torch.bfloat16, device="cuda", superchunk=SC
    )
    pipeline_mod.init_weights(model, seed=0)
    clip = np.random.default_rng(1).integers(0, 256, (20, 480, 854, 3), dtype=np.uint8)

    torch.cuda.reset_peak_memory_stats()
    ra.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = pipe.infer_sequence(clip)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {k: ra.launches[k] for k in INFER_KEYS}
    chunks = -(-20 // SC)
    log(f"main: infer_sequence 20 frames 480x854 3-3 bf16 superchunk {SC}: first run {first_s:.3f} s, "
        f"kernel launches pool7 {counts[7]}, pool14 {counts[14]}, nms {counts['nms']}, epilogue {counts['epilogue']}")
    check(counts[7] > 0 and counts[14] > 0, f"a RoIAlign pool bypassed the kernel: {counts}")
    check(counts["nms"] == 2 * chunks, f"NMS: 2 launches per superchunk expected over {chunks}: {counts}")
    check(counts["epilogue"] == K8_PER_BACKBONE * chunks,
          f"K8: {K8_PER_BACKBONE} launches per superchunk expected over {chunks}: {counts}")

    check_detections(dets, 20, pipe.cfg.detections_per_img)
    n_valid = sum(int(det["valid"].sum()) for det in dets)
    log(f"main: {n_valid} valid detections over 20 frames, mask pixels on {np.mean([det['union_mask'].mean() for det in dets]):.4f}")
    peak = torch.cuda.max_memory_allocated()

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.infer_sequence(clip)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    fps = 20 / statistics.median(runs)
    log(f"main: warm runs {', '.join(f'{r:.3f}' for r in runs)} s -> {fps:.2f} frames/s (median); "
        f"peak device memory {peak / 2**30:.2f} GiB")
    # A replay calls no Python wrapper: the rois are kept on the eager path, same model.
    eager = pipeline_mod.Pipeline(model, pipe.transform, superchunk=SC, graphs=False)
    rois, nms_inputs = main_path_rois(pipeline_mod, eager, clip)
    log(f"main: kept one superchunk's rois: proposals {tuple(rois[7].shape)}, detections {tuple(rois[14].shape)}; "
        f"NMS candidates: rpn {tuple(nms_inputs['rpn'][0].shape)}, class-keyed {tuple(nms_inputs['class_keyed'][0].shape)}")
    return counts, rois, nms_inputs


def phase_reference(pipeline_mod) -> None:
    """A small f32 input through `forward_superchunk` on the card and on the
    CPU (plain versions, no kernel), same seeded weights. Tolerances as in
    tests/test_torch_pipeline.py: valid flags and labels exact, boxes within
    0.05 px, scores within 1e-4, at most 1% of union-mask pixels differ."""
    outs = []
    images = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (6, 120, 200, 3), dtype=np.uint8))
    for device in ("cuda", "cpu"):
        pipe, model = pipeline_mod.build_pipeline(
            3, 3, (120, 200), min_size=128, max_size=256, dtype=torch.float32, device=device, superchunk=4
        )
        pipeline_mod.init_weights(model, seed=0)
        out = pipe.forward_superchunk(images, torch.ones(6, dtype=torch.bool))
        outs.append([o.cpu().numpy() for o in out])
    (gb, gs, gl, gv, gm), (cb, cs, cl, cv, cm) = outs
    box_err, score_err = np.abs(gb - cb).max(), np.abs(gs - cs).max()
    mask_diff = (np.unpackbits(gm, axis=-1, count=200) != np.unpackbits(cm, axis=-1, count=200)).mean()
    log(f"reference: card vs CPU at 120x200 f32: valid equal {np.array_equal(gv, cv)}, labels equal "
        f"{np.array_equal(gl, cl)}, box err {box_err:.3e} px, score err {score_err:.3e}, mask pixels differing {mask_diff:.4f}")
    check(np.array_equal(gv, cv) and np.array_equal(gl, cl), "valid flags or labels differ from the CPU")
    check(box_err <= 0.05 and score_err <= 1e-4 and mask_diff <= 0.01, "card output differs from the CPU")


def training_window(data, hw, frames, max_gt, index, fast=3, n_center=2):
    """Window `index` of `train_windows` over a seeded moving-blobs sequence
    (2 objects, masks and boxes per frame)."""
    images, ids = data.draw_sequence(np.random.default_rng(7), frames, *hw, 2)
    windows = list(data.train_windows(data.sequence_arrays(images, ids, max_gt), fast=fast, n_center=n_center))
    return windows[index], images


def full_width_trainer(pipeline_mod, train_mod, data):
    """Phase 3's set-up: the full-width bf16 model with seeded weights, its
    `Trainer` and one window. Returns (pipe, model, trainer, batch, clip)."""
    pipe, model = pipeline_mod.build_pipeline(
        slow=3, fast=3, original_hw=(480, 854), dtype=torch.bfloat16, device="cuda", superchunk=SC
    )
    pipeline_mod.init_weights(model, seed=0)
    trainer = train_mod.Trainer(pipe, seed=0)
    batch, clip = training_window(data, (480, 854), 8, pipe.cfg.max_gt, index=1)
    return pipe, model, trainer, batch, clip


def train_path_rois(pipeline_mod, train_mod, data) -> dict:
    """The rois that the first train step of phase 3's set-up pools."""
    *_, trainer, batch, _ = full_width_trainer(pipeline_mod, train_mod, data)
    with keeping_rois(train_mod.train_step) as kept:
        trainer.step(batch)
    return kept


def phase_train(ra, pipeline_mod, train_mod, data) -> tuple[dict, dict, dict]:
    """8 full-width train steps on the card's default path (the first eager
    and captured, the others CUDA graph replays); returns (launch counts of
    those steps, the first step's sampled rois by output size, its RPN NMS
    candidates)."""
    pipe, model, trainer, batch, clip = full_width_trainer(pipeline_mod, train_mod, data)
    check(trainer.graphs is not None, "train: the step does not run on CUDA graphs by default on the card")
    log(f"train: window of {batch['images'].shape[0]} frames 480x854, {int(batch['gt_valid'].sum())} gt boxes, "
        f"feat_valid {batch['feat_valid'].tolist()}")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    keys = LAUNCH_KEYS
    per_step, times = [], []
    with keeping_rois(train_mod.train_step) as kept, keeping_nms_inputs() as nms_inputs:
        torch.cuda.reset_peak_memory_stats()
        ra.launches.clear()
        for i in range(TRAIN_STEPS):
            seen = {k: ra.launches[k] for k in keys}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: ra.launches[k] - seen[k] for k in keys})
            values = {k: float(v) for k, v in metrics.items()}
            check(all(np.isfinite(v) for v in values.values()), f"step {i}: non-finite loss {values}")
            log(f"train: step {i} {times[-1]:.1f} ms " + " ".join(f"{k} {v:.4f}" for k, v in values.items()))
        counts = {k: ra.launches[k] for k in keys}
    peak = torch.cuda.max_memory_allocated()
    log(f"train: launches over {TRAIN_STEPS} steps: {launch_text(counts)}")
    for i, c in enumerate(per_step):
        check(all(v >= 1 for v in c.values()), f"step {i} bypassed a kernel: {c}")
        check(all(c[k] == BN_PER_STEP for k in BN_KEYS), f"step {i}: {BN_PER_STEP} launches of K6 each way expected: {c}")
    step_ms = statistics.median(times[1:])
    check(trainer.graphs.captures == 2, f"train: {trainer.graphs.captures} step graphs captured, 2 expected")
    log(f"train: {step_ms:.2f} ms/step (median of steps 2-{TRAIN_STEPS}, graph replays, synchronized), "
        f"peak device memory {peak / 2**30:.2f} GiB")

    after = model.state_dict()
    frozen = [k for k in after if k.startswith(("backbone.", "rpn."))]
    check(all(torch.equal(after[k], before[k]) for k in frozen), "a frozen weight or FrozenBatchNorm buffer changed")
    weights = [k for k in trainer.params if trainer.params[k].dim() > 1]
    moved = [k for k in trainer.params if not torch.equal(after[k], before[k])]
    check(set(weights) <= set(moved), f"trainable weights that did not move: {sorted(set(weights) - set(moved))}")
    stats = [k for k in after if k.startswith("slow_fast.") and "running" in k]
    check(all(not torch.equal(after[k], before[k]) for k in stats), "a SlowFast running statistic did not move")
    log(f"train: {len(moved)} of {len(trainer.params)} trainable tensors moved (every weight), "
        f"{len(frozen)} frozen tensors bit-identical, {len(stats)} SlowFast running statistics moved")

    dets = pipe.infer_sequence(clip)
    check(len(dets) == len(clip) and all(np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"]).all() for d in dets),
          "infer_sequence after training gave non-finite detections")
    log(f"train: infer_sequence on the trained model, {len(dets)} frames, "
        f"{sum(int(d['valid'].sum()) for d in dets)} valid detections")
    log(f"train: kept the first step's rois: pool7 {tuple(kept[7].shape)}, pool14 {tuple(kept[14].shape)}; "
        f"RPN NMS candidates {tuple(nms_inputs['rpn'][0].shape)}")
    return {"counts": counts, "step_ms": step_ms, "step_times_ms": times, "peak_gib": peak / 2**30}, kept, nms_inputs


def phase_backward_kernels(ra, train_rois: dict) -> dict:
    """The backward kernel against the plain backward on the train path's
    rois and on synthetic ones, f32 (TF32 off) and bf16, per pixel within
    1e-6 + rtol * B, B the plain backward of |g| (the sum of the
    contributions' magnitudes: the kernel adds them in a fixed order, but
    not in the plain version's); on the train path's rois, a second call
    must give the same bits. Returns the largest bf16 max abs error of each
    pool."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(5)
    errs = {}
    for out_size, n in ((7, 512), (14, 128)):
        for roi_set, rois in (("synthetic", rois_for(2, n, rng)), ("train-path", train_rois[out_size])):
            g32 = torch.randn((*rois.shape[:2], out_size, out_size, 256), generator=gen, device="cuda")
            for dtype, rtol, name in ((torch.float32, 1e-5, "f32"), (torch.bfloat16, 2.0**-8, "bf16")):
                gd = g32.to(dtype)
                got = ra.roi_align_backward_cuda(gd, rois, LEVEL_HWS, output_size=out_size)
                want = ra.multiscale_roi_align_backward_plain(gd.float(), rois, LEVEL_HWS, output_size=out_size)
                bound = ra.multiscale_roi_align_backward_plain(gd.float().abs(), rois, LEVEL_HWS, output_size=out_size)
                torch.cuda.synchronize()
                err = max(float((a.float() - b).abs().max()) for a, b in zip(got, want))
                worst = max(float(((a.float() - b).abs() / (1e-6 + rtol * c)).max()) for a, b, c in zip(got, want, bound))
                if dtype == torch.bfloat16:
                    errs[out_size] = max(errs.get(out_size, 0.0), err)
                log(f"kernel backward pool{out_size} {roi_set} {list(rois.shape[:2])} C=256 {name}: max abs err "
                    f"{err:.3e}, largest share of the per-pixel tolerance {worst:.3f} (1e-6 + {rtol:.3g} B)")
                check(worst <= 1.0, f"backward pool{out_size} {roi_set} {name} disagrees with the plain backward")
                if roi_set == "train-path":
                    again = ra.roi_align_backward_cuda(gd, rois, LEVEL_HWS, output_size=out_size)
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    log(f"kernel backward pool{out_size} train-path {name}: two calls bitwise equal {same}")
                    check(same, f"backward pool{out_size} {name}: two calls on the same inputs differ")
    return errs


# K3 (`ops/nms.py::nms_cuda`). An IoU test is 14 f32 operations (4 min/max,
# 2 differences, 2 clamps, the product, the union's sum and difference, its
# test, the division, the threshold test: `csrc/nms.cu`'s head note).
NMS_OPS_PER_PAIR = 14
# Its shapes on the main path, synthetic: (name, leading dims, N, threshold,
# class-keyed through `batched_nms_mask`).
NMS_SHAPES = (
    ("rpn inference", (SC, 5), 1000, 0.7, False),  # filter_proposals, superchunk 8
    ("rpn train", (2, 5), 2000, 0.7, False),  # filter_proposals in a train step
    ("class-keyed", (SC,), 1000, 0.5, True),  # postprocess_detections, 2 classes
    ("large head", (1,), 8192, 0.5, False),  # phase 10's case: a head of 9+ classes
)


def nms_case(rng, lead, n, thr, keyed, canvas=CANVAS, quantum=8.0, sizes=(8, 300)):
    """NMS candidates on the card: quantized boxes on the canvas [*lead, n,
    4], scores in steps of 1/16 (duplicate boxes, equal scores, IoUs exactly
    at a threshold), 10% of the flags invalid. `keyed`: labels 1 or 2 and
    the boxes offset as `batched_nms_mask` offsets them (captured from its
    call). Returns (boxes, scores, valid, thr), `nms_mask`'s inputs."""
    from slowfast_vos_tpu_torch.ops import nms

    xy = rng.uniform(0, [canvas[1], canvas[0]], (*lead, n, 2))
    boxes = np.round(np.concatenate([xy, xy + rng.uniform(*sizes, (*lead, n, 2))], -1) / quantum) * quantum
    args = [torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy((np.round(rng.uniform(0, 1, (*lead, n)) * 16) / 16).astype(np.float32)).cuda(),
            torch.from_numpy(rng.uniform(size=(*lead, n)) > 0.1).cuda()]
    if not keyed:
        return (*args, thr)
    labels = torch.from_numpy(rng.integers(1, 3, (*lead, n)).astype(np.int32)).cuda()
    with keeping_nms_inputs() as kept:
        nms.batched_nms_mask(args[0], args[1], labels, args[2], iou_threshold=thr)
    return kept["class_keyed"]


def nms_edge_cases(rng):
    """[4, 130] problems in one call: all invalid; half invalid; zero-area
    and zero-width boxes (union 0 or no intersection); identical boxes."""
    boxes, scores, valid, _ = nms_case(rng, (4,), 130, 0.5, False, canvas=(200, 200), quantum=4.0, sizes=(4, 60))
    valid[0] = False
    valid[1, ::2] = False
    boxes[2, ::2, 2:] = boxes[2, ::2, :2]
    boxes[2, 1::2, 2] = boxes[2, 1::2, 0]
    boxes[3] = torch.tensor([10.0, 10.0, 50.0, 50.0])
    return boxes, scores, valid, 0.5


def phase_nms_kernel(nms, main_nms: dict, train_nms: dict) -> float:
    """K3 (`nms_mask`'s "auto" on the card) against the plain fixpoint on
    the card, keep and order index for index, one launch per call, and
    bitwise equal over two calls: on phase 2's own candidates (RPN and
    class-keyed) and phase 3's (RPN), at the main path's shapes on
    quantized boxes and scores, at N = 1, 63, 64, 65, 127, 128, 129, at
    the route boundary (the last N whose bitmask stays in shared memory and
    the next) and on edge cases.
    Then the K3 path under the sync debug mode "error", which raises on a
    synchronizing call. Returns the largest |keep - fixpoint keep| (0)."""
    rng = np.random.default_rng(30)
    cases = [("main-path rpn", main_nms["rpn"]), ("main-path class-keyed", main_nms["class_keyed"]),
             ("train-path rpn", train_nms["rpn"])]
    cases += [(f"synthetic {name}", nms_case(rng, lead, n, thr, keyed)) for name, lead, n, thr, keyed in NMS_SHAPES]
    cases += [(f"synthetic N={n}", nms_case(rng, (3,), n, 0.5, False)) for n in (1, 63, 64, 65, 127, 128, 129)]
    edge_n = nms.SHARED_ROUTE_MAX_N
    cases += [(f"route boundary N={n}", nms_case(rng, (2,), n, 0.5, False)) for n in (edge_n, edge_n + 1)]
    cases.append(("edge cases", nms_edge_cases(rng)))
    err = 0
    for tag, (boxes, scores, valid, thr) in cases:
        before = nms.launches["nms"]
        keep, order = nms.nms_mask(boxes, scores, valid, iou_threshold=thr)
        launched = nms.launches["nms"] - before
        again = nms.nms_mask(boxes, scores, valid, iou_threshold=thr)
        want = nms.nms_mask(boxes, scores, valid, iou_threshold=thr, algorithm="fixpoint")
        torch.cuda.synchronize()
        err = max(err, int((keep.int() - want[0].int()).abs().max()))
        exact = torch.equal(keep, want[0]) and torch.equal(order, want[1])
        repeat = torch.equal(keep, again[0]) and torch.equal(order, again[1])
        n = valid.shape[-1]
        log(f"kernel nms {tag} {list(valid.shape)} thr {thr} ({nms.route(n)} route, cluster of "
            f"{nms.cluster_size(n)}): {int(keep.sum())} of {int(valid.sum())} valid kept, index-exact with the "
            f"fixpoint {exact}, two calls bitwise equal {repeat}, {launched} launch")
        check(exact and repeat and launched == 1, f"nms {tag}: the kernel disagrees with the fixpoint or itself")
    boxes, scores, valid, thr = main_nms["rpn"]
    kboxes, kscores, kvalid, kthr = main_nms["class_keyed"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nms.nms_mask(boxes, scores, valid, iou_threshold=thr)
        nms.nms_mask(kboxes, kscores, kvalid, iou_threshold=kthr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("kernel nms: the main path's two calls (effective scores, sort, kernel) ran under sync debug mode "
        "\"error\": no host synchronize")
    return float(err)


@contextlib.contextmanager
def relu_branches(masks: list, replay: bool):
    """Record every ReLU's branch (input > 0) in call order, or replay
    recorded branches (output = input * branch): a ReLU whose input lies
    within the two devices' f32 drift of zero then takes the same side in
    both runs, and the gradients are comparable. The ReLUs K6 fuses into
    SlowFast's train-mode BatchNorm (`batch_norm_train_fused(relu=True)`)
    count too: recorded from the fused output (> 0 exactly where the BN's
    output is), replayed by the unfused BN times the branch."""
    from slowfast_vos_tpu_torch.ops import batch_norm as fused_bn

    functional = torch.nn.functional
    orig, orig_bn = functional.relu, fused_bn.batch_norm_train_fused
    it = iter(masks)

    def relu(x, inplace=False):
        if replay:
            return x * next(it).to(x.device)
        masks.append((x > 0).cpu())
        return orig(x)

    def bn_relu(x, bn, relu=False, momentum=0.9):
        if not relu:
            return orig_bn(x, bn, False, momentum)
        if replay:
            return orig_bn(x, bn, False, momentum) * next(it).to(x.device)
        y = orig_bn(x, bn, True, momentum)
        masks.append((y > 0).cpu())
        return y

    functional.relu, fused_bn.batch_norm_train_fused = relu, bn_relu
    try:
        yield
    finally:
        functional.relu, fused_bn.batch_norm_train_fused = orig, orig_bn
    check(not replay or next(it, None) is None, "the replayed step called ReLU fewer times than the recorded one")


# Phase 5's tiny train steps: (name, build_pipeline arguments, Trainer
# arguments).
TRAIN_REFERENCES = (
    ("default 3-3", dict(slow=3, fast=3), dict()),
    ("OSVOS SF 3-3 (backbone trains, SlowFast frozen, 1 centre frame)", dict(slow=3, fast=3),
     dict(n_center=1, train_backbone=True, train_slow_fast=False)),
    ("pretrain Mask R-CNN (no SlowFast, fast 1, trainable_backbone_layers 3)", dict(slow=1, fast=1, use_slow_fast=False),
     dict(train_backbone=True, trainable_backbone_layers=3)),
)


def phase_train_reference(pipeline_mod, train_mod, data, cfg_mod) -> None:
    """Tiny f32 train steps (tests/test_torch_train.py's shape: 60x100, min
    64, max 128, TINY_CFG) on the card (kernels) and on the CPU (plain
    versions), same seeded weights and draws; the CPU step replays the card
    step's ReLU branches. One step per set-up of `TRAIN_REFERENCES`: the
    default freeze, OSVOS's `SF` (the backbone trains) and the pretrain
    model. Losses to rel 1e-4, every trainable gradient to max-abs 1e-3 x
    its max |grad| (conv biases before a train-mode BatchNorm, whose
    gradient is zero, to 1e-5 of the SlowFast gradients)."""
    cfg = cfg_mod.DetectionConfig(
        rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32, rpn_pre_nms_top_n_test=64,
        rpn_post_nms_top_n_test=32, box_batch_size_per_image=32, mask_train_rois=8, detections_per_img=5, max_gt=3,
    )
    for name, build_kw, trainer_kw in TRAIN_REFERENCES:
        n = trainer_kw.get("n_center", 2)
        batch, _ = training_window(data, (60, 100), 6, cfg.max_gt, index=0, fast=build_kw["fast"], n_center=n)
        masks, out = [], {}
        for run, device in enumerate(("cuda", "cpu")):
            pipe, model = pipeline_mod.build_pipeline(
                original_hw=(60, 100), min_size=64, max_size=128, cfg=cfg, dtype=torch.float32, device=device,
                superchunk=4, **build_kw,
            )
            pipeline_mod.init_weights(model, seed=0)
            trainer = train_mod.Trainer(pipe, **trainer_kw)
            if run == 0:  # the samplers' draws, made once on the CPU
                gen = torch.Generator().manual_seed(0)
                a, b = trainer.num_anchors, cfg.rpn_post_nms_top_n_train + cfg.max_gt
                draws = {k: torch.rand((n, m), generator=gen) for k, m in
                         (("rpn_pos", a), ("rpn_neg", a), ("box_pos", b), ("box_neg", b))}
            model.train()
            with relu_branches(masks, replay=run == 1):
                total, metrics = trainer.loss(batch, {k: v.to(device) for k, v in draws.items()})
                total.backward()
            model.eval()
            out[run] = ({k: float(v) for k, v in metrics.items()}, {k: p.grad.cpu() for k, p in trainer.params.items()})
        (gm, gg), (cm, cg) = out[0], out[1]
        loss_err = max(abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-12) for k in cm)
        sf = [float(v.abs().max()) for k, v in cg.items() if k.startswith("slow_fast.")]
        share, zero_share = 0.0, 0.0
        for k in cg:
            diff = float((gg[k] - cg[k]).abs().max())
            if k.startswith("slow_fast.") and "conv" in k and k.endswith(".bias"):
                zero_share = max(zero_share, max(float(gg[k].abs().max()), float(cg[k].abs().max())) / (1e-5 * max(sf)))
            else:
                share = max(share, diff / max(GRAD_SHARE * float(cg[k].abs().max()), 1e-30))
        log(f"reference: tiny f32 train step, {name}, card vs CPU: losses max rel err {loss_err:.3e} (tol 1e-4), "
            f"{len(cg)} trainable tensors, gradients at {share:.3f} of their tolerance, zero-gradient biases at "
            f"{zero_share:.3f}; {len(masks)} ReLU calls replayed; loss {gm['loss']:.6f} (card) {cm['loss']:.6f} (CPU)")
        check(loss_err <= 1e-4 and share <= 1.0 and zero_share <= 1.0, f"the card's train step ({name}) differs from the CPU's")


@contextlib.contextmanager
def timed_steps(train_mod):
    """Within the block, every `Trainer.step` is synchronized and timed; the
    list it yields gets each step's milliseconds."""
    times, step = [], train_mod.Trainer.step

    def timed(self, batch, draws=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(self, batch, draws)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    train_mod.Trainer.step = timed
    try:
        yield times
    finally:
        train_mod.Trainer.step = step


def launch_text(c: dict) -> str:
    """A launch-count dict (keys as in LAUNCH_KEYS or their str()) as text."""
    get = lambda k: c[k] if k in c else c[str(k)]  # noqa: E731
    return (f"pool7 {get(7)}, pool14 {get(14)}, backward pool7 {get(('backward', 7))}, backward pool14 "
            f"{get(('backward', 14))}, nms {get('nms')}, bn {get('bn')}, backward bn {get(('backward', 'bn'))}")


@contextlib.contextmanager
def launches_of(ra, counts: dict, name: str, required=LAUNCH_KEYS, tag: str = "drivers"):
    """Launch counts of K1 and K5 at both pools, K3 and K6 over the block,
    kept under `name`; those of `required` checked above zero."""
    ra.launches.clear()
    yield
    counts[name] = {k: ra.launches[k] for k in LAUNCH_KEYS}
    log(f"{tag}: {name}: launches {launch_text(counts[name])}")
    check(all(counts[name][k] > 0 for k in required), f"{name} bypassed a kernel: {counts[name]}")


def phase_drivers(ra, pipeline_mod, train_mod, data, workdir: Path) -> dict:
    """The three drivers at full width (480x854, bf16, default
    DetectionConfig, seeded weights) on synthetic DAVIS trees: unsupervised
    training with its evaluation each epoch and a resume, an OSVOS
    fine-tune under `SF`, the Mask R-CNN fine-tune and its proposal dump.
    Returns the launch counts and timings."""
    from slowfast_vos_tpu_torch.data.davis import DavisIndex, load_sequence
    from slowfast_vos_tpu_torch.eval import glue, scorer
    from slowfast_vos_tpu_torch.train import osvos, pretrain, trainer as unsupervised
    from slowfast_vos_tpu_torch.utils import checkpoint

    hw = DRIVER_HW
    train_root, eval_root = str(workdir / "train17"), str(workdir / "eval16")
    t0 = time.perf_counter()
    data.make_synthetic_davis(train_root, num_sequences=2, frames=8, hw=hw, num_objects=2)
    data.make_synthetic_davis(eval_root, num_sequences=1, frames=16, hw=hw, num_objects=1, year="2016", subset="val", seed=7)
    log(f"drivers: wrote a 2017 train tree (2 x 8 frames, 2 objects) and a 2016 val tree (1 x 16 frames) at {hw} "
        f"in {time.perf_counter() - t0:.1f} s")
    out, counts = {}, {}
    pipe, model = pipeline_mod.build_pipeline(3, 3, hw, dtype=torch.bfloat16, device="cuda", superchunk=SC)
    torch.cuda.reset_peak_memory_stats()

    # Unsupervised training, 2 epochs of 3 windows, evaluated before and after each.
    run_dir = str(workdir / "unsupervised")
    with launches_of(ra, counts, "train_unsupervised"), timed_steps(train_mod) as step_ms:
        t0 = time.perf_counter()
        trainer, history = unsupervised.train_unsupervised(
            pipe, train_root=train_root, eval_root=eval_root, output_dir=run_dir, epochs=2, max_windows_per_epoch=3, seed=0,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check([h["epoch"] for h in history] == [0, 1], f"history epochs {[h['epoch'] for h in history]}")
    for h in history:
        check(sorted(h) == ["epoch", "eval", "loss"] and np.isfinite(h["loss"]), f"history entry {h}")
        check(sorted(h["eval"]) == sorted(["jf", "wall", "J&F-Mean", "J-Mean", "J-Recall", "J-Decay", "F-Mean",
                                           "F-Recall", "F-Decay"]) and 0.0 <= h["eval"]["jf"] <= 1.0, f"eval {h['eval']}")
    res = Path(run_dir) / "results" / "unsupervised" / "slowfast_3-3" / "synth00"
    check(sorted(p.name for p in res.iterdir()) == [f"{i:05d}.png" for i in range(16)], "the results tree lacks a frame")
    out["unsupervised"] = {"wall_s": wall, "steps": len(step_ms), "median_step_ms": statistics.median(step_ms[1:])}
    log(f"drivers: train_unsupervised 2 epochs x 3 windows + 3 evaluations: {wall:.2f} s wall, {len(step_ms)} steps, "
        f"median {out['unsupervised']['median_step_ms']:.1f} ms/step (steps {', '.join(f'{t:.0f}' for t in step_ms)} ms); "
        f"losses {[round(h['loss'], 4) for h in history]}, J&F {[round(h['eval']['jf'], 4) for h in history]}")

    with timed_steps(train_mod) as resume_ms:
        trainer, resumed = unsupervised.train_unsupervised(
            pipe, train_root=train_root, eval_root=eval_root, output_dir=run_dir, epochs=3, max_windows_per_epoch=3,
            seed=0, continue_training=True,
        )
    check([h["epoch"] for h in resumed] == [2] and len(resume_ms) == 3, f"resume ran epochs {[h['epoch'] for h in resumed]}")
    fresh_pipe, _ = pipeline_mod.build_pipeline(3, 3, hw, dtype=torch.bfloat16, device="cuda", superchunk=SC)
    fresh = train_mod.Trainer(fresh_pipe)
    meta = checkpoint.restore_checkpoint(str(Path(run_dir) / "ckpt_last.pt"), fresh)
    same = all(torch.equal(v, w) for v, w in zip(trainer.model.state_dict().values(), fresh.model.state_dict().values()))
    same &= all(torch.equal(trainer.optimizer.state[p]["momentum_buffer"], fresh.optimizer.state[fresh.params[k]]["momentum_buffer"])
                for k, p in trainer.params.items())
    check(same and meta == {"epoch": 2} and fresh.calls == 9, "ckpt_last does not restore bit for bit")
    log(f"drivers: continue_training ran epoch 2 only ({len(resume_ms)} steps); ckpt_last restores weights and "
        f"{len(trainer.params)} momentum buffers bit for bit, meta {meta}")
    del fresh, fresh_pipe

    # Evaluation frames/s: inference alone, and with PNG writing and scoring.
    info = DavisIndex(eval_root, "val", year="2016").sequences[0]
    images = load_sequence(info)["images"]
    infer_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = pipe.infer_sequence(images)
        infer_s.append(time.perf_counter() - t0)
    eval_s = []
    for _ in range(3):
        jf, *_, wall = glue.davis_evaluation(pipe, davis_root=eval_root, results_root=str(workdir / "eval"), model_name="m", year="2016")
        eval_s.append(wall)
    out["evaluation"] = {"frames": len(images), "infer_fps": len(images) / statistics.median(infer_s),
                         "eval_fps": len(images) / statistics.median(eval_s)}
    log(f"drivers: evaluation of 16 frames at {hw}: infer_sequence {out['evaluation']['infer_fps']:.2f} frames/s, "
        f"with PNG writing and scoring (davis_evaluation) {out['evaluation']['eval_fps']:.2f} frames/s (medians of 3)")

    # Ground truth as prediction scores J&F 1.0.
    gt_dets = [{"union_mask": np.array(m.any(0))} for m in load_sequence(info)["masks"]]
    glue._write_sequence_masks(str(workdir / "gt"), info.name, gt_dets, "2016", 0.5, None)
    summary = scorer.summarize(scorer.DavisScorer(eval_root, task="unsupervised", gt_set="val", year="2016").evaluate(str(workdir / "gt")))
    check(summary["J&F-Mean"] == 1.0, f"ground truth as prediction scores {summary}")
    log(f"drivers: ground truth as prediction scores J&F {summary['J&F-Mean']}")

    # OSVOS under SF from the trained weights, 4 items (2 optimizer steps).
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with launches_of(ra, counts, "train_osvos_sequence"), timed_steps(train_mod) as step_ms:
        t0 = time.perf_counter()
        results = osvos.train_osvos_sequence(
            pipe, start, davis_root=eval_root, sequence_name="synth00", results_root=str(workdir / "osvos"),
            cfg=osvos.ExperimentConfig(freeze="SF", epochs=1), items_per_epoch=4,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(sorted(results) == [-1, 0] and all(sorted(r) == ["eval_time", "fmean", "jfmean", "jmean"] for r in results.values()),
          f"OSVOS results {results}")
    after = model.state_dict()
    params = dict(model.named_parameters())
    check(all(torch.equal(after[k], start[k]) for k in params if k.startswith("slow_fast.")), "SF moved a SlowFast weight")
    check(not torch.equal(after["backbone.body.layer4.2.conv3.weight"], start["backbone.body.layer4.2.conv3.weight"]),
          "SF left the backbone unchanged")
    out["osvos"] = {"wall_s": wall, "steps": len(step_ms), "median_step_ms": statistics.median(step_ms)}
    log(f"drivers: train_osvos_sequence SF, 4 items (2 updates) + 2 evaluations: {wall:.2f} s wall, median "
        f"{out['osvos']['median_step_ms']:.1f} ms/step (steps {', '.join(f'{t:.0f}' for t in step_ms)} ms); "
        f"J&F {results[-1]['jfmean']:.4f} -> {results[0]['jfmean']:.4f}; SlowFast weights bit-identical, backbone moved")
    del start, trainer, pipe, model

    # The Mask R-CNN fine-tune, 3 steps of 2 frames, and its proposal dump.
    ppipe, pmodel = pretrain.build_maskrcnn_pipeline(hw, dtype=torch.bfloat16, device="cuda", superchunk=SC)
    pipeline_mod.init_weights(pmodel, seed=0)
    start = {k: v.detach().clone() for k, v in pmodel.state_dict().items()}
    with launches_of(ra, counts, "train_maskrcnn", NO_SLOWFAST_KEYS), timed_steps(train_mod) as step_ms:
        t0 = time.perf_counter()
        _, history = pretrain.train_maskrcnn(
            ppipe, davis_root=train_root, output_dir=str(workdir / "pretrain"), epochs=1, max_steps_per_epoch=3,
            batch_size=2, state_dict=start,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(len(history) == 1 and sorted(history[0]) == ["epoch", "loss"] and np.isfinite(history[0]["loss"]), f"pretrain {history}")
    after = pmodel.state_dict()
    frozen = [k for k in after if k.startswith(("backbone.body.conv1.", "backbone.body.layer1."))]
    check(all(torch.equal(after[k], start[k]) for k in frozen), "pretrain moved conv1 or layer1")
    check(not torch.equal(after["backbone.body.layer2.0.conv1.weight"], start["backbone.body.layer2.0.conv1.weight"]),
          "pretrain left layer2 unchanged")
    out["pretrain"] = {"wall_s": wall, "steps": len(step_ms), "median_step_ms": statistics.median(step_ms)}
    log(f"drivers: train_maskrcnn 3 steps x 2 frames: {wall:.2f} s wall, median {out['pretrain']['median_step_ms']:.1f} "
        f"ms/step (steps {', '.join(f'{t:.0f}' for t in step_ms)} ms), loss {history[0]['loss']:.4f}; "
        f"conv1 and layer1 bit-identical")
    t0 = time.perf_counter()
    npz = np.load(pretrain.extract_rpn_proposals(ppipe, davis_root=eval_root, output_path=str(workdir / "props.npz"),
                                                 subset="val", year="2016"))
    props, valid = npz["synth00/proposals"], npz["synth00/valid"]
    n_props = ppipe.cfg.rpn_post_nms_top_n_test
    check(props.shape == (16, n_props, 4) and valid.shape == (16, n_props) and np.isfinite(props).all(), "proposal dump")
    log(f"drivers: extract_rpn_proposals 16 frames in {time.perf_counter() - t0:.2f} s, {int(valid.sum())} valid proposals")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"drivers: peak device memory {out['peak_gib']:.2f} GiB")
    out["counts"] = counts
    return out


def phase_cli(ra, data, workdir: Path) -> dict:
    """The CLIs (`scripts/torch_*.py`) as the reference's chain, in-process
    through `main(argv)` at full width (480x854, bf16, default
    DetectionConfig, superchunk 32) on synthetic DAVIS trees: the Mask R-CNN
    fine-tune and its proposal dump, unsupervised training from that
    checkpoint, evaluation, extraction and the standalone scorer, OSVOS,
    the overlay dump, a reference-layout `.pth` of the trained weights
    through the evaluation, one real subprocess, and the benchmark. Returns
    each CLI's wall seconds and launch counts, and the benchmark's
    records."""
    from scripts import (
        torch_bench, torch_evaluate, torch_extract_for_davis_eval, torch_predict, torch_pretrain_maskrcnn,
        torch_score, torch_train, torch_train_osvos,
    )
    from slowfast_vos_tpu_torch.train import osvos
    from slowfast_vos_tpu_torch.utils import checkpoint

    train_root, eval_root = str(workdir / "train17"), str(workdir / "eval16")
    data.make_synthetic_davis(train_root, num_sequences=2, frames=8, hw=DRIVER_HW, num_objects=2)
    data.make_synthetic_davis(eval_root, num_sequences=1, frames=16, hw=DRIVER_HW, num_objects=1, year="2016",
                              subset="val", seed=7)
    counts, walls = {}, {}
    forward = FORWARD_KEYS

    def run(name, cli, argv, required=LAUNCH_KEYS):
        with launches_of(ra, counts, name, required, tag="cli"):
            t0 = time.perf_counter()
            result = cli.main(argv)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        log(f"cli: {name}: {walls[name]:.2f} s wall")
        return result

    pre, run_dir = str(workdir / "pre"), str(workdir / "unsupervised")
    ckpt = str(Path(pre) / "maskrcnn_model.pt")
    out = run("pretrain", torch_pretrain_maskrcnn, ["--davis-root", train_root, "--output", pre, "--epochs", "1"],
              NO_SLOWFAST_KEYS)
    check(len(out["history"]) == 1 and np.isfinite(out["history"][0]["loss"]), f"pretrain history {out['history']}")
    # The proposal dump runs the backbone and the RPN only: NMS, no RoIAlign.
    out = run("pretrain --predict-boxes", torch_pretrain_maskrcnn,
              ["--davis-root", train_root, "--output", pre, "--predict-boxes", "--init-checkpoint", ckpt],
              required=("nms",))
    props = np.load(out["proposals"])["synth00/proposals"]
    check(props.shape == (8, 1000, 4) and np.isfinite(props).all(), f"proposal dump {props.shape}")

    out = run("train", torch_train, ["--train-root", train_root, "--eval-root", eval_root, "--output", run_dir,
                                      "--epochs", "1", "--init-checkpoint", ckpt])
    report, history = out["load"], out["history"]
    model_keys = checkpoint.load_checkpoint(str(Path(run_dir) / "ckpt_last.pt"))["model"]
    sf = [k for k in model_keys if k.startswith("slow_fast.") and "num_batches_tracked" not in k]
    check(report["unused_source_keys"] == [] and report["untouched"] == sf
          and report["converted"] == len([k for k in model_keys if not k.startswith("slow_fast.")]),
          f"the Mask R-CNN checkpoint did not load as F2 asks: {report['converted']} converted, "
          f"unused {report['unused_source_keys'][:5]}, untouched {report['untouched'][:5]}")
    check(len(history) == 1 and np.isfinite(history[0]["loss"]) and history[0]["eval"] is not None, f"train {history}")
    log(f"cli: train from the Mask R-CNN checkpoint: {report['converted']} tensors converted, 0 unused, "
        f"{len(sf)} slow_fast.* tensors untouched; loss {history[0]['loss']:.4f}, J&F {history[0]['eval']['jf']:.4f}")

    best = str(Path(run_dir) / "ckpt_best.pt")
    common = ["--davis-root", eval_root, "--checkpoint", best]
    ev = run("evaluate", torch_evaluate, [*common, "--results-root", str(workdir / "results")], forward)
    check(ev["load"]["unused_source_keys"] == [] and ev["load"]["untouched"] == [], "ckpt_best did not load whole")
    extract = workdir / "extract"
    run("extract_for_davis_eval", torch_extract_for_davis_eval, [*common, "--out-dir", str(extract)], forward)
    check(sorted(p.name for p in (extract / "synth00").iterdir()) == [f"{i:05d}.png" for i in range(16)],
          "the extracted tree lacks a frame")
    summary = run("score", torch_score, ["--davis-root", eval_root, "--results-path", str(extract), "--codalab"], ())
    check(all(v == 0 for v in counts["score"].values()), f"the scorer launched a kernel: {counts['score']}")
    diff = max(abs(summary[k] - ev["summary"][k]) for k in summary)
    log(f"cli: score of the extracted tree J&F {summary['J&F-Mean']:.6f}, evaluate {ev['jf']:.6f}, "
        f"largest difference over {len(summary)} statistics {diff:.3e} (tol 1e-6)")
    check(summary.keys() == ev["summary"].keys() and diff <= 1e-6, "score and evaluate disagree")

    fine_tune = osvos.train_osvos_sequence
    osvos.train_osvos_sequence = functools.partial(fine_tune, items_per_epoch=4)  # as phase 7: 2 updates
    try:
        results = run("train_osvos single", torch_train_osvos, [*common, "--sequence", "synth00", "--epochs", "1",
                                                                "--results-root", str(workdir / "osvos")])
    finally:
        osvos.train_osvos_sequence = fine_tune
    check(sorted(results) == [-1, 0], f"OSVOS results {results}")

    pred = workdir / "predictions"
    out = run("predict --save-all", torch_predict, [*common, "--out-dir", str(pred), "--save-all"], forward)
    check(len(list(pred.glob("synth00_*_iou*.png"))) == 16 and 0.0 <= out["miou"] <= 1.0, "overlays missing")

    # F1: the trained weights in the reference's full-model layout.
    sd = checkpoint.load_checkpoint(best)["model"]
    ref = {(k if k.startswith("slow_fast.") else f"maskrcnn_model.{k}"): v for k, v in sd.items()}
    ref["maskrcnn_model.backbone.body.bn1.num_batches_tracked"] = torch.tensor(0)
    pth = str(workdir / "model_slow_fast_3_3.pth")
    torch.save(ref, pth)
    ev_pth = run("evaluate .pth", torch_evaluate,
                 ["--davis-root", eval_root, "--checkpoint", pth, "--results-root", str(workdir / "results_pth")], forward)
    report = ev_pth["load"]
    log(f"cli: reference-layout .pth: {report['converted']} converted, {len(report['unused_source_keys'])} unused, "
        f"{len(report['untouched'])} untouched; J&F {ev_pth['jf']:.6f} against {ev['jf']:.6f}")
    check(report["unused_source_keys"] == [] and report["untouched"] == [], "the reference .pth did not load whole")
    check(abs(ev_pth["jf"] - ev["jf"]) <= 1e-6, "the reference .pth evaluates otherwise than ckpt_best")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "scripts" / "torch_evaluate.py"), *common,
         "--results-root", str(workdir / "results_subprocess")],
        capture_output=True, text=True, timeout=600,
    )
    walls["evaluate (subprocess)"] = time.perf_counter() - t0
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("J&F-Mean: ")), "")
    log(f"cli: python3 scripts/torch_evaluate.py: exit {proc.returncode} in {walls['evaluate (subprocess)']:.2f} s, "
        f"{line!r}")
    check(proc.returncode == 0 and line == f"J&F-Mean: {ev['jf']:.4f}", f"the script entry failed: {proc.stderr[-2000:]}")

    bench = run("bench --runs 2", torch_bench, ["--runs", "2"], forward)
    bench += run("bench --train", torch_bench, ["--train"])
    infer, train = bench
    check(all(k in infer for k in ("metric", "value", "unit", "vs_baseline", "median", "runs", "config",
                                   "device_fps", "device_median", "device_mfu", "card")) and infer["value"] > 0,
          f"bench record {infer}")
    check(train["metric"] == "train_frames_per_sec_per_chip" and train["step_ms"] > 0, f"bench --train record {train}")
    return {"walls_s": walls, "counts": counts, "bench": bench}


def backward_bound(ra, g, rois, out_size) -> tuple[float, str]:
    """Least time for the backward on an H100: bytes (g read once, the
    gradient pyramid written once in g's dtype, rois and levels once) over
    the memory rate, against f32 operations (4 multiply-adds per valid
    sample and channel, as the forward) over the f32 rate."""
    c, elem = g.shape[-1], g.element_size()
    t = rois.shape[0]
    grid = ra.sample_grid(LEVEL_HWS, rois, ra.ROI_SCALES, out_size, 2)
    valid = int((grid["my"][:, :, None] & grid["mx"][:, None, :]).sum())
    m = rois.shape[0] * rois.shape[1]
    nbytes = g.numel() * elem + t * sum(h * w for h, w in LEVEL_HWS) * c * elem + m * (16 + 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 8 * valid * c / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def backward_timings(ra, errs: dict, counts: dict, train_rois: dict) -> list:
    gen = torch.Generator(device="cuda").manual_seed(6)
    rng = np.random.default_rng(6)
    records = []
    for out_size, n in ((7, 512), (14, 128)):
        per_set = {}
        for roi_set, rois in (("synthetic", rois_for(2, n, rng)), ("train_path", train_rois[out_size])):
            g = torch.randn((*rois.shape[:2], out_size, out_size, 256), generator=gen, device="cuda").to(torch.bfloat16)
            levels = ra.fpn_level_assignment(rois.reshape(-1, 4)).contiguous()
            kernel = lambda: ra.roi_align_backward_cuda(g, rois, LEVEL_HWS, output_size=out_size)  # noqa: E731
            kernel_only = lambda: ra.roi_align_backward_cuda(g, rois, LEVEL_HWS, output_size=out_size, levels=levels)  # noqa: E731
            ms, only_ms, wrapper_ms = device_ms(kernel), device_ms(kernel_only), call_ms(kernel)
            bound_ms, bound_by = backward_bound(ra, g, rois, out_size)
            per_set[roi_set] = {"rois": list(rois.shape[:2]), "ms": ms, "kernel_only_ms": only_ms,
                                "wrapper_call_ms": wrapper_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"time: backward pool{out_size} bf16 {roi_set} {list(rois.shape[:2])}: {ms:.4f} ms device time with "
                f"level assignment, {only_ms:.4f} ms without (geometry and gather kernels; "
                f"{wrapper_ms:.4f} ms per wrapper call on the host clock); bound {bound_ms:.4f} ms ({bound_by})")
        rois = train_rois[out_size]
        g = torch.randn((*rois.shape[:2], out_size, out_size, 256), generator=gen, device="cuda").to(torch.bfloat16)
        plain_ms = call_ms(lambda: ra.multiscale_roi_align_backward_plain(g, rois, LEVEL_HWS, output_size=out_size), runs=5)
        log(f"time: backward pool{out_size} plain version, train-path rois: {plain_ms:.4f} ms (host clock); library call none")
        syn = per_set["synthetic"]
        records.append({
            "name": f"roi_align_backward_pool{out_size}",
            "route": "cuda",
            "source": "slowfast_vos_tpu_torch/csrc/roi_align.cu",
            "replaces": "slowfast_vos_tpu/ops/roi_align_mm.py:125",
            "replaces_note": "the JAX custom VJP _msra_mmgrad_bwd, computed by XLA; there is no Pallas kernel for it",
            "launches": counts["backward", out_size],
            "max_abs_err": errs[out_size],
            "ms": syn["ms"],
            "kernel_only_ms": syn["kernel_only_ms"],
            "wrapper_call_ms": syn["wrapper_call_ms"],
            "plain_ms": plain_ms,
            "bound_ms": syn["bound_ms"],
            "bound_by": syn["bound_by"],
            "library_ms": None,
            "train_path_rois": per_set["train_path"],
        })
    return records


def phase_timings(ra, errs: dict, counts: dict, main_rois: dict) -> list:
    gen = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    feats = pyramid(SC, 256, gen, torch.bfloat16)
    records = []
    for out_size, n in ((7, 1000), (14, 10)):
        per_set = {}
        for roi_set, rois in (("synthetic", rois_for(SC, n, rng)), ("main_path", main_rois[out_size])):
            levels = ra.fpn_level_assignment(rois.reshape(-1, 4)).contiguous()
            kernel = lambda: ra.roi_align_cuda(feats, rois, output_size=out_size)  # noqa: E731
            kernel_only = lambda: ra.launch_kernel(feats, rois, levels, ra.ROI_SCALES, out_size)  # noqa: E731
            ms, only_ms, wrapper_ms = device_ms(kernel), device_ms(kernel_only), call_ms(kernel)
            bound_ms, bound_by = roi_align_bound(ra, feats, rois, out_size)
            footprint = roi_align_footprint(ra, feats, rois, out_size)
            per_set[roi_set] = {
                "rois": list(rois.shape[:2]), "ms": ms, "kernel_only_ms": only_ms, "wrapper_call_ms": wrapper_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "footprint_bytes": footprint,
                "footprint_tb_per_s": footprint / (only_ms * 1e-3) / 1e12,
            }
            log(f"time: pool{out_size} bf16 {roi_set} {list(rois.shape[:2])}: kernel {ms:.4f} ms device time "
                f"with level assignment, {only_ms:.4f} ms without ({wrapper_ms:.4f} ms per wrapper call on the "
                f"host clock); bound {bound_ms:.4f} ms ({bound_by}); footprint {footprint / 1e6:.1f} MB, "
                f"{footprint / (only_ms * 1e-3) / 1e12:.3f} TB/s through L2")
        rois = main_rois[out_size]
        # The plain version copies small host lists to the card (a stream
        # sync each), so it is timed on the host clock only.
        plain_ms = call_ms(lambda: ra.multiscale_roi_align_plain(feats, rois, output_size=out_size))
        log(f"time: pool{out_size} plain version, main-path rois: {plain_ms:.4f} ms (host clock); library call none")
        syn = per_set["synthetic"]
        records.append({
            "name": f"roi_align_pool{out_size}",
            "route": "cuda",
            "source": "slowfast_vos_tpu_torch/csrc/roi_align.cu",
            "replaces": "slowfast_vos_tpu/ops/roi_align_pallas.py:105",
            "launches": counts[out_size],
            "max_abs_err": errs[out_size],
            "ms": syn["ms"],
            "kernel_only_ms": syn["kernel_only_ms"],
            "wrapper_call_ms": syn["wrapper_call_ms"],
            "plain_ms": plain_ms,
            "bound_ms": syn["bound_ms"],
            "bound_by": syn["bound_by"],
            "footprint_bytes": syn["footprint_bytes"],
            "footprint_tb_per_s": syn["footprint_tb_per_s"],
            "library_ms": None,
            "main_path_rois": per_set["main_path"],
        })
    return records


def nms_bound(svalid: torch.Tensor, alive: torch.Tensor) -> tuple[float, str, int]:
    """Least time for K3 on this run's data on an H100: operations, the IoU
    tests greedy NMS cannot skip (each kept box against every kept box
    before it, one test for each suppressed valid box) at NMS_OPS_PER_PAIR
    f32 operations over the f32 rate, against bytes (each box and flag read
    once, each flag written once) over the memory rate. Returns (ms, what
    bounds it, the pairs counted)."""
    kept = alive.reshape(-1, alive.shape[-1]).sum(-1).double()
    suppressed = (svalid & ~alive).reshape(kept.shape[0], -1).sum(-1).double()
    pairs = int((kept * (kept - 1) / 2 + suppressed).sum())
    t_ops = pairs * NMS_OPS_PER_PAIR / F32_FLOP_PER_S * 1e3
    t_bytes = svalid.numel() * (16 + 1 + 1) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), pairs


def kernel_ms_by_name(fn, names: tuple, runs: int = 5, attempts: int = 3) -> tuple[dict, float]:
    """Device ms per call of each kernel of `fn` whose name holds one of
    `names`, summed by that name, and the device kernels `fn` launches per
    call, all of them: torch.profiler over `runs` calls. A trace that came
    back without device events (the profiler lost them) is taken again, up
    to `attempts` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        out, kernels = dict.fromkeys(names, 0.0), 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or e.name.startswith(("Memcpy", "Memset")):
                continue
            kernels += 1
            name = next((n for n in names if n in e.name), None)
            if name:
                out[name] += e.time_range.elapsed_us() / 1e3 / runs
        if kernels and all(out.values()):
            break
    return out, kernels / runs


NMS_KERNEL = "nms_cluster_kernel"


def nms_timings(nms, err: float, counts: dict, main_nms: dict, train_nms: dict) -> dict:
    """K3 on phase 2 and 3's own candidates and at NMS_SHAPES: device time
    of `nms_mask` (effective scores, sort, kernel) and of the kernel alone
    on the sorted order (CUDA events, calls queued behind a spin), the
    kernel's own time and the device launches per `nms_mask` call
    (torch.profiler), the host clock per call, the plain fixpoint's host
    clock, the bound, and each case's route, cluster, shared memory and
    scratch. The record's own numbers are phase 2's RPN call's."""
    rng = np.random.default_rng(31)
    cases = [("main_path rpn", main_nms["rpn"]), ("main_path class_keyed", main_nms["class_keyed"]),
             ("train_path rpn", train_nms["rpn"])]
    cases += [(f"synthetic {name}", nms_case(rng, lead, n, thr, keyed)) for name, lead, n, thr, keyed in NMS_SHAPES]
    per_case = {}
    for tag, (boxes, scores, valid, thr) in cases:
        eff, order = nms.effective_order(scores, valid)
        full = lambda: nms.nms_mask(boxes, scores, valid, iou_threshold=thr)  # noqa: E731
        alone = lambda: nms.nms_cuda(boxes, eff, order, thr)  # noqa: E731
        ms, only_ms, wrapper_ms = device_ms(full), device_ms(alone), call_ms(full)
        split, _ = kernel_ms_by_name(alone, (NMS_KERNEL,))
        _, per_call = kernel_ms_by_name(full, (NMS_KERNEL,))
        plain_ms = call_ms(lambda: nms.nms_mask(boxes, scores, valid, iou_threshold=thr, algorithm="fixpoint"), runs=5)
        _, _, svalid = nms.score_order(boxes, scores, valid)
        bound_ms, bound_by, pairs = nms_bound(svalid, torch.gather(alone(), -1, order))
        n = valid.shape[-1]
        problems = valid.numel() // max(n, 1)
        route, cluster = nms.route(n), nms.cluster_size(n)
        per_case[tag] = {"shape": list(valid.shape), "thr": thr, "ms": ms, "kernel_only_ms": only_ms,
                         "wrapper_call_ms": wrapper_ms, "kernel_ms": split[NMS_KERNEL],
                         "device_launches_per_call": per_call, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "pairs": pairs, "all_pairs": problems * n * (n - 1) // 2,
                         "route": route, "cluster": cluster, "shared_bytes": nms.shared_bytes(n, cluster, route),
                         "scratch_bytes": nms.scratch_bytes(nms.problems_per_launch(problems, n), n)}
        log(f"time: nms {tag} {list(valid.shape)} thr {thr} ({route} route, cluster of {cluster}): {ms:.4f} ms "
            f"device time with the effective scores and sort ({per_call:g} device launches a call), {only_ms:.4f} ms "
            f"kernel alone ({split[NMS_KERNEL]:.4f} ms by the profiler; {wrapper_ms:.4f} ms per call on the host "
            f"clock); plain fixpoint {plain_ms:.4f} ms (host clock); bound {bound_ms:.6f} ms ({bound_by}, {pairs} "
            f"IoU tests of {per_case[tag]['all_pairs']} pairs); shared memory {per_case[tag]['shared_bytes']} B a "
            f"CTA, scratch {per_case[tag]['scratch_bytes'] / 1e6:.2f} MB")
    main = per_case["main_path rpn"]
    return {
        "name": "nms",
        "route": "cuda",
        "source": "slowfast_vos_tpu_torch/csrc/nms.cu",
        "replaces": "slowfast_vos_tpu/ops/nms.py:27",
        "replaces_note": "_nms_fixpoint and the blocked sweep of nms_mask (:96-136), computed by XLA; there is no "
                         "Pallas kernel for NMS",
        "launches": counts["nms"],
        "max_abs_err": err,
        **{k: main[k] for k in ("ms", "kernel_only_ms", "wrapper_call_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "cases": per_case,
    }


# Phase 9: the parallel layer. Two ranks on the one card run as worker
# processes of this script (`--parallel-worker MODE BACKEND WORKDIR`).
PARALLEL_WORKER = "--parallel-worker"
DP_STEPS = 3
NCCL1_PAIRS = 5  # warm serial and one-rank DP steps, in turns
DP_LOSS_RTOL = 1e-4  # bf16: the single-window forward runs without autograd


def launch_delta(ra, before) -> dict:
    """Launches of K1 and K5 at both pools since `before` (a copy of the
    counter), as a JSON-able dict."""
    return {str(k): ra.launches[k] - before[k] for k in LAUNCH_KEYS}


def params_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def parallel_worker(mode: str, backend: str, workdir: Path) -> int:
    """One rank of phase 9's process group (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT in the environment); writes its results to
    `<workdir>/<mode>_rank<r>.json`. Mode `probe`: join the group and
    all-reduce one tensor on the card. Mode `nccl1`: two data-parallel
    steps in a group of one, then warm `Trainer.step`s and DP steps in
    turns on one window and draws. Mode `pair`: the DP steps, data-parallel
    `train_unsupervised`, the sharded evaluation and the sharded OSVOS run."""
    import collections

    from slowfast_vos_tpu_torch import data
    from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod
    from slowfast_vos_tpu_torch.ops import roi_align as ra
    from slowfast_vos_tpu_torch.parallel import distributed as pdist
    from slowfast_vos_tpu_torch.parallel.sharded import make_sharded_train_step, replicate_state, running_buffers
    from slowfast_vos_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(pdist.init_distributed_mode(backend=backend, verbose=False), "the worker found no launch environment")
    rank, world = pdist.get_rank(), pdist.get_world_size()
    out: dict = {"rank": rank, "world": world, "backend": torch.distributed.get_backend(), "walls_s": {}, "counts": {}}
    if mode == "probe":
        t = torch.full((4,), float(rank + 1), device="cuda")
        torch.distributed.all_reduce(t)
        check(t.tolist() == [3.0] * 4, f"all_reduce gave {t.tolist()}")
    else:
        pipe, model = pipeline_mod.build_pipeline(3, 3, DRIVER_HW, dtype=torch.bfloat16, device="cuda", superchunk=SC)
        pipeline_mod.init_weights(model, seed=0)
        trainer = Trainer(pipe, seed=0)
        replicate_state(model)
        step = make_sharded_train_step(trainer)
        window, _ = training_window(data, DRIVER_HW, 8, pipe.cfg.max_gt, index=rank % 2)
        buffers = running_buffers(model)
        counts, step_ms, rels = collections.Counter(), [], []
        for _ in range(DP_STEPS if mode == "pair" else 2):
            draws = trainer.make_draws(int(window["boxes"].shape[1]))
            saved = [b.clone() for b in buffers]
            model.train()
            with torch.no_grad():
                single = float(trainer.loss(window, draws)[0])
            model.eval()
            for b, v in zip(buffers, saved):
                b.copy_(v)
            singles = pdist.all_gather_host(single)
            before = collections.Counter(ra.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(window, draws)["loss"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts.update({k: ra.launches[k] - before[k] for k in LAUNCH_KEYS})
            want = statistics.fmean(singles)
            rels.append(abs(loss - want) / abs(want))
            check(rels[-1] <= DP_LOSS_RTOL, f"DP loss {loss} against the mean of the windows' losses {singles}")
            digests = pdist.all_gather_host(params_digest(model))
            check(len(set(digests)) == 1, "the ranks' parameters differ after a DP step")
        out["counts"]["dp_steps"] = {str(k): counts[k] for k in LAUNCH_KEYS}
        out["dp_step_ms"], out["dp_loss_rel_err"] = step_ms, rels
        if mode == "nccl1":
            # Warm steps in turns on the same window and draws: `Trainer.step`
            # and the DP step of a group of one, which adds the collectives.
            draws = trainer.make_draws(int(window["boxes"].shape[1]))
            turns = {"serial": [], "dp": []}
            for _ in range(NCCL1_PAIRS):
                for name, fn in (("serial", trainer.step), ("dp", step)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    float(fn(window, draws)["loss"])
                    torch.cuda.synchronize()
                    turns[name].append((time.perf_counter() - t0) * 1e3)
            out["turns_ms"] = turns
        if mode == "pair":
            parallel_drivers(out, workdir, pipe, model, rank)
    (workdir / f"{mode}_rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def parallel_drivers(out: dict, workdir: Path, pipe, model, rank: int) -> None:
    """Phase 9's drivers on one rank of the pair: data-parallel
    `train_unsupervised` (1 epoch of 3 windows: one wrap-filled group), the
    sharded `davis_evaluation` of 3 sequences against the serial one, and
    the sharded `run_osvos_for_all_sequences` of 2 sequences against the
    serial run."""
    import collections

    from slowfast_vos_tpu_torch.eval import glue, scorer
    from slowfast_vos_tpu_torch.ops import roi_align as ra
    from slowfast_vos_tpu_torch.parallel import distributed as pdist
    from slowfast_vos_tpu_torch.train import osvos, trainer as unsupervised

    def timed(name, fn):
        before = collections.Counter(ra.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out["walls_s"][name] = time.perf_counter() - t0
        out["counts"][name] = launch_delta(ra, before)
        return result

    run_dir = workdir / f"unsupervised_rank{rank}"
    _, history = timed("train_unsupervised", lambda: unsupervised.train_unsupervised(
        pipe, train_root=str(workdir / "train17"), output_dir=str(run_dir), epochs=1, max_windows_per_epoch=3, seed=0,
    ))
    out["history"] = history
    out["run_files"] = sorted(p.name for p in run_dir.iterdir())
    histories = pdist.all_gather_host(history)
    check(histories[0] == histories[1] and np.isfinite(history[0]["loss"]), f"DP histories {histories}")

    eval_root = str(workdir / "eval3")
    jf, summary, *_ = timed("davis_evaluation", lambda: glue.davis_evaluation(
        pipe, davis_root=eval_root, results_root=str(workdir / "sharded"), model_name="m", year="2016",
    ))
    out["jf"] = jf
    if rank == 0:
        serial_tree = workdir / "serial_tree"
        glue.extract_masks(pipe, eval_root, str(serial_tree), year="2016", shard_by_process=False)
        serial = scorer.summarize(scorer.DavisScorer(eval_root, task="unsupervised", gt_set="val", year="2016")
                                  .evaluate(str(serial_tree)))
        sharded_tree = workdir / "sharded" / "unsupervised" / "m"
        files = sorted(p.relative_to(serial_tree) for p in serial_tree.rglob("*.png"))
        check(len(files) == 24 and files == sorted(p.relative_to(sharded_tree) for p in sharded_tree.rglob("*.png")),
              "the sharded tree holds other files than the serial one")
        check(all((serial_tree / f).read_bytes() == (sharded_tree / f).read_bytes() for f in files),
              "the sharded PNG tree differs from the serial one")
        check(summary == serial, f"sharded J&F {summary} against serial {serial}")
        out["serial_jf"] = serial["J&F-Mean"]

    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cfg = osvos.ExperimentConfig(freeze="SF", epochs=1)
    kw = dict(davis_root=str(workdir / "osvos2"), cfg=cfg, items_per_epoch=4)
    results = timed("run_osvos_for_all_sequences", lambda: osvos.run_osvos_for_all_sequences(
        pipe, start, results_root=str(workdir / "osvos_res"), output_json=str(workdir / "osvos.json"), **kw,
    ))
    if rank == 0:
        serial = osvos.run_osvos_for_all_sequences(
            pipe, start, results_root=str(workdir / "osvos_serial"), output_json=str(workdir / "osvos_serial.json"),
            shard_by_process=False, **kw,
        )
        strip = lambda res: {s: {e: {k: v for k, v in r.items() if k != "eval_time"} for e, r in per.items()}  # noqa: E731
                             for s, per in res.items()}
        merged = json.loads((workdir / "osvos.json").read_text())
        check(strip(results) == strip(serial) and strip(merged) == strip(json.loads((workdir / "osvos_serial.json")
                                                                                      .read_text())),
              f"sharded OSVOS {results} against serial {serial}")
        check(all((workdir / f"osvos.json.rank{r}").exists() for r in range(2)), "a rank's OSVOS JSON is missing")
    pdist.host_barrier("phase 9 done")


def start_ranks(mode: str, backend: str, workdir: Path, world: int) -> list:
    """Start `world` ranks of this script's worker on the card; returns
    [(process, log path)] for `wait_ranks`."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ranks = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        log_path = workdir / f"{mode}_rank{rank}.log"
        with open(log_path, "w") as f:
            ranks.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), PARALLEL_WORKER, mode, backend, str(workdir)],
                env=env, stdout=f, stderr=subprocess.STDOUT,
            ), log_path))
    return ranks


def wait_ranks(ranks: list, mode: str, workdir: Path, timeout_s: float):
    """Wait for ranks from `start_ranks`, killing every one still running at
    `timeout_s`. Returns (exit codes, each rank's results or None, the tail
    of each rank's log, wall seconds since the wait began)."""
    t0 = time.perf_counter()
    codes = []
    try:
        for p, _ in ranks:
            try:
                codes.append(p.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - t0))))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for p, _ in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = [json.loads(r.read_text()) if (r := workdir / f"{mode}_rank{i}.json").exists() else None
               for i in range(len(ranks))]
    return codes, results, [lg.read_text()[-3000:] for _, lg in ranks], time.perf_counter() - t0


def phase_parallel(ra, pipeline_mod, train_mod, data, workdir: Path) -> dict:
    """Phase 9: two ranks on the one card through the data-parallel step,
    `train_unsupervised`, the sharded evaluation and OSVOS; a group of one
    on `nccl`; then in this process `DeviceParallelInference` over
    [cuda:0, cuda:0] and lockstep OSVOS of two members, each against its
    serial run. Returns timings and launch counts."""
    from slowfast_vos_tpu_torch.parallel import DeviceParallelInference
    from slowfast_vos_tpu_torch.train import osvos

    hw = DRIVER_HW
    data.make_synthetic_davis(str(workdir / "train17"), num_sequences=2, frames=8, hw=hw, num_objects=2)
    data.make_synthetic_davis(str(workdir / "eval3"), num_sequences=3, frames=8, hw=hw, num_objects=1, year="2016",
                              subset="val", seed=7)
    data.make_synthetic_davis(str(workdir / "osvos2"), num_sequences=2, frames=8, hw=hw, num_objects=1, year="2016",
                              subset="val", seed=9)
    out: dict = {"walls_s": {}, "counts": {}}

    # The nccl probe of two ranks and the one-rank nccl group start together.
    t0 = time.perf_counter()
    probe, nccl1 = start_ranks("probe", "nccl", workdir, 2), start_ranks("nccl1", "nccl", workdir, 1)
    codes, _, tails, _ = wait_ranks(probe, "probe", workdir, timeout_s=120)
    wall = time.perf_counter() - t0
    nccl_pair = codes == [0, 0]
    lines = [ln for t in tails for ln in t.splitlines()]
    refusal = next((ln for ln in lines if "Duplicate GPU" in ln), next((ln for ln in lines if "ncclInvalidUsage" in ln), ""))
    out["nccl_two_ranks_one_card"] = "accepted" if nccl_pair else f"refused (exit codes {codes}): {refusal.strip()[:300]}"
    log(f"parallel: nccl with two ranks on one card: {out['nccl_two_ranks_one_card']} (after {wall:.1f} s)")
    backend = "nccl" if nccl_pair else "gloo"
    codes, results, tails, _ = wait_ranks(nccl1, "nccl1", workdir, timeout_s=240)
    wall = time.perf_counter() - t0
    check(codes == [0] and results[0] is not None and results[0]["backend"] == "nccl",
          f"the one-rank nccl run failed (exit {codes}):\n{tails[0]}")
    c = results[0]["counts"]["dp_steps"]
    out["counts"]["nccl1 dp_step"], out["walls_s"]["probe + nccl1"] = c, wall
    out["dp_step_ms"] = {"nccl1": results[0]["dp_step_ms"]}
    check(all(c[str(k)] > 0 for k in LAUNCH_KEYS), f"the nccl step bypassed a kernel: {c}")
    turns = results[0]["turns_ms"]
    out["nccl1_turns_ms"] = turns
    med = {k: statistics.median(v) for k, v in turns.items()}
    log(f"parallel: one nccl rank: 2 DP steps in {', '.join(f'{t:.1f}' for t in results[0]['dp_step_ms'])} ms, "
        f"launches {c} (with the probe {wall:.1f} s); then {NCCL1_PAIRS} warm steps each in turns on one window "
        f"and draws: Trainer.step median {med['serial']:.2f} ms ({', '.join(f'{t:.1f}' for t in turns['serial'])}),"
        f" the one-rank DP step {med['dp']:.2f} ms ({', '.join(f'{t:.1f}' for t in turns['dp'])}), "
        f"difference {med['dp'] - med['serial']:.2f} ms")

    codes, results, tails, wall = wait_ranks(start_ranks("pair", backend, workdir, 2), "pair", workdir, timeout_s=600)
    check(codes == [0, 0] and None not in results,
          f"the {backend} pair failed (exit codes {codes}):\n" + "\n---\n".join(tails))
    out["backend"], out["walls_s"]["pair"] = backend, wall
    r0, r1 = results
    check(r0["world"] == 2 and r0["backend"] == backend, f"pair ran as {r0['world']} ranks on {r0['backend']}")
    check({"ckpt_last.pt", "ckpt_best.pt"} <= set(r0["run_files"]) and not {"ckpt_last.pt", "ckpt_best.pt"} &
          set(r1["run_files"]), f"checkpoints: rank 0 {r0['run_files']}, rank 1 {r1['run_files']}")
    for r in results:
        for name, c in r["counts"].items():
            key = f"{name} rank{r['rank']}"
            out["counts"][key] = c
            required = FORWARD_KEYS if name == "davis_evaluation" else LAUNCH_KEYS
            check(all(c[str(k)] > 0 for k in required), f"{key} bypassed a kernel: {c}")
            log(f"parallel: {key}: launches {launch_text(c)}")
    out["dp_step_ms"].update({f"rank{r['rank']}": r["dp_step_ms"] for r in results})
    out["dp_loss_rel_err"] = max(max(r["dp_loss_rel_err"]) for r in results)
    out["walls_s"].update({f"{k} rank{r['rank']}": v for r in results for k, v in r["walls_s"].items()})
    log(f"parallel: {DP_STEPS} DP steps on 2 {backend} ranks (one card): ms/step rank 0 "
        f"{', '.join(f'{t:.1f}' for t in r0['dp_step_ms'])}, rank 1 {', '.join(f'{t:.1f}' for t in r1['dp_step_ms'])}; "
        f"loss against the mean of the windows' losses: largest rel err {out['dp_loss_rel_err']:.2e} "
        f"(tol {DP_LOSS_RTOL}); parameters bit-identical on both ranks after every step")
    log(f"parallel: train_unsupervised 1 epoch x 3 windows (2 groups, one wrap-filled) {r0['walls_s']['train_unsupervised']:.2f} s,"
        f" loss {r0['history'][0]['loss']:.4f}, identical histories, checkpoints on rank 0 only; sharded davis_evaluation"
        f" of 3 x 8 frames {r0['walls_s']['davis_evaluation']:.2f} s, J&F {r0['jf']:.4f} (serial {r0['serial_jf']:.4f}),"
        f" PNG trees byte-identical; sharded run_osvos_for_all_sequences 2 x 4 items"
        f" {r0['walls_s']['run_osvos_for_all_sequences']:.2f} s, merged JSON equal to serial; pair wall {wall:.1f} s")


    # In this process: device-parallel inference over [cuda:0, cuda:0].
    cuda2 = [torch.device("cuda", 0)] * 2
    pipe, model = pipeline_mod.build_pipeline(3, 3, hw, dtype=torch.bfloat16, device="cuda", superchunk=SC)
    pipeline_mod.init_weights(model, seed=0)
    rng = np.random.default_rng(11)
    clips = [data.draw_sequence(rng, t, *hw, 2)[0] for t in (20, 11, 6)]
    with launches_of(ra, out["counts"], "device_parallel_inference", required=FORWARD_KEYS, tag="parallel"):
        t0 = time.perf_counter()
        dp = DeviceParallelInference(pipe, cuda2)
        got = dp.infer_group(clips[:2]) + dp.infer_group(clips[2:])
        torch.cuda.synchronize()
        out["walls_s"]["device_parallel_inference"] = time.perf_counter() - t0
    for clip, dets in zip(clips, got):
        want = pipe.infer_sequence(clip)
        check(len(dets) == len(want) and all(sorted(g) == sorted(w) and all(np.array_equal(g[k], w[k]) for k in w)
                                             for g, w in zip(dets, want)), "device-parallel detections differ from serial")
    log(f"parallel: DeviceParallelInference on [cuda:0, cuda:0], clips of 20 + 11 and 6 (wrap-filled) frames: "
        f"{out['walls_s']['device_parallel_inference']:.2f} s, detections equal to serial bit for bit")

    # Lockstep OSVOS of two members against each member's serial run.
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cfg = osvos.ExperimentConfig(freeze="SF", epochs=1)
    kw = dict(davis_root=str(workdir / "osvos2"), cfg=cfg, items_per_epoch=4)
    with launches_of(ra, out["counts"], "lockstep_osvos", tag="parallel"):
        t0 = time.perf_counter()
        lock = osvos.train_osvos_sequences_lockstep(
            pipe, start, sequence_names=["synth00", "synth01"], results_root=str(workdir / "lock"), devices=cuda2, **kw,
        )
        torch.cuda.synchronize()
        out["walls_s"]["lockstep_osvos"] = time.perf_counter() - t0
    strip = lambda res: {e: {k: v for k, v in r.items() if k != "eval_time"} for e, r in res.items()}  # noqa: E731
    for name in ("synth00", "synth01"):
        serial = osvos.train_osvos_sequence(pipe, start, sequence_name=name, results_root=str(workdir / f"serial_{name}"), **kw)
        check(strip(lock[name]) == strip(serial), f"lockstep member {name} {lock[name]} against serial {serial}")
    log(f"parallel: lockstep OSVOS of 2 members (SF, 4 items) {out['walls_s']['lockstep_osvos']:.2f} s; "
        f"each member's results equal to its serial fine-tune")
    return out

# Phase 10: the NMS kernel and the blocked sweep at N = 8192.
NMS_BLOCKED_N = 8192  # above FIXPOINT_MAX_N: where "auto" takes the blocked sweep


def phase_nms_blocked() -> dict:
    """The NMS kernel and the blocked sweep against the fixpoint at
    N = 8192 (index-exact; host-clock times and the temporaries' peak
    memory of each)."""
    from slowfast_vos_tpu_torch.ops import nms

    rng = np.random.default_rng(10)
    xy = rng.uniform(0, [1344, 768], (NMS_BLOCKED_N, 2))
    boxes = np.round(np.concatenate([xy, xy + rng.uniform(8, 300, (NMS_BLOCKED_N, 2))], 1) / 4) * 4
    args = (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy((np.round(rng.uniform(0, 1, NMS_BLOCKED_N) * 64) / 64).astype(np.float32)).cuda(),
            torch.from_numpy(rng.uniform(size=NMS_BLOCKED_N) > 0.05).cuda())
    results, nms_ms, nms_gib = {}, {}, {}
    for algorithm in ("auto", "fixpoint", "blocked"):  # "auto" on the card: K3
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        results[algorithm] = nms.nms_mask(*args, iou_threshold=0.5, algorithm=algorithm)
        torch.cuda.synchronize()
        nms_gib[algorithm] = (torch.cuda.max_memory_allocated() - base) / 2**30
        nms_ms[algorithm] = call_ms(lambda: nms.nms_mask(*args, iou_threshold=0.5, algorithm=algorithm), runs=5, warmup=1)
    kept = int(results["blocked"][0].sum())
    log(f"nms: N = {NMS_BLOCKED_N} on the card, {kept} kept: kernel {nms_ms['auto']:.3f} ms, {nms_gib['auto']:.3f} "
        f"GiB; fixpoint {nms_ms['fixpoint']:.3f} ms, {nms_gib['fixpoint']:.3f} GiB; blocked (B 128) "
        f"{nms_ms['blocked']:.3f} ms, {nms_gib['blocked']:.3f} GiB (host clock, median of 5; temporaries' peak)")
    check(all(torch.equal(a, b) for alg in ("auto", "blocked") for a, b in zip(results[alg], results["fixpoint"]))
          and 0 < kept < NMS_BLOCKED_N, "the kernel or the blocked NMS differs from the fixpoint")
    return {"n": NMS_BLOCKED_N, "kept": kept, "ms": nms_ms, "peak_gib": nms_gib}


# Phase 11: the superchunk's CUDA graphs against the eager path.
GRAPH_CELLS = ((SC, 20), (32, 64))  # (superchunk, frames): phase 2's clip; the CLIs' superchunk over 64 frames
GRAPH_RUNS = 3


def turns(fns: dict, runs: int) -> dict:
    """{name: [seconds of each call]} of `fns` called in turns `runs` times,
    on the host clock, synchronized around each call."""
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return times


def same_detections(got: list, want: list) -> bool:
    """Two `infer_sequence` results equal bit for bit, every key of every frame."""
    return len(got) == len(want) and all(
        g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in g) for g, w in zip(got, want))


def host_part_without_sync(pipe, clip) -> list:
    """The host's part of an `infer_sequence` call (staging, uploads, the
    superchunks) under the sync debug mode "error", which raises on any
    synchronizing call; then the fetch, outside it."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = pipe.infer_chunks(clip)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    from slowfast_vos_tpu_torch.models.pipeline import frame_detections

    return frame_detections(pending, clip.shape[0], clip.shape[2])


def phase_graphs(ra, pipeline_mod) -> dict:
    """The superchunk's CUDA graphs (`models/graphs.py`) at full width
    (480x854, 3-3, bf16, seeded weights) at superchunk 8 over phase 2's
    20 frames and at 32 over 64: a graph pipeline and an eager one
    (`graphs=False`) over the same model; peak device memory of an eager
    run, of the first graph run (captures) and of a warm one; with and
    without instance masks, the first graph run and a
    warm one each equal to the eager run bit for bit; a warm graph run
    counting one launch of each pool and two of K3 per superchunk, each
    graph recording the same; the host's part of a run on either path
    under the sync debug mode "error"; frames/s of both paths in turns
    (median of 3) and each graph's capture time; at superchunk 8, other
    weights loaded in place and replayed against eager with no new capture,
    then a replaced parameter recaptured."""
    out = {}
    for sc, frames in GRAPH_CELLS:
        pipe, model = pipeline_mod.build_pipeline(3, 3, DRIVER_HW, dtype=torch.bfloat16, device="cuda", superchunk=sc)
        pipeline_mod.init_weights(model, seed=0)
        eager = pipeline_mod.Pipeline(model, pipe.transform, superchunk=sc, graphs=False)
        check(pipe.graphs is not None and eager.graphs is None, "graphs are not on by default on the card")
        clip = np.random.default_rng(1).integers(0, 256, (frames, *DRIVER_HW, 3), dtype=np.uint8)
        chunks, tag = -(-frames // sc), f"superchunk {sc}, {frames} frames"
        # A replay's intermediates lie in the graphs' pool, which the
        # allocator counts as reserved, not allocated: both peaks, each run
        # from an emptied cache.
        cell = {"peak_gib": {}, "peak_reserved_gib": {}}
        runs = {}
        for name, p in (("eager", eager), ("graphs first run", pipe), ("graphs warm", pipe)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            runs[name] = p.infer_sequence(clip)
            torch.cuda.synchronize()
            cell["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2**30
            cell["peak_reserved_gib"][name] = torch.cuda.max_memory_reserved() / 2**30
        check(same_detections(runs["graphs first run"], runs["eager"]) and same_detections(runs["graphs warm"], runs["eager"]),
              f"graphs: {tag}: the graph path differs from the eager path")
        log(f"graphs: {tag}: peak device memory allocated / reserved: " + ", ".join(
            f"{k} {cell['peak_gib'][k]:.2f} / {cell['peak_reserved_gib'][k]:.2f} GiB" for k in runs))

        for masks in (False, True):
            want = eager.infer_sequence(clip, instance_masks=masks)
            got = [pipe.infer_sequence(clip, instance_masks=masks) for _ in range(2)]
            equal = all(same_detections(g, want) for g in got)
            log(f"graphs: {tag}: instance masks {masks}: first and warm graph runs equal to eager "
                f"bit for bit: {equal} ({sum(int(d['valid'].sum()) for d in want)} valid detections)")
            check(equal, f"graphs: {tag}: instance masks {masks}: the graph path differs from eager")
        check(pipe.graphs.captures == len(pipe.graphs.graphs) == 4,
              f"graphs: {pipe.graphs.captures} captures of {len(pipe.graphs.graphs)} keys, 4 expected")
        cell["capture_s"] = {f"{'carry' if k[2] else 'first'}{' instance masks' if k[3] else ''}": g.capture_s
                             for k, g in pipe.graphs.graphs.items()}
        for g in pipe.graphs.graphs.values():
            check(g.launches == {7: 1, 14: 1, "nms": 2, "epilogue": K8_PER_BACKBONE}, f"a graph recorded {g.launches}")
        ra.launches.clear()
        pipe.infer_sequence(clip)
        counts = {k: ra.launches[k] for k in INFER_KEYS}
        check(counts == {7: chunks, 14: chunks, "nms": 2 * chunks, "epilogue": K8_PER_BACKBONE * chunks},
              f"graphs: {tag}: warm run launches {counts}")
        log(f"graphs: {tag}: a warm graph run launched pool7 {counts[7]}, pool14 {counts[14]}, nms {counts['nms']}, "
            f"epilogue {counts['epilogue']} (per replay: pool7 1, pool14 1, nms 2, epilogue {K8_PER_BACKBONE}); capture s " + ", ".join(f"{k} {v:.3f}" for k, v in cell["capture_s"].items()))

        for name, p in (("eager", eager), ("graphs", pipe)):
            check(same_detections(host_part_without_sync(p, clip), runs["eager"]), f"graphs: {name} path under sync debug")
        log(f"graphs: {tag}: the host's part of a run under sync debug \"error\" on both paths: no synchronize")

        timed = turns({"eager": lambda: eager.infer_sequence(clip), "graphs": lambda: pipe.infer_sequence(clip)}, GRAPH_RUNS)
        cell["runs_s"] = timed
        cell["frames_per_s"] = {k: frames / statistics.median(v) for k, v in timed.items()}
        log(f"graphs: {tag}: in turns, " + "; ".join(
            f"{k} {', '.join(f'{r:.3f}' for r in v)} s -> {cell['frames_per_s'][k]:.2f} frames/s" for k, v in timed.items()))

        if sc == SC:
            _, other = pipeline_mod.build_pipeline(3, 3, DRIVER_HW, dtype=torch.bfloat16, device="cuda", superchunk=sc)
            model.load_state_dict(pipeline_mod.init_weights(other, seed=1).state_dict())
            del other
            captures = pipe.graphs.captures
            reloaded = pipe.infer_sequence(clip)
            check(same_detections(reloaded, eager.infer_sequence(clip)) and not same_detections(reloaded, runs["eager"])
                  and pipe.graphs.captures == captures, "graphs: weights loaded in place were not replayed right")
            head = model.roi_heads.box_predictor.cls_score
            head.weight = torch.nn.Parameter(head.weight.detach().clone())
            check(same_detections(pipe.infer_sequence(clip), reloaded) and pipe.graphs.captures == captures + 2,
                  "graphs: a replaced parameter was not recaptured")
            log(f"graphs: {tag}: other weights loaded in place replayed equal to eager with no new capture; a "
                f"replaced parameter recaptured both graphs ({captures} -> {pipe.graphs.captures} captures)")
        out[f"superchunk {sc}"] = cell
        del pipe, eager, model, runs
        torch.cuda.empty_cache()
    return out


# Phase 12: the training step's CUDA graphs against the eager path.
PRETRAIN_SECOND_HW = (600, 800)  # a second canvas (832x1088 against 768x1344), as the pretrain sampler pairs sizes
TRAIN_GROUPS = ("losses", "grads", "weights", "statistics", "draws", "generator")
TRAIN_TURNS = 10
OSVOS_SEQUENCES = 3


def train_graph_cells(pipeline_mod, data) -> list:
    """Phase 12's set-ups at full width (bf16, seeded weights, default
    DetectionConfig): (name, pipelines over one model, Trainer arguments,
    [(pipeline index, batch)] of TRAIN_STEPS calls). Unsupervised (phase
    3's: 3-3, 2 centre frames, accumulate 1), OSVOS (3-3, 1 centre frame,
    accumulate 2, freeze SF: the backbone trains, SlowFast is frozen) and
    the Mask R-CNN fine-tune (no SlowFast, the backbone's layers 2-4 train,
    the warm-up schedule through LambdaLR, two canvases in turns through
    `use_pipeline`)."""
    from slowfast_vos_tpu_torch.models.transform import ImageTransform
    from slowfast_vos_tpu_torch.train.osvos import _freeze_flags
    from slowfast_vos_tpu_torch.train.pretrain import warmup_step_lr

    def windows(hw, fast, n_center, seed=7):
        images, ids = data.draw_sequence(np.random.default_rng(seed), 8, *hw, 2)
        return list(data.train_windows(data.sequence_arrays(images, ids, 8), fast=fast, n_center=n_center))

    def calls(pick):
        return [pick(k) for k in range(TRAIN_STEPS)]

    pipe, model = pipeline_mod.build_pipeline(3, 3, DRIVER_HW, dtype=torch.bfloat16, device="cuda", superchunk=SC)
    pipeline_mod.init_weights(model, seed=0)
    two, one = windows(DRIVER_HW, 3, 2), windows(DRIVER_HW, 3, 1)
    pre, pre_model = pipeline_mod.build_pipeline(1, 1, DRIVER_HW, dtype=torch.bfloat16, device="cuda", superchunk=SC,
                                                 use_slow_fast=False)
    pipeline_mod.init_weights(pre_model, seed=0)
    t = pre.transform
    second = pipeline_mod.Pipeline(pre_model, ImageTransform(PRETRAIN_SECOND_HW, min_size=t.min_size, max_size=t.max_size,
                                                             divisor=t.divisor), superchunk=SC)
    canvases = (windows(DRIVER_HW, 1, 2), windows(PRETRAIN_SECOND_HW, 1, 2, seed=8))
    return [
        ("unsupervised", [pipe], dict(seed=0), calls(lambda k: (0, two[k % len(two)]))),
        ("OSVOS SF", [pipe], dict(seed=0, n_center=1, accumulate=2, **_freeze_flags("SF")),
         calls(lambda k: (0, one[k % len(one)]))),
        ("pretrain", [pre, second], dict(seed=0, lr=warmup_step_lr(1e-3, 4, warmup_iters=3), weight_decay=5e-4,
                                         train_backbone=True, trainable_backbone_layers=3),
         calls(lambda k: (k % 2, canvases[k % 2][k // 2 % len(canvases[k % 2])]))),
    ]


def train_record(train_mod, pipes, kw, calls, start, graphs: bool) -> tuple[dict, object]:
    """The calls of a fresh `Trainer` (graphs or eager) from the model state
    `start`, recording after each call, as copies on the card: its losses,
    the trainable gradients before the update, the trainable weights after
    it, SlowFast's running statistics, the samplers' draws (kept as
    `make_draws` returns them: in a replay, the graph's own) and the
    generator's state. Returns (the record, the trainer)."""
    from slowfast_vos_tpu_torch.parallel.sharded import running_buffers

    class KeptDraws(train_mod.Trainer):
        def make_draws(self, num_gt):
            draws = super().make_draws(num_gt)
            if torch.cuda.is_current_stream_capturing():
                self.graph_draws[id(self.pipe)] = draws  # what each replay of that graph draws into
            else:
                self.eager_draws = draws
            return draws

    model = pipes[0].model
    model.load_state_dict(start)
    tr = KeptDraws(pipes[0], graphs=graphs, **kw)
    tr.graph_draws = {}
    check((tr.graphs is not None) == graphs, "graphs: the trainer's path is not the one asked for")
    params, stats = list(tr.params.values()), running_buffers(model)
    rec = {g: [] for g in TRAIN_GROUPS}
    for i, batch in calls:
        tr.use_pipeline(pipes[i])
        captures = tr.graphs.captures if graphs else 0
        metrics = tr.accumulate_gradient(batch)
        replayed = graphs and tr.graphs.captures == captures
        draws = tr.graph_draws[id(pipes[i])] if replayed else tr.eager_draws
        rec["grads"].append([p.grad.clone() for p in params])
        if tr.calls % tr.accumulate == 0:
            tr.apply_update()
        rec["losses"].append([metrics[k] for k in sorted(metrics)])
        rec["weights"].append([p.detach().clone() for p in params])
        rec["statistics"].append([b.clone() for b in stats])
        rec["draws"].append([draws[k].clone() for k in sorted(draws)])
        rec["generator"].append([tr.generator.get_state()])
    torch.cuda.synchronize()
    return rec, tr


def step_graph_launches(slow_fast: bool) -> dict:
    """What one gradient graph records, and a warm step launches: K1 and K5
    at both pools and K3 once, K8 once a backbone convolution; with
    SlowFast, BN_PER_STEP launches of K6's forward and of its backward
    (OSVOS's SF freeze too: its backbone trains, so SlowFast's input needs
    its gradient)."""
    out = {k: 1 for k in NO_SLOWFAST_KEYS} | {"epilogue": K8_PER_BACKBONE}
    if slow_fast:
        out.update({k: BN_PER_STEP for k in BN_KEYS})
    return out


def record_diff(a: dict, b: dict) -> dict:
    """Per group of two records: (bit for bit equal at every call, the
    largest absolute difference at each call)."""
    out = {}
    for g in TRAIN_GROUPS:
        equal = all(torch.equal(x, y) for xs, ys in zip(a[g], b[g]) for x, y in zip(xs, ys))
        diffs = [max([float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys) if x.numel()], default=0.0)
                 for xs, ys in zip(a[g], b[g])]
        out[g] = (equal, diffs)
    return out


def phase_train_graphs(ra, pipeline_mod, train_mod, data) -> dict:
    """The training step's CUDA graphs (`train/graphs.py`) at full width.
    Per set-up of `train_graph_cells`, from one saved state and seed: two
    eager runs and one graph run of TRAIN_STEPS calls, held call by call in
    every group of TRAIN_GROUPS: the graph run equal to the eager one bit
    for bit where the two eager runs are equal, and otherwise within twice
    their largest difference up to that call. In the unsupervised set-up:
    inference graphs captured before the graph run replay on the trained
    weights after it, equal to an eager pipeline; each gradient graph
    records one launch of K1 and K5 at both pools and one of K3, and with
    SlowFast 32 of K6's forward and backward (`step_graph_launches`), the
    update graph none, and a warm graph step counts those; the host's part of a
    warm step on either path under the sync debug mode "error"; ms/step of
    both paths in turns; capture seconds; peak device memory of each path.
    Then OSVOS trainers one after another on one pipeline (a sequence
    each): the reserved memory must not grow with them."""
    out = {}
    cells = train_graph_cells(pipeline_mod, data)
    clip = training_window(data, DRIVER_HW, 8, 8, index=0)[1]
    for name, pipes, kw, calls in cells:
        model = pipes[0].model
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        infer_check = name == "unsupervised"
        recs = {}
        for run, graphs in (("eager", False), ("eager again", False), ("graphs", True)):
            if infer_check and graphs:
                model.load_state_dict(start)
                before = pipes[0].infer_sequence(clip)  # captures the inference graphs on the starting weights
                inference_captures = pipes[0].graphs.captures
            recs[run], tr = train_record(train_mod, pipes, kw, calls, start, graphs)
        spread, against = record_diff(recs["eager"], recs["eager again"]), record_diff(recs["graphs"], recs["eager"])
        cell = {"eager_bitwise": {}, "graphs_bitwise": {}, "eager_spread": {}, "graphs_vs_eager": {}}
        for g in TRAIN_GROUPS:
            (e_eq, e_d), (g_eq, g_d) = spread[g], against[g]
            cell["eager_bitwise"][g], cell["graphs_bitwise"][g] = e_eq, g_eq
            cell["eager_spread"][g], cell["graphs_vs_eager"][g] = max(e_d), max(g_d)
            log(f"train graphs: {name}: {g}: two eager runs equal bit for bit {e_eq} (largest difference "
                f"{max(e_d):.3e}); graphs against eager equal {g_eq} (largest {max(g_d):.3e})")
            # Where the eager path does not repeat itself, the graph path is
            # held within twice the eager runs' largest difference so far.
            check(g_eq if e_eq else all(gd <= 2 * max(e_d[: k + 1]) for k, gd in enumerate(g_d)),
                  f"train graphs: {name}: {g}: the graph path differs from the eager path beyond its own spread")
        runner = tr.graphs
        check(len(runner.graphs) == len({i for i, _ in calls}) and runner.update is not None,
              f"train graphs: {name}: {len(runner.graphs)} gradient graphs")
        cell["capture_s"] = {**{f"gradient {dict(k[1])['images'][0]}": g.capture_s for k, g in runner.graphs.items()},
                             "update": runner.update.capture_s}
        for g in runner.graphs.values():
            check(g.launches == step_graph_launches(model.use_slow_fast),
                  f"train graphs: {name}: a gradient graph recorded {g.launches}")
        check(runner.update.launches == {}, f"train graphs: {name}: the update graph recorded {runner.update.launches}")
        log(f"train graphs: {name}: {runner.captures} captures, each gradient graph recording "
            f"{step_graph_launches(model.use_slow_fast)}; capture s "
            + ", ".join(f"{k} {v:.3f}" for k, v in cell["capture_s"].items()))
        del recs, tr, runner
        if infer_check:
            got = pipes[0].infer_sequence(clip)
            eager = pipeline_mod.Pipeline(model, pipes[0].transform, superchunk=SC, graphs=False)
            check(same_detections(got, eager.infer_sequence(clip)) and pipes[0].graphs.captures == inference_captures,
                  "train graphs: inference graphs did not replay the trained weights")
            log(f"train graphs: inference graphs captured before training replayed the trained weights, equal to an "
                f"eager pipeline bit for bit, no new capture; detections moved with training: "
                f"{not same_detections(got, before)}")
            cell.update(train_graph_timings(ra, train_mod, pipes[0], kw, calls))
        out[name] = cell
    out["osvos_reserved_gib"] = osvos_memory(train_mod, cells[1])
    return out


def train_graph_timings(ra, train_mod, pipe, kw, calls) -> dict:
    """Phase 12's launches, synchronizes, ms/step and memory on the
    unsupervised set-up (see `phase_train_graphs`)."""
    batch = calls[1][1]
    out = {"peak_gib": {}, "peak_reserved_gib": {}}

    def peaks(name, tr):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            tr.step(batch)
        torch.cuda.synchronize()
        out["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2**30
        out["peak_reserved_gib"][name] = torch.cuda.max_memory_reserved() / 2**30

    peaks("eager", train_mod.Trainer(pipe, graphs=False, **kw))
    tr = train_mod.Trainer(pipe, graphs=True, **kw)
    peaks("graphs, first steps (captures)", tr)
    peaks("graphs, warm", tr)
    log("train graphs: peak device memory allocated / reserved over 3 steps: " + ", ".join(
        f"{k} {out['peak_gib'][k]:.2f} / {out['peak_reserved_gib'][k]:.2f} GiB" for k in out["peak_gib"]))
    runner = tr.graphs

    def eager_step():
        tr.graphs = None
        try:
            tr.step(batch)
        finally:
            tr.graphs = runner

    ra.launches.clear()
    tr.step(batch)
    counts = {k: ra.launches[k] for k in (*LAUNCH_KEYS, "epilogue")}
    check(counts == step_graph_launches(True), f"train graphs: a warm graph step launched {counts}")
    out["warm_step_launches"] = {str(k): v for k, v in counts.items()}
    for name, fn in (("eager", eager_step), ("graphs", lambda: tr.step(batch))):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    log(f"train graphs: a warm graph step launched {launch_text(counts)}; the host's part of a warm step under sync "
        "debug \"error\" on both paths: no synchronize")
    timed = turns({"eager": eager_step, "graphs": lambda: tr.step(batch)}, TRAIN_TURNS)
    out["step_ms_runs"] = {k: [t * 1e3 for t in v] for k, v in timed.items()}
    out["step_ms"] = {k: statistics.median(v) for k, v in out["step_ms_runs"].items()}
    log(f"train graphs: in turns, ms/step " + "; ".join(
        f"{k} {out['step_ms'][k]:.2f} (runs {', '.join(f'{t:.2f}' for t in v)})" for k, v in out["step_ms_runs"].items()))
    return out


def osvos_memory(train_mod, cell) -> list:
    """Reserved device memory after each of OSVOS_SEQUENCES fine-tunes on
    graphs, one `Trainer` each (as `train_osvos_sequence` builds one per
    sequence), each dropped after its steps, the cache emptied."""
    _, pipes, kw, calls = cell
    start = {k: v.detach().clone() for k, v in pipes[0].model.state_dict().items()}
    reserved = []
    for _ in range(OSVOS_SEQUENCES):
        pipes[0].model.load_state_dict(start)
        tr = train_mod.Trainer(pipes[0], graphs=True, **kw)
        for _, batch in calls[:4]:
            tr.step(batch)
        torch.cuda.synchronize()
        del tr
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved() / 2**30)
    log("train graphs: reserved memory after each OSVOS sequence's trainer was dropped: "
        + ", ".join(f"{r:.2f}" for r in reserved) + " GiB")
    check(reserved[-1] <= reserved[0] + 0.25, "train graphs: reserved memory grows with OSVOS sequences")
    return reserved


# Phase 13: K6, SlowFast's train-mode BatchNorm, on phase 3's own inputs.
BN_OPS_FORWARD = 7  # f32 operations an element: x and x*x summed (3), (x - mean) * mul + beta (3), the ReLU (1)
BN_OPS_BACKWARD = 10  # xhat (2), dy' and dy' * xhat summed (3), the apply's two differences, product and scale (5)
# K6's device kernels by name: one a call each way.
BN_KERNELS = ("bn_forward_kernel", "bn_backward_kernel")


@contextlib.contextmanager
def keeping_bn_calls():
    """Within the block, every `batch_norm_train_fused` call keeps copies
    of its input, the module (by reference), its parameters and running
    statistics before the call, its ReLU flag, and the gradient its output
    receives in the backward: "dy" channels-last, and "dy_given" laid out
    as autograd hands it over (a channel slice of a wider channels-last
    tensor where it was one, at its channel offset), which the kernels are
    held and timed on."""
    from slowfast_vos_tpu_torch.ops import batch_norm as fused_bn

    orig = fused_bn.batch_norm_train_fused
    calls = []

    def keep(x, bn, relu=False, momentum=0.9):
        call = {"x": x.detach().clone(), "bn": bn, "relu": relu, "momentum": momentum,
                **{k: getattr(bn, k).detach().clone() for k in ("weight", "bias", "running_mean", "running_var")}}
        y = orig(x, bn, relu, momentum)

        def hook(g):
            stride = fused_bn.row_stride(g)
            call["dy_row_stride"], call["dy_strides"] = stride, g.stride()
            call["dy"] = g.detach().contiguous(memory_format=torch.channels_last)
            call["dy_given"] = call["dy"]
            if stride is not None and stride != g.shape[1]:  # a channel slice, at its own channel offset
                t, ch, h, w = g.shape
                off = g.storage_offset() % stride
                wide = torch.empty((t, stride, h, w), dtype=g.dtype, device=g.device,
                                   memory_format=torch.channels_last)
                call["dy_given"] = wide[:, off:off + ch]
                call["dy_given"].copy_(g.detach())

        if y.requires_grad:
            y.register_hook(hook)
        calls.append(call)
        return y

    fused_bn.batch_norm_train_fused = keep
    try:
        yield calls
    finally:
        fused_bn.batch_norm_train_fused = orig


def bn_close(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, largest share of the tolerance) of a bf16 tensor
    against its plain version: one bf16 ulp at the larger magnitude plus
    1e-6 of the tensor's max (tests/test_torch_cuda.py::assert_bn_close:
    statistics summed in another order move an element by ~1e-7 of the
    tensor's scale)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    big = torch.maximum(got.abs(), want.abs()).clamp(min=2.0**-126)
    tol = torch.exp2(torch.floor(torch.log2(big)) - 7) + 1e-6 * want.abs().max()
    return float(diff.max()), float((diff / tol).max())


def bn_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def bn_bounds(x: torch.Tensor) -> dict:
    """Least times of K6 on this input on an H100, each the larger of bytes
    over the memory rate and f32 operations over the f32 rate: the forward
    reads x and the [C] parameters and running statistics once and writes
    y, the [4, C] statistics and the running statistics once; the backward
    reads dy, x, the statistics, weight and bias once and writes dx, dweight
    and dbias once. Also the least time of the three-kernel design K6 had
    before its one-launch redesign (commit 3c9e5ba), which read x twice in
    the forward and x and dy twice in the backward."""
    c, rows, elem = x.shape[1], x.numel() // x.shape[1], x.element_size()
    plane = rows * c * elem
    fwd_bytes, bwd_bytes = 2 * plane + 14 * c * 4, 3 * plane + 8 * c * 4
    out = {}
    for name, nbytes, ops, passes in (("forward", fwd_bytes, BN_OPS_FORWARD, 3), ("backward", bwd_bytes, BN_OPS_BACKWARD, 5)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, rows * c * ops / F32_FLOP_PER_S * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "two_pass_bound_ms": passes * plane / HBM_BYTES_PER_S * 1e3}
    return out


def library_batch_norm(call: dict):
    """(forward, backward) closures of `F.batch_norm(training=True)` on the
    call's input, f32 parameters and copies of its running statistics
    (no ReLU: one PyTorch call; its running update puts the unbiased
    variance in, so it is a yardstick only), the backward through autograd
    on a kept graph."""
    x = call["x"].detach().requires_grad_(True)
    # f32 parameters with a bf16 input, as K6 takes them (PyTorch's own
    # mixed-type BatchNorm).
    w, b = (call[k].clone().requires_grad_(True) for k in ("weight", "bias"))
    rm, rv = call["running_mean"].clone(), call["running_var"].clone()
    fwd = lambda: torch.nn.functional.batch_norm(x, rm, rv, w, b, True, 0.1, call["bn"].eps)  # noqa: E731
    y = fwd()
    bwd = lambda: torch.autograd.grad(y, (x, w, b), call["dy"], retain_graph=True)  # noqa: E731
    return fwd, bwd


def bn_device_kernels(fused_bn, calls: list) -> dict:
    """The device kernels by name that one forward and one backward call of
    K6 on each kept call run (torch.profiler around the whole set each way).
    The profiler can lose device events, so a trace with fewer kernels than
    calls is taken again, up to five times; one with more, or with another
    kernel, stands."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    running = [(c["running_mean"].clone(), c["running_var"].clone()) for c in calls]
    stats = [fused_bn.batch_norm_forward_cuda(c["x"], c["weight"], c["bias"], *r, c["bn"].eps, 0.9, c["relu"])[1]
             for c, r in zip(calls, running)]
    runs = {
        "forward": lambda: [fused_bn.batch_norm_forward_cuda(c["x"], c["weight"], c["bias"], *r, c["bn"].eps, 0.9,
                                                             c["relu"]) for c, r in zip(calls, running)],
        "backward": lambda: [fused_bn.batch_norm_backward_cuda(c["dy_given"], c["x"], s, c["weight"], c["bias"],
                                                               c["relu"]) for c, s in zip(calls, stats)],
    }
    out = {}
    for (d, fn), name in zip(runs.items(), BN_KERNELS):
        for _ in range(5):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            counts = collections.Counter(
                next((n for n in BN_KERNELS if n in e.name), e.name) for e in prof.events()
                if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset")))
            if counts == {name: len(calls)} or sum(counts.values()) > len(calls):
                break
        out[d] = dict(counts)
    return out


def phase_bn(pipeline_mod, train_mod, data, counts: dict) -> list:
    """K6 on phase 3's own BatchNorm inputs: one eager step of phase 3's
    set-up (the same seeded model and window) keeps every call of
    `batch_norm_train_fused` (8 BatchNorms x 4 FPN levels), its input and
    the gradient its output receives. Per call, in bf16 as the step runs
    it: the forward kernel against `batch_norm_train_plain` (mean and the
    running statistics rel 1e-5 of each tensor's max; var, the difference
    of two f32 means of magnitude E[x^2], within 1e-5 of the largest
    E[x^2]) and the statistics in float64 (mean and var within 1e-6 of each
    channel's E[x^2], 16 f32 ulps of the terms), and against
    `batch_norm_normalize` of the kernel's own statistics (y: one bf16 ulp,
    `bn_close`); the backward kernel against
    `batch_norm_train_backward_plain` on the same inputs (dx by `bn_close`,
    dweight and dbias rel 1e-4). Then device times (CUDA events behind a
    spin) of the kernels, the plain versions and `F.batch_norm`, forward
    and backward, per call at P2's `bn_s1` and summed over the 32, against
    the bounds. Returns the records "bn" and "bn_backward"."""
    from slowfast_vos_tpu_torch.models import slowfast as sf
    from slowfast_vos_tpu_torch.ops import batch_norm as fused_bn

    pipe, model, trainer, batch, _ = full_width_trainer(pipeline_mod, train_mod, data)
    trainer.graphs = None  # a replay calls no Python: the step that keeps the calls runs eagerly
    names = {id(m): n for n, m in model.named_modules()}
    with keeping_bn_calls() as calls:
        trainer.step(batch)
        torch.cuda.synchronize()
    check(len(calls) == BN_PER_STEP and all("dy" in c for c in calls),
          f"bn: {len(calls)} calls kept, {sum('dy' in c for c in calls)} with a gradient; {BN_PER_STEP} expected")
    log(f"bn: {len(calls)} calls of one step kept, {sum(c['x'].numel() for c in calls) / 1e6:.1f} M elements; "
        f"the gradients' layouts at P2 (name, C, row stride or None, strides): "
        + "; ".join(f"{names[id(c['bn'])]} {c['x'].shape[1]} {c['dy_row_stride']} {c['dy_strides']}" for c in calls[:8])
        + " (a row stride above C: a channel slice from the backward of a cat)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in calls:
        x = c["x"]
        rows, ch, bf16 = x.numel() // x.shape[1], x.shape[1], x.dtype == torch.bfloat16
        c["plans"] = {"forward": fused_bn.plan(rows, ch, bf16, None, sms),
                      "backward": fused_bn.plan(rows, ch, bf16, c["dy_row_stride"], sms)}
    log("bn: each call's bytes (x) and plan each way (route, grid, slots of a CTA's tiles): " + "; ".join(
        f"{names[id(c['bn'])]} {list(c['x'].shape)} {c['x'].numel() * c['x'].element_size() / 1e6:.2f} MB "
        + ", ".join(f"{d} {p.route} {p.grid} {p.slots}/{-(-p.tiles // p.grid)}" for d, p in c["plans"].items())
        for c in calls))
    err = {"y": 0.0, "dx": 0.0}
    share = {"y": 0.0, "dx": 0.0}
    rel = {"mean": 0.0, "var": 0.0, "running": 0.0, "dweight": 0.0, "dbias": 0.0}
    exact = {"kernel": 0.0, "plain": 0.0}  # largest |stat - float64 stat| / E[x^2] of mean and var
    with torch.no_grad():
        for c in calls:
            x, relu, w, b = c["x"], c["relu"], c["weight"], c["bias"]
            rm, rv = c["running_mean"].clone(), c["running_var"].clone()
            y, stats = fused_bn.batch_norm_forward_cuda(x, w, b, rm, rv, c["bn"].eps, c["momentum"], relu)
            plain = torch.nn.BatchNorm3d(x.shape[1], eps=c["bn"].eps).cuda()
            for k in ("weight", "bias", "running_mean", "running_var"):
                getattr(plain, k).copy_(c[k])
            _, want_stats = sf.batch_norm_train_plain(x, plain, c["momentum"], relu)
            e, sh = bn_close(y, sf.batch_norm_normalize(x, stats, w, b, relu))
            err["y"], share["y"] = max(err["y"], e), max(share["y"], sh)
            xd = x.double()
            mean64 = xd.mean(dim=(0, 2, 3))
            ex2 = (xd * xd).mean(dim=(0, 2, 3))
            var64 = (ex2 - mean64 * mean64).clamp(min=0)
            for side, st in (("kernel", stats), ("plain", want_stats)):
                off = torch.maximum((st[0].double() - mean64).abs(), (st[1].double() - var64).abs()) / ex2
                exact[side] = max(exact[side], float(off.max()))
            del xd
            rel["mean"] = max(rel["mean"], bn_rel(stats[0], want_stats[0]))
            rel["var"] = max(rel["var"], float((stats[1] - want_stats[1]).abs().max() / ex2.max()))
            rel["running"] = max(rel["running"], bn_rel(rm, plain.running_mean), bn_rel(rv, plain.running_var))
            dx, dw, db = fused_bn.batch_norm_backward_cuda(c["dy_given"], x, stats, w, b, relu)
            want_dx, want_dw, want_db = sf.batch_norm_train_backward_plain(c["dy"], x, stats, w, b, relu)
            e, sh = bn_close(dx, want_dx)
            err["dx"], share["dx"] = max(err["dx"], e), max(share["dx"], sh)
            rel["dweight"], rel["dbias"] = max(rel["dweight"], bn_rel(dw, want_dw)), max(rel["dbias"], bn_rel(db, want_db))
    log(f"bn: kernels against the plain versions over the {len(calls)} calls: y max abs err {err['y']:.3e} "
        f"({share['y']:.3f} of one bf16 ulp + 1e-6 max), dx {err['dx']:.3e} ({share['dx']:.3f}); rel err mean "
        f"{rel['mean']:.2e}, var {rel['var']:.2e} (of the largest E[x^2]), running statistics {rel['running']:.2e} "
        f"(tol 1e-5), dweight {rel['dweight']:.2e}, dbias {rel['dbias']:.2e} (tol 1e-4); against float64 statistics, "
        f"largest error / E[x^2]: kernel {exact['kernel']:.2e} (tol 1e-6), plain {exact['plain']:.2e}")
    check(share["y"] <= 1 and share["dx"] <= 1, "bn: a kernel's output disagrees with its plain version")
    check(max(rel["mean"], rel["var"], rel["running"]) <= 1e-5 and max(rel["dweight"], rel["dbias"]) <= 1e-4
          and exact["kernel"] <= 1e-6, "bn: the kernels' statistics or parameter gradients disagree with the plain versions")

    def timings(c) -> dict:
        x, relu, w, b = c["x"], c["relu"], c["weight"], c["bias"]
        rm, rv = c["running_mean"].clone(), c["running_var"].clone()
        _, stats = fused_bn.batch_norm_forward_cuda(x, w, b, rm, rv, c["bn"].eps, c["momentum"], relu)
        plain = torch.nn.BatchNorm3d(x.shape[1], eps=c["bn"].eps).cuda()
        lib_fwd, lib_bwd = library_batch_norm(c)
        with torch.no_grad():
            out = {
                "ms": device_ms(lambda: fused_bn.batch_norm_forward_cuda(x, w, b, rm, rv, c["bn"].eps, 0.9, relu)),
                "backward_ms": device_ms(lambda: fused_bn.batch_norm_backward_cuda(c["dy_given"], x, stats, w, b, relu)),
                "plain_ms": device_ms(lambda: sf.batch_norm_train_plain(x, plain, 0.9, relu)),
                "plain_backward_ms": device_ms(
                    lambda: sf.batch_norm_train_backward_plain(c["dy"], x, stats, w, b, relu)),
            }
        out["library_ms"], out["library_backward_ms"] = device_ms(lib_fwd), device_ms(lib_bwd)
        return out

    per_call = []
    for c in calls:
        t = timings(c)
        t.update({"name": names[id(c["bn"])], "shape": list(c["x"].shape), "relu": c["relu"],
                  "bounds": bn_bounds(c["x"]), "bytes": c["x"].numel() * c["x"].element_size(),
                  "plan": {d: {"route": p.route, "grid": p.grid, "slots": p.slots, "tiles": p.tiles}
                           for d, p in c["plans"].items()}})
        per_call.append(t)
    big = max(range(len(calls)), key=lambda i: calls[i]["x"].numel())
    top = per_call[big]
    c = calls[big]
    rm, rv = c["running_mean"].clone(), c["running_var"].clone()
    _, stats = fused_bn.batch_norm_forward_cuda(c["x"], c["weight"], c["bias"], rm, rv, c["bn"].eps, 0.9, c["relu"])
    top["kernels_ms"], _ = kernel_ms_by_name(lambda: fused_bn.batch_norm_forward_cuda(
        c["x"], c["weight"], c["bias"], rm, rv, c["bn"].eps, 0.9, c["relu"]), BN_KERNELS[:1])
    top["backward_kernels_ms"], _ = kernel_ms_by_name(lambda: fused_bn.batch_norm_backward_cuda(
        c["dy_given"], c["x"], stats, c["weight"], c["bias"], c["relu"]), BN_KERNELS[1:])
    log(f"time: bn {top['name']} by kernel (torch.profiler), forward: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in top["kernels_ms"].items()) + "; backward: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in top["backward_kernels_ms"].items()))
    device_kernels = bn_device_kernels(fused_bn, calls)
    log("bn: device kernels over the step's calls, by name (torch.profiler): forward "
        + ", ".join(f"{k} {v}" for k, v in device_kernels["forward"].items()) + "; backward "
        + ", ".join(f"{k} {v}" for k, v in device_kernels["backward"].items()))
    for d, name in zip(("forward", "backward"), BN_KERNELS):
        check(device_kernels[d] == {name: len(calls)},
              f"bn: {len(calls)} {d} calls ran {device_kernels[d]} on the device; one {name} a call expected")
    total = {k: sum(t[k] for t in per_call) for k in ("ms", "backward_ms", "plain_ms", "plain_backward_ms",
                                                      "library_ms", "library_backward_ms")}
    for d in ("forward", "backward"):
        for k in ("bound_ms", "two_pass_bound_ms"):
            total[f"{d}_{k}"] = sum(t["bounds"][d][k] for t in per_call)
    log(f"time: bn {top['name']} {top['shape']} bf16: forward {top['ms']:.4f} ms (plain {top['plain_ms']:.4f}, "
        f"F.batch_norm {top['library_ms']:.4f}; bound {top['bounds']['forward']['bound_ms']:.4f}, two-pass "
        f"{top['bounds']['forward']['two_pass_bound_ms']:.4f}), backward {top['backward_ms']:.4f} ms (plain "
        f"{top['plain_backward_ms']:.4f}, F.batch_norm's {top['library_backward_ms']:.4f}; bound "
        f"{top['bounds']['backward']['bound_ms']:.4f}, two-pass {top['bounds']['backward']['two_pass_bound_ms']:.4f})")
    log(f"time: bn summed over the step's {len(calls)} calls: forward {total['ms']:.4f} ms (plain {total['plain_ms']:.4f}, "
        f"F.batch_norm {total['library_ms']:.4f}; bound {total['forward_bound_ms']:.4f}, two-pass "
        f"{total['forward_two_pass_bound_ms']:.4f}), backward {total['backward_ms']:.4f} ms (plain "
        f"{total['plain_backward_ms']:.4f}, F.batch_norm's {total['library_backward_ms']:.4f}; bound "
        f"{total['backward_bound_ms']:.4f}, two-pass {total['backward_two_pass_bound_ms']:.4f})")
    common = {"route": "cuda", "source": "slowfast_vos_tpu_torch/csrc/batch_norm.cu",
              "replaces": "slowfast_vos_tpu/models/slowfast.py:209",
              "replaces_note": "flax nn.BatchNorm(use_running_average=False) at slowfast.py:209-214 and :226-231, "
                               "computed by XLA; there is no Pallas kernel for it",
              "call": {"name": top["name"], "shape": top["shape"], "dtype": "bfloat16"}}
    fwd_b, bwd_b = top["bounds"]["forward"], top["bounds"]["backward"]
    return [
        {"name": "bn", **common, "launches": counts["bn"], "max_abs_err": err["y"], "ms": top["ms"],
         "plain_ms": top["plain_ms"], "bound_ms": fwd_b["bound_ms"], "bound_by": fwd_b["bound_by"],
         "library_ms": top["library_ms"], "two_pass_bound_ms": fwd_b["two_pass_bound_ms"],
         "step": {k: total[k] for k in ("ms", "plain_ms", "library_ms", "forward_bound_ms",
                                        "forward_two_pass_bound_ms")},
         "stats_rel_err": {k: rel[k] for k in ("mean", "var", "running")},
         "stats_err_against_float64": exact, "per_call": per_call},
        {"name": "bn_backward", **common, "launches": counts[("backward", "bn")], "max_abs_err": err["dx"],
         "ms": top["backward_ms"], "plain_ms": top["plain_backward_ms"], "bound_ms": bwd_b["bound_ms"],
         "bound_by": bwd_b["bound_by"], "library_ms": top["library_backward_ms"],
         "two_pass_bound_ms": bwd_b["two_pass_bound_ms"],
         "step": {k: total[k] for k in ("backward_ms", "plain_backward_ms", "library_backward_ms",
                                        "backward_bound_ms", "backward_two_pass_bound_ms")},
         "param_grad_rel_err": {k: rel[k] for k in ("dweight", "dbias")}},
    ]


K7_SHAPES = {"global": (1, 64), "window": (25, 14)}  # (windows a frame, grid side) of ViTDet-B's blocks
K7_FRAMES = 34  # a first superchunk's frames through the backbone


def k7_inputs(patt, frames: int, windows: int, grid: int, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((frames * windows, grid * grid, 3, 12, 64), generator=g, device="cuda").bfloat16()
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    tables = [0.1 * torch.randn((2 * grid - 1, 64), generator=g, device="cuda") for _ in range(2)]
    return (q, k, v, *patt.rel_pos_terms(q, *tables, (grid, grid)))


def k7_bound_ms(windows: int, grid: int) -> tuple[float, str]:
    """K7's least time a frame: 12 heads x windows of N tokens, 4 N^2 64
    operations and 2 N^2 bias adds a head at 989 TFLOP/s, against q, k, v,
    o and both terms read or written once (bf16) at 3.35 TB/s."""
    n, heads = grid * grid, 12 * windows
    ops = heads * (4 * n * n * 64 + 2 * n * n)
    nbytes = heads * (4 * n * 64 + 2 * n * grid) * 2
    flops_ms, bytes_ms = ops / 989e12 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(flops_ms, bytes_ms), ("operations" if flops_ms > bytes_ms else "bytes")


def phase_k7() -> list:
    """Phase 14 (module docstring). Returns the records "k7_global" and
    "k7_window"."""
    from slowfast_vos_tpu_torch.ops import attention as patt

    records = []
    for kind, (windows, grid) in K7_SHAPES.items():
        small = k7_inputs(patt, 2, windows, grid)
        before = patt.launches["attention", kind]
        got = patt.attention(*small, 0.125, kind)
        check(patt.launches["attention", kind] == before + 1, f"k7 {kind}: one launch a call")
        want = patt.attention_plain(*(t.float() for t in small), 0.125)
        err = float((got.float() - want).abs().max())
        check(err <= 1e-2 + 2.0**-7 * float(want.abs().max()), f"k7 {kind}: max abs error {err}")
        by_name, per_call = kernel_ms_by_name(lambda: patt.attention(*small, 0.125, kind), ("k7_rel_pos_attention",))
        check(per_call == 1, f"k7 {kind}: {per_call} device kernels a call")
        full = k7_inputs(patt, K7_FRAMES, windows, grid, seed=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = patt.attention(*full, 0.125, kind)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - base
        check(grown <= out.numel() * out.element_size() + (1 << 20), f"k7 {kind}: allocated {grown} B")
        del out
        ms = device_ms(lambda: patt.attention(*full, 0.125, kind), runs=10) / K7_FRAMES
        bound, bound_by = k7_bound_ms(windows, grid)
        plain_ms = device_ms(lambda: patt.attention_plain(*small, 0.125), runs=3) / 2
        b, heads, n, _ = small[0].shape
        bias = (small[3][..., :, None] + small[4][..., None, :]).reshape(b, heads, n, n)
        library_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            small[0], small[1], small[2], attn_mask=bias, scale=0.125), runs=5) / 2
        del bias
        records.append({"name": f"k7_{kind}", "shape": [K7_FRAMES * windows, 12, grid * grid, 64],
                        "max_abs_err": err, "kernels_by_name": by_name,
                        "ms_per_frame": ms, "bound_ms_per_frame": bound, "bound_by": bound_by,
                        "roofline_pct": 100 * bound / ms, "plain_ms_per_frame": plain_ms,
                        "library_ms_per_frame": library_ms, "peak_extra_bytes": grown})
        log(json.dumps(records[-1]))
    return records


K8_FRAMES = 34  # a first superchunk's frames through the backbone
K8_LAYER1_CONV3 = (K8_FRAMES, 256, 192, 336)  # the shape the 80% aim is set at


def k8_calls(pce, frames: int = K8_FRAMES) -> list:
    """Each K8 call of one folded backbone forward at 768x1344, in order:
    (name, [N, C, H, W], residual, relu), kept from the wrapper on the
    backbone itself, and the launches the forward counted."""
    from slowfast_vos_tpu_torch.models.resnet_fpn import ResNet50FPN

    model = ResNet50FPN(torch.bfloat16).cuda()
    calls, wrapped = [], pce.conv_epilogue_cuda

    def keeping(x, bias, residual=None, relu=False, inplace=False):
        calls.append((tuple(x.shape), residual is not None, relu))
        return wrapped(x, bias, residual, relu, inplace)

    pce.conv_epilogue_cuda = keeping
    try:
        before = pce.launches["epilogue"]
        with torch.inference_mode():
            model(torch.zeros((frames, *CANVAS, 3), device="cuda"))
        torch.cuda.synchronize()
        launched = pce.launches["epilogue"] - before
    finally:
        pce.conv_epilogue_cuda = wrapped
    del model
    return calls, launched


def phase_k8() -> list:
    """Phase 15 (module docstring). Returns the records "k8" (the
    superchunk's 61 calls summed) and "k8_layer1_conv3"."""
    from slowfast_vos_tpu_torch.ops import conv_epilogue as pce

    calls, launched = k8_calls(pce)
    check(len(calls) == launched == K8_PER_BACKBONE,
          f"k8: {len(calls)} calls kept, {launched} launches, {K8_PER_BACKBONE} expected")
    check(calls.count((K8_LAYER1_CONV3, True, True)) == 3, "k8: layer1's three conv3 calls at [34, 256, 192, 336]")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(shape, residual):
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16().contiguous(memory_format=torch.channels_last)
        res = torch.randn(shape, generator=gen, device="cuda").bfloat16().contiguous(
            memory_format=torch.channels_last) if residual else None
        return x, 0.1 * torch.randn(shape[1], generator=gen, device="cuda"), res

    def beyond_one_ulp(x, bias, res, relu) -> int:
        """Elements where K8 and its plain version differ by more than one bf16 ulp."""
        want = pce.conv_epilogue_plain(x, bias, res, relu).float()
        got = pce.conv_epilogue_cuda(x, bias, res, relu).float()
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs()).clamp(min=2.0**-126))) - 7)
        return int(((got - want).abs() > ulp).sum())

    x, bias, res = inputs(K8_LAYER1_CONV3, True)
    by_name, per_call = kernel_ms_by_name(lambda: pce.conv_epilogue_cuda(x, bias, res, True, inplace=True),
                                          ("k8_conv_epilogue_kernel",))
    check(per_call == 1, f"k8: {per_call} device kernels a call")
    del x, bias, res

    def yardstick(x, scale, shift, residual, relu):
        y = x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu else y

    rows, totals = [], collections.Counter()
    for shape in dict.fromkeys(calls):
        (n, c, h, w), residual, relu = shape
        x, bias, res = inputs((n, c, h, w), residual)
        beyond = beyond_one_ulp(x, bias, res, relu)
        check(beyond == 0, f"k8: {beyond} elements beyond one bf16 ulp of the plain version at {shape}")
        scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        count = calls.count(shape)
        nbytes = x.numel() * x.element_size() * (3 if residual else 2)
        row = {"shape": [n, c, h, w], "residual": residual, "relu": relu, "calls": count, "within_ulps": 1,
               "ms": device_ms(lambda: pce.conv_epilogue_cuda(x, bias, res, relu, inplace=True), runs=10),
               "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
               "plain_ms": device_ms(lambda: pce.conv_epilogue_plain(x, bias, res, relu), runs=3),
               "yardstick_ms": device_ms(lambda: yardstick(x, scale, bias, res, relu), runs=5)}
        row["roofline_pct"] = 100 * row["bound_ms"] / row["ms"]
        for key in ("ms", "bound_ms", "plain_ms", "yardstick_ms"):
            totals[key] += count * row[key]
        rows.append(row)
        del x, bias, res
    layer1 = next(r for r in rows if tuple(r["shape"]) == K8_LAYER1_CONV3 and r["residual"])
    records = [
        {"name": "k8", "frames": K8_FRAMES, "calls": len(calls), "launches": launched,
         "ms_per_superchunk": totals["ms"], "ms_per_frame": totals["ms"] / K8_FRAMES,
         "bound_ms_per_frame": totals["bound_ms"] / K8_FRAMES, "roofline_pct": 100 * totals["bound_ms"] / totals["ms"],
         "plain_ms_per_frame": totals["plain_ms"] / K8_FRAMES,
         "yardstick_ms_per_frame": totals["yardstick_ms"] / K8_FRAMES, "per_shape": rows},
        {"name": "k8_layer1_conv3", "shape": list(K8_LAYER1_CONV3), "kernels_by_name": by_name,
         **{k: layer1[k] for k in ("within_ulps", "ms", "bound_ms", "roofline_pct", "plain_ms", "yardstick_ms")}},
    ]
    for r in records:
        log(json.dumps(r))
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    import slowfast_vos_tpu_torch
    from slowfast_vos_tpu_torch import data
    from slowfast_vos_tpu_torch import train as train_mod
    from slowfast_vos_tpu_torch.models import config as cfg_mod
    from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod
    from slowfast_vos_tpu_torch.ops import cuda_build, nms
    from slowfast_vos_tpu_torch.ops import roi_align as ra

    # The port under test is the one beside this script, not an installed copy.
    here = Path(__file__).resolve().parent
    check(Path(slowfast_vos_tpu_torch.__file__).resolve().parents[1] == here,
          f"slowfast_vos_tpu_torch was imported from outside {here}")

    # f32 comparisons are full f32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    phase_build(cuda_build)
    counts, main_rois, main_nms = phase_main(ra, pipeline_mod)
    train, train_rois, train_nms = phase_train(ra, pipeline_mod, train_mod, data)
    errs = phase_kernels(ra, main_rois)
    bwd_errs = phase_backward_kernels(ra, train_rois)
    nms_err = phase_nms_kernel(nms, main_nms, train_nms)
    phase_reference(pipeline_mod)
    phase_train_reference(pipeline_mod, train_mod, data, cfg_mod)
    records = phase_timings(ra, errs, counts, main_rois)
    for r, out_size in zip(records, (7, 14)):
        r["train_launches"] = train["counts"][out_size]
    records += backward_timings(ra, bwd_errs, train["counts"], train_rois)
    records.append(nms_timings(nms, nms_err, counts, main_nms, train_nms))
    records[-1]["train_launches"] = train["counts"]["nms"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drivers_", dir=cuda_build.BUILD_DIR) as workdir:
        drivers = phase_drivers(ra, pipeline_mod, train_mod, data, Path(workdir))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_", dir=cuda_build.BUILD_DIR) as cli_dir:
        cli = phase_cli(ra, data, Path(cli_dir))
        log(f"cli: phase 8 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_", dir=cuda_build.BUILD_DIR) as workdir:
        parallel = phase_parallel(ra, pipeline_mod, train_mod, data, Path(workdir))
    parallel["walls_s"]["phase"] = time.perf_counter() - t0
    log(f"parallel: phase 9 in {parallel['walls_s']['phase']:.1f} s (two ranks on one card: correctness and "
        f"overhead, not scaling)")
    t0 = time.perf_counter()
    nms_blocked = phase_nms_blocked()
    log(f"nms blocked: phase 10 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    graphs = phase_graphs(ra, pipeline_mod)
    log(f"graphs: phase 11 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_graphs = phase_train_graphs(ra, pipeline_mod, train_mod, data)
    log(f"train graphs: phase 12 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records += phase_bn(pipeline_mod, train_mod, data, train["counts"])
    log(f"bn: phase 13 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k7 = phase_k7()
    log(f"k7: phase 14 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k7 += phase_k8()
    log(f"k8: phase 15 in {time.perf_counter() - t0:.1f} s")
    for r in records:
        size = 7 if r["name"].endswith("pool7") else 14
        key = {"nms": "nms", "bn": "bn", "bn_backward": ("backward", "bn")}.get(
            r["name"], ("backward", size) if "backward" in r["name"] else size)
        r["drivers_launches"] = {name: c[key] for name, c in drivers["counts"].items()}
        r["cli_launches"] = {name: c[key] for name, c in cli["counts"].items()}
        r["parallel_launches"] = {name: c[key] if key in c else c[str(key)] for name, c in parallel["counts"].items()}
        r["train_graph_step_launches"] = train_graphs["unsupervised"]["warm_step_launches"][str(key)]

    log(json.dumps({"train_step": {k: train[k] for k in ("step_ms", "step_times_ms", "peak_gib")}}))
    log(json.dumps({"drivers": {k: v for k, v in drivers.items() if k != "counts"}}))
    log(json.dumps({"cli": {k: v for k, v in cli.items() if k != "counts"}}))
    log(json.dumps({"parallel": {k: v for k, v in parallel.items() if k != "counts"}}))
    log(json.dumps({"nms_blocked": nms_blocked}))
    log(json.dumps({"graphs": graphs}))
    log(json.dumps({"train_graphs": train_graphs}))
    log(json.dumps({"kernels": records + k7}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["k7"]:
        sys.exit(0 if torch.cuda.is_available() and phase_k7() else 1)
    if sys.argv[1:2] == ["k8"]:
        sys.exit(0 if torch.cuda.is_available() and phase_k8() else 1)
    if sys.argv[1:2] == [PARALLEL_WORKER]:
        sys.exit(parallel_worker(sys.argv[2], sys.argv[3], Path(sys.argv[4])))
    sys.exit(main())
