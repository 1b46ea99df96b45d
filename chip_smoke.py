#!/usr/bin/env python3
"""Drive the PyTorch port of SlowFast Mask R-CNN on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   - compile every hand-written kernel of `slowfast_vos_tpu_torch/csrc`
             with nvcc (one process per source, all started together), with
             each kernel's registers and spills;
2. main    - `build_pipeline(3, 3, (480, 854), bf16)` with seeded random
             weights, `infer_sequence` over a 20-frame clip (first, carry and
             ragged-tail superchunks), launch counts read around that run,
             frames/s, peak device memory; one superchunk's real proposals
             and detection boxes are kept for phases 4 and 6;
3. train   - `Trainer` on the same full-width model (default
             DetectionConfig: 2000 proposals, 512 box and 128 mask rois per
             frame), 8 steps on one seeded window of moving blobs from
             `train_windows` (2 centre frames + halo), launch counts read
             around those steps (forward and backward kernel at both pools
             in every step), finite losses, trainable weights moved, frozen
             ones and FrozenBatchNorm buffers bit-identical, SlowFast running
             statistics moved, ms/step and peak device memory, then
             `infer_sequence` on the trained model; the first step's sampled
             rois are kept for phases 4 and 6;
4. kernels - hold each kernel against its plain PyTorch version at the main
             path's shapes (DAVIS 480x854 -> 768x1344 canvas, superchunk 8:
             [8, 1000] proposals for the 7x7 pool, [8, 10] detections for the
             14x14 pool, 256 channels), in f32 (TF32 off) and bf16, on
             synthetic rois with the edge cases and on the main path's own
             rois, and at 40 channels on the synthetic rois; the backward
             kernel likewise at the train path's shapes ([2, 512] and
             [2, 128] rois), per pixel against the plain backward, and
             bitwise equal over two calls on the train path's rois;
5. reference - a small f32 input through the same entry point on the card
             and on the CPU (the plain versions), compared; and tiny f32
             train steps on both, same weights and draws: the default
             freeze, OSVOS's SF (the backbone trains) and the pretrain
             Mask R-CNN (no SlowFast, trainable_backbone_layers 3);
6. timings - each kernel on both roi sets, with and without the level
             assignment, against its bound and its plain version (the
             forward also against its per-roi footprint);
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
10. transport and stem - at phase 2's width, clip and weights: the YUV
             4:2:0 transport (`infer_sequence(transport="yuv420")`, launch
             counts read around it, its peak memory, frames/s against rgb
             (median of 3 warm runs in turns), bytes uploaded per chunk for
             each), `from_yuv420` on the card against the CPU (f32, atol
             1e-4) and phase 5's input as planes, card against CPU; the
             space-to-depth stem: the s2d backbone with a remapped conv1
             against the 7x7 one in f32 (TF32 off), a full-width
             `build_pipeline(s2d_stem=True)` inference (launch counts), both
             stems' `backbone_feats` at [SC + 2, 768, 1344] (CUDA events,
             median of 10 in turns), phase 8's 7x7 checkpoint through
             `load_init` into an s2d model; the blocked NMS against the
             fixpoint at N = 8192 (index-exact, both times); and
             `torch_bench.py --transport yuv420 --runs 2`.

Prints one JSON line of kernel records, the card's name and power limit, and
as its last line {"ok": true, "device": {...}}. Exits non-zero, with no
result line, where CUDA is absent or any phase fails.
"""
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


def device_ms(fn, runs: int = 20) -> float:
    """Device time of one call of `fn`: CUDA events around `runs` calls
    queued back to back behind a spin kernel, so the host's launch overhead
    is hidden and the device runs the calls without gaps. Fails if the
    spin ended before the host had queued every call."""
    host_ms = call_ms(fn, runs=3, warmup=1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e6 * host_ms * runs) + 10**7)  # ~2 cycles/ns: twice the queueing time
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    check(not start.query(), "device_ms: the host queued the calls slower than the spin kernel ran")
    end.synchronize()
    return start.elapsed_time(end) / runs


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


def main_path_rois(pipeline_mod, pipe, clip) -> dict:
    """The rois of the first superchunk that `infer_sequence` pools: its
    proposals (7x7 pool) and its detection boxes (14x14 pool)."""
    with keeping_rois(pipeline_mod) as kept:
        pipe.infer_sequence(clip[:SC])
    return kept


def check_detections(dets: list, frames: int, d: int) -> None:
    """`infer_sequence`'s contract at DAVIS 480x854: one dict per frame, D
    finite detections with boxes on the frame, a union mask per frame."""
    check(len(dets) == frames, f"{len(dets)} frames out")
    for det in dets:
        check(det["boxes"].shape == (d, 4) and det["scores"].shape == (d,), "detection shapes")
        check(det["union_mask"].shape == (480, 854), "union mask shape")
        check(np.isfinite(det["boxes"]).all() and np.isfinite(det["scores"]).all(), "non-finite detections")
        check(((det["boxes"] >= 0) & (det["boxes"] <= [854 + 1e-3, 480 + 1e-3] * 2)).all(), "boxes off the frame")


def phase_main(ra, pipeline_mod) -> tuple[dict, dict]:
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
    counts = {k: ra.launches[k] for k in (7, 14)}
    log(f"main: infer_sequence 20 frames 480x854 3-3 bf16 superchunk {SC}: first run {first_s:.3f} s, "
        f"kernel launches pool7 {counts[7]}, pool14 {counts[14]}")
    check(counts[7] > 0 and counts[14] > 0, f"a RoIAlign pool bypassed the kernel: {counts}")

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
    rois = main_path_rois(pipeline_mod, pipe, clip)
    log(f"main: kept one superchunk's rois: proposals {tuple(rois[7].shape)}, detections {tuple(rois[14].shape)}")
    return counts, rois


def phase_reference(pipeline_mod, transport: str = "rgb") -> None:
    """A small f32 input through `forward_superchunk` on the card and on the
    CPU (plain versions, no kernel), same seeded weights, as RGB frames or
    (phase 10) as YUV 4:2:0 planes. Tolerances as in
    tests/test_torch_pipeline.py: valid flags and labels exact, boxes within
    0.05 px, scores within 1e-4, at most 1% of union-mask pixels differ."""
    outs = []
    images = np.random.default_rng(2).integers(0, 256, (6, 120, 200, 3), dtype=np.uint8)
    if transport == "yuv420":
        from slowfast_vos_tpu_torch.models.transform import rgb_to_yuv420

        images = tuple(map(torch.from_numpy, rgb_to_yuv420(images)))
    else:
        images = torch.from_numpy(images)
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
    log(f"reference: card vs CPU at 120x200 f32, {transport}: valid equal {np.array_equal(gv, cv)}, labels equal "
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


def phase_train(ra, pipeline_mod, train_mod, data) -> tuple[dict, dict]:
    """8 full-width train steps; returns (launch counts of those steps, the
    first step's sampled rois by output size)."""
    pipe, model, trainer, batch, clip = full_width_trainer(pipeline_mod, train_mod, data)
    log(f"train: window of {batch['images'].shape[0]} frames 480x854, {int(batch['gt_valid'].sum())} gt boxes, "
        f"feat_valid {batch['feat_valid'].tolist()}")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    keys = (7, 14, ("backward", 7), ("backward", 14))
    per_step, times = [], []
    with keeping_rois(train_mod.train_step) as kept:
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
    log(f"train: launches over {TRAIN_STEPS} steps: pool7 {counts[7]}, pool14 {counts[14]}, "
        f"backward pool7 {counts['backward', 7]}, backward pool14 {counts['backward', 14]}")
    for i, c in enumerate(per_step):
        check(all(v >= 1 for v in c.values()), f"step {i} bypassed a kernel: {c}")
    step_ms = statistics.median(times[1:])
    log(f"train: {step_ms:.2f} ms/step (median of steps 2-{TRAIN_STEPS}, synchronized), "
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
    log(f"train: kept the first step's rois: pool7 {tuple(kept[7].shape)}, pool14 {tuple(kept[14].shape)}")
    return {"counts": counts, "step_ms": step_ms, "step_times_ms": times, "peak_gib": peak / 2**30}, kept


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


@contextlib.contextmanager
def relu_branches(masks: list, replay: bool):
    """Record every ReLU's branch (input > 0) in call order, or replay
    recorded branches (output = input * branch): a ReLU whose input lies
    within the two devices' f32 drift of zero then takes the same side in
    both runs, and the gradients are comparable."""
    functional = torch.nn.functional
    orig = functional.relu
    it = iter(masks)

    def relu(x, inplace=False):
        if replay:
            return x * next(it).to(x.device)
        masks.append((x > 0).cpu())
        return orig(x)

    functional.relu = relu
    try:
        yield
    finally:
        functional.relu = orig
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


LAUNCH_KEYS = (7, 14, ("backward", 7), ("backward", 14))  # K1 and K5 at both pools


@contextlib.contextmanager
def launches_of(ra, counts: dict, name: str, required=LAUNCH_KEYS, tag: str = "drivers"):
    """Launch counts of K1 and K5 at both pools over the block, kept under
    `name`; those of `required` checked above zero."""
    ra.launches.clear()
    yield
    counts[name] = {k: ra.launches[k] for k in LAUNCH_KEYS}
    log(f"{tag}: {name}: launches pool7 {counts[name][7]}, pool14 {counts[name][14]}, backward pool7 "
        f"{counts[name]['backward', 7]}, backward pool14 {counts[name]['backward', 14]}")
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
    with launches_of(ra, counts, "train_maskrcnn"), timed_steps(train_mod) as step_ms:
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
    forward = (7, 14)

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
    out = run("pretrain", torch_pretrain_maskrcnn, ["--davis-root", train_root, "--output", pre, "--epochs", "1"])
    check(len(out["history"]) == 1 and np.isfinite(out["history"][0]["loss"]), f"pretrain history {out['history']}")
    # The proposal dump runs the backbone and the RPN only: no RoIAlign.
    out = run("pretrain --predict-boxes", torch_pretrain_maskrcnn,
              ["--davis-root", train_root, "--output", pre, "--predict-boxes", "--init-checkpoint", ckpt], required=())
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
    check(all(k in infer for k in ("metric", "value", "unit", "vs_baseline", "median", "runs", "config", "transport",
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
            required = ("7", "14") if name == "davis_evaluation" else tuple(str(k) for k in LAUNCH_KEYS)
            check(all(c[k] > 0 for k in required), f"{key} bypassed a kernel: {c}")
            log(f"parallel: {key}: launches pool7 {c['7']}, pool14 {c['14']}, backward pool7 "
                f"{c[str(('backward', 7))]}, backward pool14 {c[str(('backward', 14))]}")
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
    with launches_of(ra, out["counts"], "device_parallel_inference", required=(7, 14), tag="parallel"):
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

# Phase 10: the YUV 4:2:0 transport and the space-to-depth stem.
NMS_BLOCKED_N = 8192  # above FIXPOINT_MAX_N: where "auto" takes the blocked sweep
STEM_RUNS = 10


def turns(fns: dict, runs: int, events: bool = False) -> dict:
    """{name: [time of each call]} of `fns` called in turns `runs` times:
    seconds on the host clock, synchronized around each call, or with
    `events` device ms by CUDA events around each call."""
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            if events:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
    return times


def upload_bytes(dev_images) -> int:
    planes = dev_images if isinstance(dev_images, tuple) else (dev_images,)
    return sum(p.numel() * p.element_size() for p in planes)


def phase_transport_stem(ra, pipeline_mod, cli_dir: Path) -> dict:
    """The YUV 4:2:0 transport and the space-to-depth stem at full width
    (480x854, 3-3, bf16, superchunk 8, phase 2's 20-frame clip and
    weights): yuv420 inference (launches, contract, peak memory; frames/s
    against rgb in turns; bytes uploaded per chunk), the decode on the card
    against the CPU, phase 5's input as planes card against CPU, the s2d
    backbone with a remapped conv1 against the standard one in f32, the s2d
    pipeline's inference, both stems' `backbone_feats` in turns, phase 8's
    7x7 checkpoint into an s2d model, the blocked NMS against the fixpoint
    at N = 8192, and `torch_bench.py --transport yuv420 --runs 2`."""
    from scripts import torch_bench
    from slowfast_vos_tpu_torch.convert import load_init
    from slowfast_vos_tpu_torch.models.resnet_fpn import stem_weight_to_s2d
    from slowfast_vos_tpu_torch.models.transform import rgb_to_yuv420
    from slowfast_vos_tpu_torch.ops import nms
    from slowfast_vos_tpu_torch.utils.checkpoint import STEM_KEY, load_checkpoint, migrate_state_dict

    out, counts = {}, {}
    chunks = -(-20 // SC)
    pipe, model = pipeline_mod.build_pipeline(3, 3, DRIVER_HW, dtype=torch.bfloat16, device="cuda", superchunk=SC)
    pipeline_mod.init_weights(model, seed=0)
    clip = np.random.default_rng(1).integers(0, 256, (20, *DRIVER_HW, 3), dtype=np.uint8)  # phase 2's
    d = pipe.cfg.detections_per_img

    torch.cuda.reset_peak_memory_stats()
    with launches_of(ra, counts, "infer_sequence yuv420", (7, 14), tag="transport"):
        dets = pipe.infer_sequence(clip, transport="yuv420")
        torch.cuda.synchronize()
    out["peak_gib_yuv420"] = torch.cuda.max_memory_allocated() / 2**30
    check_detections(dets, 20, d)
    check(counts["infer_sequence yuv420"][7] == chunks and counts["infer_sequence yuv420"][14] == chunks,
          f"yuv420 inference: {chunks} launches of each pool expected")
    out["bytes_per_chunk"] = {
        transport: {"first": upload_bytes(pipe.chunk_inputs(clip, 0, False, transport)[0]),
                    "carry": upload_bytes(pipe.chunk_inputs(clip, SC, True, transport)[0])}
        for transport in pipeline_mod.TRANSPORTS
    }
    rgb_b, yuv_b = out["bytes_per_chunk"]["rgb"], out["bytes_per_chunk"]["yuv420"]
    check(all(2 * yuv_b[k] == rgb_b[k] for k in rgb_b), f"yuv420 is not half the bytes: {out['bytes_per_chunk']}")
    runs = turns({"rgb": lambda: pipe.infer_sequence(clip),
                  "yuv420": lambda: pipe.infer_sequence(clip, transport="yuv420")}, 3)
    out["frames_per_s"] = {k: 20 / statistics.median(v) for k, v in runs.items()}
    out["runs_s"] = runs
    log(f"transport: infer_sequence 20 frames 480x854 3-3 bf16 superchunk {SC}, warm runs in turns: "
        + "; ".join(f"{k} {', '.join(f'{r:.3f}' for r in v)} s -> {out['frames_per_s'][k]:.2f} frames/s"
                    for k, v in runs.items())
        + f"; bytes per chunk (first, carry) rgb {rgb_b['first']}, {rgb_b['carry']}, yuv420 {yuv_b['first']}, "
        f"{yuv_b['carry']}; peak device memory {out['peak_gib_yuv420']:.2f} GiB")

    y, uv = rgb_to_yuv420(clip[:SC])
    card = pipe.transform.from_yuv420(torch.from_numpy(y).cuda(), torch.from_numpy(uv).cuda()).cpu()
    cpu = pipe.transform.from_yuv420(torch.from_numpy(y), torch.from_numpy(uv))
    out["from_yuv420_max_abs_err"] = (card - cpu).abs().max().item()
    log(f"transport: from_yuv420 [{SC}, 480, 854] -> {tuple(card.shape)} f32, card vs CPU: max abs err "
        f"{out['from_yuv420_max_abs_err']:.3e} (tol 1e-4)")
    check(out["from_yuv420_max_abs_err"] <= 1e-4, "from_yuv420 on the card differs from the CPU")
    phase_reference(pipeline_mod, transport="yuv420")

    # The stems, f32 (TF32 off): the s2d backbone with the standard one's weights, conv1 remapped.
    std32, std32_model = pipeline_mod.build_pipeline(
        3, 3, (120, 200), min_size=128, max_size=256, dtype=torch.float32, device="cuda", superchunk=4)
    pipeline_mod.init_weights(std32_model, seed=0)
    _, s2d32_model = pipeline_mod.build_pipeline(
        3, 3, (120, 200), min_size=128, max_size=256, dtype=torch.float32, device="cuda", superchunk=4, s2d_stem=True)
    s2d32_model.load_state_dict(migrate_state_dict(std32_model.state_dict(), s2d32_model.state_dict()), strict=True)
    small = std32.transform(torch.from_numpy(  # phase 5's frames
        np.random.default_rng(2).integers(0, 256, (6, 120, 200, 3), dtype=np.uint8)).cuda())
    with torch.inference_mode():
        pairs = list(zip(s2d32_model.backbone_feats(small), std32_model.backbone_feats(small)))
    errs = [((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item() for a, b in pairs]
    out["s2d_vs_7x7_f32_err"] = max(errs)
    log(f"stem: s2d backbone (conv1 remapped) vs 7x7 at {tuple(small.shape)} f32 on the card: max abs err over "
        f"max(1, |level|) per level {', '.join(f'{e:.2e}' for e in errs)} (tol 1e-4)")
    check(out["s2d_vs_7x7_f32_err"] <= 1e-4, "the s2d stem disagrees with the 7x7 stem")

    s2d_pipe, s2d_model = pipeline_mod.build_pipeline(
        3, 3, DRIVER_HW, dtype=torch.bfloat16, device="cuda", superchunk=SC, s2d_stem=True)
    s2d_model.load_state_dict(migrate_state_dict(model.state_dict(), s2d_model.state_dict()), strict=True)
    with launches_of(ra, counts, "infer_sequence s2d stem", (7, 14), tag="stem"):
        s2d_dets = s2d_pipe.infer_sequence(clip)
        torch.cuda.synchronize()
    check_detections(s2d_dets, 20, d)
    check(counts["infer_sequence s2d stem"][7] == chunks and counts["infer_sequence s2d stem"][14] == chunks,
          f"s2d inference: {chunks} launches of each pool expected")
    rgb_dets = pipe.infer_sequence(clip)
    same = np.mean([np.array_equal(a["valid"], b["valid"]) for a, b in zip(s2d_dets, rgb_dets)])
    log(f"stem: s2d pipeline infer_sequence 20 frames at full width: valid flags equal to the 7x7 stem's in "
        f"{same:.2f} of frames (bf16: reported, not checked)")

    canvas = pipe.transform(torch.from_numpy(clip[: SC + 2]).cuda())
    feats = {"7x7": lambda: model.backbone_feats(canvas), "s2d": lambda: s2d_model.backbone_feats(canvas)}
    with torch.inference_mode():
        turns(feats, 2, events=True)
        stem_ms = turns(feats, STEM_RUNS, events=True)
    out["backbone_ms"] = {k: statistics.median(v) for k, v in stem_ms.items()}
    log(f"stem: backbone_feats [{SC + 2}, 768, 1344] bf16, device ms (CUDA events, median of {STEM_RUNS} in turns): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["backbone_ms"].items()))

    ckpt = cli_dir / "unsupervised" / "ckpt_best.pt"
    report = load_init(str(ckpt), s2d_model)
    w7 = load_checkpoint(str(ckpt))["model"][STEM_KEY]
    check(report["migrated"] == [STEM_KEY] and report["unused_source_keys"] == [] and report["untouched"] == [],
          f"phase 8's checkpoint did not load whole into the s2d model: {report['migrated']}, "
          f"{report['unused_source_keys'][:5]}, {report['untouched'][:5]}")
    check(torch.equal(s2d_model.state_dict()[STEM_KEY].cpu(), stem_weight_to_s2d(w7)), "the stem was not remapped")
    log(f"stem: load_init of phase 8's 7x7 ckpt_best into an s2d model: {report['converted']} converted, "
        f"{STEM_KEY} remapped to [64, 12, 4, 4] exactly")

    rng = np.random.default_rng(10)
    xy = rng.uniform(0, [1344, 768], (NMS_BLOCKED_N, 2))
    boxes = np.round(np.concatenate([xy, xy + rng.uniform(8, 300, (NMS_BLOCKED_N, 2))], 1) / 4) * 4
    args = (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy((np.round(rng.uniform(0, 1, NMS_BLOCKED_N) * 64) / 64).astype(np.float32)).cuda(),
            torch.from_numpy(rng.uniform(size=NMS_BLOCKED_N) > 0.05).cuda())
    results, nms_ms, nms_gib = {}, {}, {}
    for algorithm in ("fixpoint", "blocked"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        results[algorithm] = nms.nms_mask(*args, iou_threshold=0.5, algorithm=algorithm)
        torch.cuda.synchronize()
        nms_gib[algorithm] = (torch.cuda.max_memory_allocated() - base) / 2**30
        nms_ms[algorithm] = call_ms(lambda: nms.nms_mask(*args, iou_threshold=0.5, algorithm=algorithm), runs=5, warmup=1)
    kept = int(results["blocked"][0].sum())
    log(f"nms: N = {NMS_BLOCKED_N} on the card, {kept} kept: fixpoint {nms_ms['fixpoint']:.3f} ms, "
        f"{nms_gib['fixpoint']:.3f} GiB; blocked (B 128) {nms_ms['blocked']:.3f} ms, {nms_gib['blocked']:.3f} GiB "
        f"(host clock, median of 5; temporaries' peak)")
    check(all(torch.equal(a, b) for a, b in zip(results["blocked"], results["fixpoint"])) and 0 < kept < NMS_BLOCKED_N,
          "blocked NMS differs from the fixpoint")
    out["nms"] = {"n": NMS_BLOCKED_N, "kept": kept, "ms": nms_ms, "peak_gib": nms_gib}

    with launches_of(ra, counts, "bench --transport yuv420 --runs 2", (7, 14), tag="transport"):
        (record,) = torch_bench.main(["--transport", "yuv420", "--runs", "2"])
    check(record["transport"] == "yuv420" and record["value"] > 0 and record["device_fps"] > 0,
          f"bench yuv420 record {record}")
    out["bench"] = record
    out["counts"] = counts
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    import slowfast_vos_tpu_torch
    from slowfast_vos_tpu_torch import data
    from slowfast_vos_tpu_torch import train as train_mod
    from slowfast_vos_tpu_torch.models import config as cfg_mod
    from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod
    from slowfast_vos_tpu_torch.ops import cuda_build
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
    counts, main_rois = phase_main(ra, pipeline_mod)
    train, train_rois = phase_train(ra, pipeline_mod, train_mod, data)
    errs = phase_kernels(ra, main_rois)
    bwd_errs = phase_backward_kernels(ra, train_rois)
    phase_reference(pipeline_mod)
    phase_train_reference(pipeline_mod, train_mod, data, cfg_mod)
    records = phase_timings(ra, errs, counts, main_rois)
    for r, out_size in zip(records, (7, 14)):
        r["train_launches"] = train["counts"][out_size]
    records += backward_timings(ra, bwd_errs, train["counts"], train_rois)
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
        transport_stem = phase_transport_stem(ra, pipeline_mod, Path(cli_dir))  # reads phase 8's checkpoint
    log(f"transport and stem: phase 10 in {time.perf_counter() - t0:.1f} s")
    for r in records:
        size = 7 if r["name"].endswith("pool7") else 14
        key = ("backward", size) if "backward" in r["name"] else size
        r["drivers_launches"] = {name: c[key] for name, c in drivers["counts"].items()}
        r["cli_launches"] = {name: c[key] for name, c in cli["counts"].items()}
        r["parallel_launches"] = {name: c[key] if key in c else c[str(key)] for name, c in parallel["counts"].items()}
        r["transport_stem_launches"] = {name: c[key] for name, c in transport_stem["counts"].items()}

    log(json.dumps({"train_step": {k: train[k] for k in ("step_ms", "step_times_ms", "peak_gib")}}))
    log(json.dumps({"drivers": {k: v for k, v in drivers.items() if k != "counts"}}))
    log(json.dumps({"cli": {k: v for k, v in cli.items() if k != "counts"}}))
    log(json.dumps({"parallel": {k: v for k, v in parallel.items() if k != "counts"}}))
    log(json.dumps({"transport_stem": {k: v for k, v in transport_stem.items() if k != "counts"}}))
    log(json.dumps({"kernels": records}))
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
    if sys.argv[1:2] == [PARALLEL_WORKER]:
        sys.exit(parallel_worker(sys.argv[2], sys.argv[3], Path(sys.argv[4])))
    sys.exit(main())
