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
             [2, 128] rois), per pixel against the plain backward;
5. reference - a small f32 input through the same entry point on the card
             and on the CPU (the plain versions), compared; and one tiny f32
             train step on both, same weights and draws;
6. timings - each kernel on both roi sets, with and without the level
             assignment, against its bound and its plain version (the
             forward also against its per-roi footprint).

Prints one JSON line of kernel records, the card's name and power limit, and
as its last line {"ok": true, "device": {...}}. Exits non-zero, with no
result line, where CUDA is absent or any phase fails.
"""
import contextlib
import json
import statistics
import subprocess
import sys
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


def main_path_rois(pipeline_mod, pipe, clip) -> dict:
    """The rois of the first superchunk that `infer_sequence` pools: its
    proposals (7x7 pool) and its detection boxes (14x14 pool)."""
    kept = {}
    pool = pipeline_mod.multiscale_roi_align

    def keep(feats, rois, *args, output_size, **kw):
        kept.setdefault(output_size, rois.detach().contiguous().clone())
        return pool(feats, rois, *args, output_size=output_size, **kw)

    pipeline_mod.multiscale_roi_align = keep
    try:
        pipe.infer_sequence(clip[:SC])
    finally:
        pipeline_mod.multiscale_roi_align = pool
    return kept


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

    d = pipe.cfg.detections_per_img
    check(len(dets) == 20, f"{len(dets)} frames out")
    for det in dets:
        check(det["boxes"].shape == (d, 4) and det["scores"].shape == (d,), "detection shapes")
        check(det["union_mask"].shape == (480, 854), "union mask shape")
        check(np.isfinite(det["boxes"]).all() and np.isfinite(det["scores"]).all(), "non-finite detections")
        check(((det["boxes"] >= 0) & (det["boxes"] <= [854 + 1e-3, 480 + 1e-3] * 2)).all(), "boxes off the frame")
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


def phase_reference(pipeline_mod) -> None:
    """A small f32 input through `forward_superchunk` on the card and on the
    CPU (plain versions, no kernel), same seeded weights. Tolerances as in
    tests/test_torch_pipeline.py: valid flags and labels exact, boxes within
    0.05 px, scores within 1e-4, at most 1% of union-mask pixels differ."""
    outs = []
    images = np.random.default_rng(2).integers(0, 256, (6, 120, 200, 3), dtype=np.uint8)
    for device in ("cuda", "cpu"):
        pipe, model = pipeline_mod.build_pipeline(
            3, 3, (120, 200), min_size=128, max_size=256, dtype=torch.float32, device=device, superchunk=4
        )
        pipeline_mod.init_weights(model, seed=0)
        out = pipe.forward_superchunk(torch.from_numpy(images), torch.ones(6, dtype=torch.bool))
        outs.append([o.cpu().numpy() for o in out])
    (gb, gs, gl, gv, gm), (cb, cs, cl, cv, cm) = outs
    box_err, score_err = np.abs(gb - cb).max(), np.abs(gs - cs).max()
    mask_diff = (np.unpackbits(gm, axis=-1, count=200) != np.unpackbits(cm, axis=-1, count=200)).mean()
    log(f"reference: card vs CPU at 120x200 f32: valid equal {np.array_equal(gv, cv)}, labels equal "
        f"{np.array_equal(gl, cl)}, box err {box_err:.3e} px, score err {score_err:.3e}, mask pixels differing {mask_diff:.4f}")
    check(np.array_equal(gv, cv) and np.array_equal(gl, cl), "valid flags or labels differ from the CPU")
    check(box_err <= 0.05 and score_err <= 1e-4 and mask_diff <= 0.01, "card output differs from the CPU")


def training_window(data, hw, frames, max_gt, index):
    """Window `index` of `train_windows` over a seeded moving-blobs sequence
    (2 objects, masks and boxes per frame)."""
    images, ids = data.draw_sequence(np.random.default_rng(7), frames, *hw, 2)
    windows = list(data.train_windows(data.sequence_arrays(images, ids, max_gt), fast=3))
    return windows[index], images


def phase_train(ra, pipeline_mod, train_mod, data) -> tuple[dict, dict]:
    """8 full-width train steps; returns (launch counts of those steps, the
    first step's sampled rois by output size)."""
    pipe, model = pipeline_mod.build_pipeline(
        slow=3, fast=3, original_hw=(480, 854), dtype=torch.bfloat16, device="cuda", superchunk=SC
    )
    pipeline_mod.init_weights(model, seed=0)
    trainer = train_mod.Trainer(pipe, seed=0)
    batch, clip = training_window(data, (480, 854), 8, pipe.cfg.max_gt, index=1)
    log(f"train: window of {batch['images'].shape[0]} frames 480x854, {int(batch['gt_valid'].sum())} gt boxes, "
        f"feat_valid {batch['feat_valid'].tolist()}")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kept, pool = {}, train_mod.train_step.multiscale_roi_align

    def keep(feats, rois, *args, output_size, **kw):
        kept.setdefault(output_size, rois.detach().clone())
        return pool(feats, rois, *args, output_size=output_size, **kw)

    keys = (7, 14, ("backward", 7), ("backward", 14))
    per_step, times = [], []
    train_mod.train_step.multiscale_roi_align = keep
    try:
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
    finally:
        train_mod.train_step.multiscale_roi_align = pool
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
    contributions' magnitudes: the atomics add them in no fixed order).
    Returns the largest bf16 max abs error of each pool."""
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


def phase_train_reference(pipeline_mod, train_mod, data, cfg_mod) -> None:
    """One tiny f32 train step (tests/test_torch_train.py's shape: 60x100,
    min 64, max 128, 3-3, TINY_CFG) on the card (kernels) and on the CPU
    (plain versions), same seeded weights and draws; the CPU step replays
    the card step's ReLU branches. Losses to rel 1e-4, every trainable
    gradient to max-abs 1e-3 x its max |grad| (conv biases before a
    train-mode BatchNorm, whose gradient is zero, to 1e-5 of the SlowFast
    gradients)."""
    cfg = cfg_mod.DetectionConfig(
        rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32, rpn_pre_nms_top_n_test=64,
        rpn_post_nms_top_n_test=32, box_batch_size_per_image=32, mask_train_rois=8, detections_per_img=5, max_gt=3,
    )
    batch, _ = training_window(data, (60, 100), 6, cfg.max_gt, index=0)
    masks, out = [], {}
    for run, device in enumerate(("cuda", "cpu")):
        pipe, model = pipeline_mod.build_pipeline(
            3, 3, (60, 100), min_size=64, max_size=128, cfg=cfg, dtype=torch.float32, device=device, superchunk=4
        )
        pipeline_mod.init_weights(model, seed=0)
        trainer = train_mod.Trainer(pipe)
        if run == 0:  # the samplers' draws, made once on the CPU
            gen = torch.Generator().manual_seed(0)
            a, b = trainer.num_anchors, cfg.rpn_post_nms_top_n_train + cfg.max_gt
            draws = {k: torch.rand((2, m), generator=gen) for k, m in
                     (("rpn_pos", a), ("rpn_neg", a), ("box_pos", b), ("box_neg", b))}
        model.train()
        with relu_branches(masks, replay=run == 1):
            total, metrics = trainer.loss(batch, {k: v.to(device) for k, v in draws.items()})
            total.backward()
        model.eval()
        out[run] = ({k: float(v) for k, v in metrics.items()}, {k: p.grad.cpu() for k, p in trainer.params.items()})
    (gm, gg), (cm, cg) = out[0], out[1]
    loss_err = max(abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-12) for k in cm)
    sf_scale = max(float(v.abs().max()) for k, v in cg.items() if k.startswith("slow_fast."))
    share, zero_share = 0.0, 0.0
    for k in cg:
        diff = float((gg[k] - cg[k]).abs().max())
        if k.startswith("slow_fast.") and "conv" in k and k.endswith(".bias"):
            zero_share = max(zero_share, max(float(gg[k].abs().max()), float(cg[k].abs().max())) / (1e-5 * sf_scale))
        else:
            share = max(share, diff / (GRAD_SHARE * float(cg[k].abs().max())))
    log(f"reference: tiny f32 train step card vs CPU: losses max rel err {loss_err:.3e} (tol 1e-4), "
        f"gradients at {share:.3f} of their tolerance, zero-gradient biases at {zero_share:.3f}; "
        f"{len(masks)} ReLU calls replayed; loss {gm['loss']:.6f} (card) {cm['loss']:.6f} (CPU)")
    check(loss_err <= 1e-4 and share <= 1.0 and zero_share <= 1.0, "the card's train step differs from the CPU's")


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
                f"level assignment, {only_ms:.4f} ms without (f32 zeroing, atomics and bf16 cast included; "
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

    log(json.dumps({"train_step": {k: train[k] for k in ("step_ms", "step_times_ms", "peak_gib")}}))
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
    sys.exit(main())
