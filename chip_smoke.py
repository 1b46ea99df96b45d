#!/usr/bin/env python3
"""Drive the PyTorch port of SlowFast Mask R-CNN on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   - compile every hand-written kernel of `slowfast_vos_tpu_torch/csrc`
             with nvcc (one process per source, all started together);
2. main    - `build_pipeline(3, 3, (480, 854), bf16)` with seeded random
             weights, `infer_sequence` over a 20-frame clip (first, carry and
             ragged-tail superchunks), launch counts read around that run,
             frames/s, peak device memory; one superchunk's real proposals
             and detection boxes are kept for phases 3 and 5;
3. kernels - hold each kernel against its plain PyTorch version at the main
             path's shapes (DAVIS 480x854 -> 768x1344 canvas, superchunk 8:
             [8, 1000] proposals for the 7x7 pool, [8, 10] detections for the
             14x14 pool, 256 channels), in f32 (TF32 off) and bf16, on
             synthetic rois with the edge cases and on the main path's own
             rois, and at 40 channels on the synthetic rois;
4. reference - a small f32 input through the same entry point on the card
             and on the CPU (the plain versions), compared;
5. timings - each kernel on both roi sets, with and without the level
             assignment, against its bound, its per-roi footprint and its
             plain version.

Prints one JSON line of kernel records, the card's name and power limit, and
as its last line {"ok": true, "device": {...}}. Exits non-zero, with no
result line, where CUDA is absent or any phase fails.
"""
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
SC = 8


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
    errs = phase_kernels(ra, main_rois)
    phase_reference(pipeline_mod)
    records = phase_timings(ra, errs, counts, main_rois)

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
