#!/usr/bin/env python3
"""Device time of every kernel of one inference superchunk, by full name and
by stage, on one NVIDIA GPU.

    python3 scripts/torch_stage_kernels.py --config sf3-3 --seed 7 --superchunks 3

Builds the pipeline of a `vosbench` configuration with the benchmark's
weights for `--seed` (`vosbench/weights.py`), and runs first superchunks
(superchunk + fast - 1 frames at the configuration's resolution, random
pixels) eagerly under `torch.profiler`. The CUDA graph a benchmark run
replays launches the same kernels; here each of `Pipeline`'s stage marks
(`TRACER.mark`: transform, backbone, rpn, slowfast, roi_heads, finalize)
synchronizes and leaves a profiler range, so every kernel falls between two
marks: the stage it belongs to. Prints one JSON line:

* `stages`: device ms a frame through the backbone, per stage;
* `kernels`: (stage, full kernel name, ms a frame, launches a superchunk),
  largest first, the `--top` largest;
* `matched`: for each `--match` substring (default PyTorch's unvectorised
  and vectorised elementwise kernels), its ms a frame by stage and by full
  name.

Needs CUDA; exits 1 without.
"""
import argparse
import collections
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MARK = "stage_end:"
MATCH = ("elementwise_kernel<128, 4", "vectorized_elementwise_kernel<8")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="sf3-3", help="a file of vosbench/configs/ without .json")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--superchunks", type=int, default=3, help="profiled superchunks, after one warm-up")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--match", action="append", help="kernel name substrings to split by stage")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_stage_kernels: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, str(ROOT))
    from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod
    from slowfast_vos_tpu_torch.models.config import DetectionConfig
    from slowfast_vos_tpu_torch.utils.profiling import TRACER
    from vosbench import harness, weights

    cfg = harness.load_json(ROOT / "vosbench" / "configs" / f"{args.config}.json")
    device = torch.device("cuda")
    pipe, model = pipeline_mod.build_pipeline(
        cfg["slow"], cfg["fast"], tuple(cfg["original_hw"]), cfg=DetectionConfig(**cfg["detection"]),
        dtype=getattr(torch, cfg["dtype"]), min_size=cfg["min_size"], max_size=cfg["max_size"],
        device=device, superchunk=cfg["superchunk"], graphs=False)
    model.load_state_dict(weights.make_state(cfg["slow"], cfg["fast"], cfg["detection"], args.seed, device), strict=True)
    frames = cfg["superchunk"] + cfg["fast"] - 1
    gen = torch.Generator(device=device).manual_seed(args.seed)
    images = torch.randint(0, 256, (frames, *cfg["original_hw"], 3), generator=gen, device=device, dtype=torch.uint8)
    feat_valid = torch.ones(frames, dtype=torch.bool, device=device)

    def mark(stage):
        torch.cuda.synchronize()
        with record_function(MARK + stage):
            pass

    TRACER.mark = mark  # an instance attribute over the method, taken away below
    try:
        with torch.inference_mode():
            pipe._superchunk(images, feat_valid)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(args.superchunks):
                    mark("start")
                    pipe._superchunk(images, feat_valid)
                    mark("end")
    finally:
        del TRACER.mark

    events = list(prof.events())
    marks = sorted((e.time_range.start, e.name[len(MARK):]) for e in events
                   if e.device_type == DeviceType.CPU and e.name.startswith(MARK))
    starts = [t for t, _ in marks]
    per_frame = 1.0 / (args.superchunks * frames)
    stages, kernels = collections.Counter(), collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith(MARK):
            continue
        i = next((k for k, t in enumerate(starts) if t >= e.time_range.start), None)
        stage = "after" if i is None else marks[i][1]
        ms = e.time_range.elapsed_us() / 1e3 * per_frame
        stages[stage] += ms
        kernels[stage, e.name][0] += ms
        kernels[stage, e.name][1] += 1
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    matched = {}
    for sub in args.match or MATCH:
        by_stage, by_name = collections.Counter(), collections.Counter()
        for (stage, name), (ms, _) in kernels.items():
            if sub in name:
                by_stage[stage] += ms
                by_name[stage, name] += ms
        matched[sub] = {"ms_per_frame_by_stage": dict(by_stage),
                        "by_name": [[s, n, ms] for (s, n), ms in by_name.most_common()]}
    out = {"config": args.config, "seed": args.seed, "frames_per_superchunk": frames,
           "superchunks": args.superchunks, "device": torch.cuda.get_device_name(device),
           "stages": dict(stages), "device_ms_per_frame": sum(stages.values()),
           "kernels": [[s, n, ms, calls // args.superchunks] for (s, n), (ms, calls) in ranked[: args.top]],
           "kernels_per_superchunk": sum(c for _, c in kernels.values()) // args.superchunks,
           "matched": matched}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
