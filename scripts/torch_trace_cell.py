#!/usr/bin/env python3
"""One run of a `vosbench` cell with the port's tracer on, and what its
spans, counters and in-graph stage times say, on one NVIDIA GPU.

    python3 scripts/torch_trace_cell.py --workload sf3-3.train.davis17 --seed 7 --seconds 20 --trace 1

Runs `vosbench/harness.py::execute` as `vosbench/run.py` does, with
`slowfast_vos_tpu_torch.utils.profiling.TRACER` switched on before the
cell's set-up, and takes the tracer's snapshot after set-up, after the
traced segment (`--trace 1`) and after the window. Prints, as one JSON
line: the harness's result (its metrics, with the program's own profiler
ranges left out of the device operations), the tracer's readings
(`readings`: the per-layer numbers below, from the window; `graph_capture_s`
from set-up; `segment_readings` from the traced segment), the traced
segment's idle seconds by the innermost program span open on the thread
that drives the card, with what the producer thread had open beside gaps
under `prefetch.get_wait` (`idle_by_program_span`), and each snapshot's
totals, counters and stage times. The tracer's cost: compare the
end-to-end metrics of a `--trace 0` run here with those of
`vosbench/run.py` at the same seed, which runs the cell untraced.

Readings (ms and % as named; None where the run has nothing to read):

* `decode_ms_per_frame.train`: the per-frame spans `data.decode_images`
  and `data.decode_masks`, clipped to the window, over `data.frames`;
* `producer_busy.train`: 100 x (producer wall - `prefetch.put_wait`) /
  producer wall, the wall being the snapshot's interval;
* `stage_ms_per_step.train`: `train.stage_batch` over `train.steps`;
* `device_step_ms.train`: the gradient and update graphs' stage times,
  each graph's mean over its read replays times its replays, over
  `train.steps`;
* `stage_ms_per_frame.infer`: `pipeline.chunk_inputs` over
  `pipeline.frames` (real frames);
* `fetch_host_ms_per_frame.infer`: the self time of `pipeline.fetch`
  (after `pipeline.fetch_wait`) over real frames;
* `backbone_device_ms_per_frame.infer`, `slowfast_device_ms_per_frame.infer`,
  `heads_device_ms_per_frame.infer`: the superchunk graphs' `transform` +
  `backbone` (with ViTDet's stages below), `slowfast`, and `rpn` +
  `roi_heads` + `finalize` stage times, weighted as above, over real frames;
* `vit_window_device_ms_per_frame.infer`, `vit_global_device_ms_per_frame.infer`,
  `pyramid_device_ms_per_frame.infer` (ViTDet cells; 0 elsewhere): the
  stage marks `vit.window` and `vit.global` (one a block, summed by kind)
  and `pyramid`, weighted as above, over real frames;
* `graph_capture_s`: `graphs.capture` seconds in set-up.

Needs CUDA; exits 1 without.
"""
import argparse
import bisect
import json
import pathlib
import statistics
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]

TRAIN_STAGES = ("transform", "backbone", "rpn", "slowfast", "roi_heads", "loss", "backward", "update")
VIT_STAGES = ("vit.patch_embed", "vit.window", "vit.global", "pyramid")  # ViTDet's backbone (`models/vit.py`)
INFER_STAGES = {
    "backbone_device_ms_per_frame.infer": ("transform", *VIT_STAGES, "backbone"),
    "slowfast_device_ms_per_frame.infer": ("slowfast",),
    "heads_device_ms_per_frame.infer": ("rpn", "roi_heads", "finalize"),
    "vit_window_device_ms_per_frame.infer": ("vit.window",),
    "vit_global_device_ms_per_frame.infer": ("vit.global",),
    "pyramid_device_ms_per_frame.infer": ("pyramid",),
}


def _per(x, n):
    return None if x is None or not n else x / n


def total_s(snap: dict, name: str, key: str = "total_s") -> float | None:
    t = snap["totals"].get(name)
    return None if t is None else t[key]


def _ms(s):
    return None if s is None else 1e3 * s


def stage_ms(snap: dict, stages, prefix: str) -> float | None:
    """Milliseconds of `stages` over every replay of the graphs whose label
    starts with `prefix`: each graph's mean over its read replays times its
    replays. None where no replay was read."""
    total, read = 0.0, False
    for label, st in snap["stages"].items():
        if label.startswith(prefix) and st["samples"]:
            read = True
            total += sum(st["ms"].get(s, 0.0) for s in stages) / st["samples"] * st["replays"]
    return total if read else None


DECODE_SPANS = ("data.decode_images", "data.decode_masks")


def decode_s(snap: dict) -> float | None:
    """Seconds of the per-frame decode spans inside the snapshot's interval:
    their totals less the part before `t0_ns` of a span open across it (the
    producer's span is stretched there while the traced segment's profiler
    shuts down). None where none ran."""
    parts = [total_s(snap, name) for name in DECODE_SPANS]
    if parts == [None, None]:
        return None
    t0 = snap["t0_ns"]
    before = sum(t0 - s["start_ns"] for s in snap["spans"] if s["name"] in DECODE_SPANS and s["start_ns"] < t0)
    return sum(p or 0.0 for p in parts) - 1e-9 * before


def producer_busy(snap: dict) -> float | None:
    """100 x (wall - `prefetch.put_wait`) / wall over the producer threads,
    the wall being the snapshot's interval; the waits clipped to it."""
    t0, t1 = snap["t0_ns"], snap["t1_ns"]
    threads = {s["thread"] for s in snap["spans"] if s["name"] == "prefetch.put_wait"}
    threads |= {s["thread"] for s in snap["open"] if s["name"] == "prefetch.put_wait"}
    if not threads or t1 <= t0:
        return None
    wait = (total_s(snap, "prefetch.put_wait") or 0.0) * 1e9
    wait -= sum(t0 - s["start_ns"] for s in snap["spans"] if s["name"] == "prefetch.put_wait" and s["start_ns"] < t0)
    wait += sum(t1 - max(s["start_ns"], t0) for s in snap["open"] if s["name"] == "prefetch.put_wait")
    wall = (t1 - t0) * len(threads)
    return 100.0 * (wall - wait) / wall


def readings(kind: str, window: dict, setup: dict | None) -> dict:
    """The per-layer readings of a cell whose driver is `kind` ("infer" or
    "train") from the window's snapshot, and `graph_capture_s` from set-up's."""
    c = window["counters"]
    out = {"graph_capture_s": None if setup is None else total_s(setup, "graphs.capture")}
    if kind == "train":
        steps = c.get("train.steps")
        out.update({
            "decode_ms_per_frame.train": _per(_ms(decode_s(window)), c.get("data.frames")),
            "producer_busy.train": producer_busy(window),
            "stage_ms_per_step.train": _per(_ms(total_s(window, "train.stage_batch")), steps),
            "device_step_ms.train": _per(stage_ms(window, TRAIN_STAGES, "train."), steps),
        })
    else:
        frames = c.get("pipeline.frames")
        out.update({
            "stage_ms_per_frame.infer": _per(_ms(total_s(window, "pipeline.chunk_inputs")), frames),
            "fetch_host_ms_per_frame.infer": _per(_ms(total_s(window, "pipeline.fetch", "self_s")), frames),
        })
        out.update({name: _per(stage_ms(window, stages, "superchunk."), frames) for name, stages in INFER_STAGES.items()})
    return out


def _innermost(spans, starts, t: float, default: str) -> str:
    """The name of the latest-starting span of `spans` (sorted by start)
    open at `t`."""
    for name, a, b in reversed(spans[: bisect.bisect_right(starts, t)]):
        if b >= t:
            return name
    return default


def idle_by_program_span(gaps, snap: dict, profiler_ranges) -> tuple[dict, dict]:
    """Idle seconds of `gaps` (profiler clock, s) by the innermost program
    span open on the main thread at each gap's middle; gaps under
    `prefetch.get_wait` also by what the producer thread had open
    ("prefetch.get_wait < data.decode_images"). `profiler_ranges` are the
    (name, start s) of the program's ranges the profiler recorded; the
    tracer's spans go onto the profiler's clock by the median offset
    between main-thread spans and their ranges, matched by name and order.
    Returns (seconds by label, how the clocks were matched)."""
    main = snap["main_thread"]
    spans = snap["spans"] + [dict(s, end_ns=snap["t1_ns"]) for s in snap["open"]]
    by_name: dict = {}
    for name, start in sorted(profiler_ranges, key=lambda r: r[1]):
        by_name.setdefault(name, []).append(start)
    offsets = []
    for name, starts in by_name.items():
        ours = sorted(s["start_ns"] * 1e-9 for s in spans if s["thread"] == main and s["name"] == name)
        if len(ours) == len(starts):
            offsets += [p - o for p, o in zip(starts, ours)]
    if not offsets:
        return {}, {"matched": 0}
    offset = statistics.median(offsets)

    def placed(threads_main: bool):
        out = sorted(((s["name"], s["start_ns"] * 1e-9 + offset, s["end_ns"] * 1e-9 + offset) for s in spans
                      if (s["thread"] == main) == threads_main), key=lambda s: s[1])
        return out, [s[1] for s in out]

    (mains, main_starts), (others, other_starts) = placed(True), placed(False)
    out: dict = {}
    largest = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label = _innermost(mains, main_starts, mid, "none")
        if label == "prefetch.get_wait":
            label += " < " + _innermost(others, other_starts, mid, "none")
        out[label] = out.get(label, 0.0) + (e - s)
        largest.append((e - s, label))
    largest = [[label, length] for length, label in sorted(largest, reverse=True)[:8]]
    return out, {"matched": len(offsets), "offset_spread_s": max(offsets) - min(offsets), "largest_gaps": largest}


def summary(snap: dict) -> dict:
    """A snapshot without its span list."""
    return {k: v for k, v in snap.items() if k not in ("spans", "open")} | {
        "spans_kept": len(snap["spans"]), "open": [s["name"] for s in snap["open"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import importlib

    import torch
    from torch.autograd import DeviceType

    sys.path.insert(0, str(ROOT))
    from slowfast_vos_tpu_torch.utils.profiling import TRACER
    from vosbench import harness
    from vosbench import trace as trace_mod

    if not torch.cuda.is_available():
        print("torch_trace_cell: CUDA is not available", file=sys.stderr)
        return 1
    spec = harness.cell_spec(args.workload)
    kind = "infer" if spec["traffic"]["driver"].startswith("infer") else "train"  # infer, infer_vitdet; train
    driver = importlib.import_module(f"vosbench.drivers.{kind}")
    snaps, extra = {}, {}
    setup, window = driver.Cell.setup, driver.Cell.window
    start, stop, reduce = trace_mod.DeviceTrace.start, trace_mod.DeviceTrace.stop, trace_mod.DeviceTrace.reduce

    def traced_setup(self):
        setup(self)
        snaps["setup"] = TRACER.take()

    def traced_window(self, *a, **kw):
        run = window(self, *a, **kw)
        snaps["window"] = TRACER.take()
        return run

    def traced_start(self):
        TRACER.take()
        start(self)

    def traced_stop(self):
        stop(self)
        snaps["segment"] = TRACER.take()

    def traced_reduce(self):
        seg = snaps["segment"]
        program = set(seg["totals"]) | {s["name"] for s in seg["open"]}
        events = self.prof.events()
        bench = set(self.names)
        self.names = bench | program  # the program's ranges are annotations, not device operations
        device = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in events
                  if e.device_type == DeviceType.CUDA and e.name not in self.names]
        host = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in events
                if e.device_type == DeviceType.CPU and e.name in bench]
        ranges = [(e.name, e.time_range.start * 1e-6) for e in events
                  if e.device_type == DeviceType.CPU and e.name in program]
        if host:
            gaps = trace_mod.idle_gaps(device, min(s for s, _ in host), max(e for _, e in host))
            extra["idle_by_program_span"], extra["clock_match"] = idle_by_program_span(gaps, seg, ranges)
            idle = sum(e - s for s, e in gaps)
            named = sum(v for k, v in extra["idle_by_program_span"].items() if k != "none")
            extra["idle_labelled_share"] = named / idle if idle else None
        main = seg["main_thread"]
        producer = {s["name"] for s in seg["spans"] if s["thread"] != main}
        extra["producer_ranges_in_profiler"] = [sum(1 for n, _ in ranges if n in producer),
                                                sum(1 for s in seg["spans"] if s["thread"] != main)]
        return reduce(self)

    driver.Cell.setup, driver.Cell.window = traced_setup, traced_window
    trace_mod.DeviceTrace.start, trace_mod.DeviceTrace.stop = traced_start, traced_stop
    trace_mod.DeviceTrace.reduce = traced_reduce
    TRACER.enable()
    try:
        result = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", t0=T0)
    finally:
        TRACER.disable()
    out = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
           "card": torch.cuda.get_device_name(0), "result": result}
    out["readings"] = readings(kind, snaps["window"], snaps.get("setup"))
    if "segment" in snaps:
        out["segment_readings"] = readings(kind, snaps["segment"], None)
        dv = result["device"]
        seg_c = snaps["segment"]["counters"]
        units = seg_c.get("pipeline.frames") if kind == "infer" else seg_c.get("train.steps")
        out["segment_busy_ms_per_unit"] = _per(1e3 * dv["busy_s"], units) if "busy_s" in dv else None
    out.update(extra)
    out["snapshots"] = {k: summary(v) for k, v in snaps.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
