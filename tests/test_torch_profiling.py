"""The port's tracer (`slowfast_vos_tpu_torch/utils/profiling.py`) on the CPU:
spans on a fake clock (nesting, parents, units, self time, a second
thread), counters and `take()`; nothing recorded and no profiler range
when off; spans as `torch.profiler` ranges of the same durations; the
stage clock's reads without a wait; the spans and counters of the
prefetch, the loader, `infer_sequence` and `Trainer.step` at a tiny size,
whose outputs the tracer leaves as they were; the graph keys hold the
tracer's state; and the readings of `scripts/torch_trace_cell.py` on
synthetic snapshots. The stage marks inside a CUDA graph run on the card
(`tests/test_torch_cuda.py::test_stage_marks_in_a_graph_are_read_without_a_synchronize`)."""
import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from slowfast_vos_tpu_torch import data
from slowfast_vos_tpu_torch.data.davis import DavisIndex, load_sequence
from slowfast_vos_tpu_torch.models import graphs
from slowfast_vos_tpu_torch.models.config import DetectionConfig
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline, init_weights
from slowfast_vos_tpu_torch.train import Trainer
from slowfast_vos_tpu_torch.train import graphs as train_graphs
from slowfast_vos_tpu_torch.train.train_step import stage_batch
from slowfast_vos_tpu_torch.utils import profiling
from slowfast_vos_tpu_torch.utils.prefetch import prefetch
from slowfast_vos_tpu_torch.utils.profiling import TRACER, Tracer

torch.set_num_threads(2)  # the tier-1 run has 6 workers on 8 cores

ROOT = Path(__file__).resolve().parents[1]
HW = (60, 100)
CFG = DetectionConfig(
    rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32, rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=32,
    box_batch_size_per_image=32, mask_train_rois=8, detections_per_img=5, max_gt=3,
)


def trace_cell():
    spec = importlib.util.spec_from_file_location("torch_trace_cell", ROOT / "scripts" / "torch_trace_cell.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class FakeClock:
    """Nanoseconds that advance only when told."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


@pytest.fixture
def traced():
    """The port's tracer on, from empty; off and empty afterwards."""
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.take()


def by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def test_spans_nest_share_units_and_keep_self_time():
    clock = FakeClock()
    tr = Tracer(clock=clock)
    tr.enable()
    with tr.span("step", unit=True):
        clock.now += 10
        with tr.span("stage"):
            clock.now += 30
        with tr.span("stage"):
            clock.now += 20
            tr.count("frames", 4)
        clock.now += 5
    with tr.span("fetch"):  # after the unit's root: still its unit
        clock.now += 7
    with tr.span("step", unit=True):
        clock.now += 1
    tr.count("frames")
    clock.now += 3
    snap = tr.take()
    first, second = by_name(snap, "step")
    stages = by_name(snap, "stage")
    (fetch,) = by_name(snap, "fetch")
    assert first["parent"] is None and all(s["parent"] == first["id"] for s in stages)
    assert {s["unit"] for s in stages} == {first["unit"], fetch["unit"]} == {first["unit"]}
    assert second["unit"] != first["unit"] and fetch["parent"] is None
    assert (first["start_ns"], first["end_ns"]) == (0, 65)
    assert snap["totals"]["step"] == pytest.approx({"calls": 2, "total_s": 66e-9, "self_s": 16e-9})
    assert snap["totals"]["stage"] == pytest.approx({"calls": 2, "total_s": 50e-9, "self_s": 50e-9})
    assert snap["counters"] == {"frames": 5}
    assert (snap["t0_ns"], snap["t1_ns"]) == (0, 76) and snap["open"] == [] and snap["dropped"] == 0
    assert {s["thread"] for s in snap["spans"]} == {threading.get_ident()} == {snap["main_thread"]}
    assert "launches" in snap and snap["stages"] == {}
    again = tr.take()
    assert again["spans"] == [] and again["totals"] == {} and again["counters"] == {} and again["t0_ns"] == 76


def test_spans_from_a_second_thread_keep_their_own_parents_and_units():
    tr = Tracer()
    tr.enable()
    inside = threading.Event()
    release = threading.Event()

    def producer():
        with tr.span("load", unit=True):
            with tr.span("decode"):
                inside.set()
                release.wait(timeout=10)

    with tr.span("step", unit=True):
        th = threading.Thread(target=producer)
        th.start()
        assert inside.wait(timeout=10)
        open_now = tr.take()
        release.set()
        th.join(timeout=10)
    assert not th.is_alive()
    assert sorted(s["name"] for s in open_now["open"]) == ["decode", "load", "step"]
    snap = tr.take()
    (step,), (load,), (decode,) = by_name(snap, "step"), by_name(snap, "load"), by_name(snap, "decode")
    assert decode["parent"] == load["id"] and load["parent"] is None
    assert decode["unit"] == load["unit"] != step["unit"]
    assert load["thread"] == decode["thread"] != step["thread"] == snap["main_thread"]


def test_the_buffer_keeps_the_newest_spans_and_the_totals_every_span():
    tr = Tracer(capacity=4)
    tr.enable()
    for _ in range(10):
        with tr.span("s"):
            pass
    snap = tr.take()
    assert len(snap["spans"]) == 4 and snap["dropped"] == 6 and snap["totals"]["s"]["calls"] == 10
    assert [s["id"] for s in snap["spans"]] == sorted(s["id"] for s in snap["spans"])


def test_off_records_nothing_and_reaches_no_profiler():
    tr = Tracer()
    assert tr.span("a") is tr.span("b") is profiling._NOOP
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("off.span"):
            tr.count("c")
            tr.mark("backbone")
    assert "off.span" not in {e.name for e in prof.events()}
    snap = tr.take()
    assert snap["spans"] == [] and snap["totals"] == {} and snap["counters"] == {} and snap["stages"] == {}
    assert tr.stage_clock("g") is None


def test_spans_are_profiler_ranges_of_the_same_duration():
    """While a `torch.profiler` is active, each span is also a range of the
    same name around it, of the same duration to within a fifth (the range
    opens before the span's first stamp and closes after its last; a busy
    host may deschedule the thread between them)."""
    tr = Tracer()
    tr.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("outer.span"):
            time.sleep(0.05)
            with tr.span("inner.span"):
                time.sleep(0.05)
    snap = tr.take()
    ranges = {e.name: e.time_range.elapsed_us() * 1e-6 for e in prof.events() if e.name.endswith(".span")}
    for name in ("outer.span", "inner.span"):
        span = snap["totals"][name]["total_s"]
        assert span - 1e-5 <= ranges[name] <= 1.2 * span
    assert ranges["outer.span"] >= 0.1


class FakeEvent:
    """A timing event of a replay: done or not, at a time in ms."""

    def __init__(self, at, done=True):
        self.at, self.done = at, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.at - self.at


def test_stage_clock_reads_a_finished_replay_and_counts_an_unfinished_one_unread():
    tr = Tracer()
    tr.enable()
    clock = tr.stage_clock("superchunk.first[34]")
    clock.events = [("", FakeEvent(0.0)), ("backbone", FakeEvent(4.0)), ("rpn", FakeEvent(5.5))]
    clock.read()  # nothing replayed yet: nothing to read
    clock.replayed()
    clock.read()  # before the next replay
    clock.replayed()
    clock.events[-1][1].done = False
    snap = tr.take()  # the second replay has not finished: unread
    assert snap["stages"] == {"superchunk.first[34]": {"replays": 2, "samples": 1, "unread": 1,
                                                        "ms": {"backbone": 4.0, "rpn": 1.5}}}
    clock.events[-1][1].done = True
    clock.replayed()
    assert tr.take()["stages"]["superchunk.first[34]"] == {"replays": 1, "samples": 1, "unread": 0,
                                                            "ms": {"backbone": 4.0, "rpn": 1.5}}


def test_marks_record_only_inside_a_recording():
    tr = Tracer()
    tr.enable()
    marks = []
    clock = tr.stage_clock("g")
    clock.mark = marks.append
    tr.mark("before")
    with tr.recording(clock):
        tr.mark("backbone")
        other = threading.Thread(target=tr.mark, args=("other thread",))
        other.start()
        other.join(timeout=10)
    tr.mark("after")
    with tr.recording(None):
        tr.mark("none")
    assert marks == ["", "backbone"]


@pytest.mark.parametrize("slow", [True, False], ids=["slow source", "fast source"])
def test_prefetch_counts_gets_and_empty_gets(traced, slow):
    def source():
        for i in range(6):
            if slow:
                time.sleep(0.03)
            yield i

    feed = prefetch(source(), depth=2)
    try:
        got = []
        for item in feed:
            if not slow:
                time.sleep(0.03)
            got.append(item)
    finally:
        feed.close()
    snap = traced.take()
    assert got == list(range(6))
    c = snap["counters"]
    assert c.get("prefetch.empty_gets", 0) >= 5 if slow else c.get("prefetch.empty_gets", 0) <= 2
    assert snap["totals"]["prefetch.get_wait"]["calls"] == 7  # the six items and the end
    waits = {s["thread"] for s in by_name(snap, "prefetch.put_wait")}
    assert len(waits) == 1 and snap["main_thread"] not in waits
    assert snap["totals"]["prefetch.put_wait"]["calls"] == 7
    assert (snap["totals"]["prefetch.put_wait"]["total_s"] > 0.1) != slow  # a fast source waits on the queue


def test_load_sequence_counts_the_frames_it_decodes(traced, tmp_path):
    """As the training feed runs: open a sequence, cut its windows, open the
    next. Each frame is decoded once, inside the window that first touches
    it, in the unit of its sequence."""
    names = data.make_synthetic_davis(str(tmp_path), num_sequences=2, frames=5, hw=HW)
    index = DavisIndex(str(tmp_path), "train", year="2017")
    seqs, windows = [], []
    for info in index:
        seqs.append(load_sequence(info, max_gt=3))
        windows += data.train_windows(seqs[-1], fast=3)
    snap = traced.take()
    assert len(names) == 2 and snap["counters"]["data.frames"] == sum(s.length for s in seqs) == 10
    assert snap["counters"] == {"data.frames": 10}
    loads = by_name(snap, "data.load_sequence")
    assert len(loads) == 2 and len({s["unit"] for s in loads}) == 2
    cuts = by_name(snap, "data.window")
    for child in ("data.decode_images", "data.decode_masks"):
        spans = by_name(snap, child)
        assert len(spans) == 10 and {s["parent"] for s in spans} <= {s["id"] for s in cuts}
        assert sorted(s["unit"] for s in spans) == sorted(s["unit"] for s in loads for _ in range(5))
    assert snap["totals"]["data.window"]["calls"] == len(windows) == 6


@pytest.mark.parametrize("fast,n_center", [(1, 2), (3, 1), (3, 2), (7, 1), (7, 2)])
def test_windows_decode_each_frame_once_when_first_touched(traced, tmp_path, fast, n_center):
    """After each window: the frames decoded so far are those the windows
    have touched, and the sequence holds only those the next window shares
    (at most a window's); after the epoch, every frame once."""
    data.make_synthetic_davis(str(tmp_path), num_sequences=2, frames=7, hw=HW)
    data.make_synthetic_davis(str(tmp_path), num_sequences=1, frames=2, hw=HW, start=2, subset=None, seed=5)
    infos = [*DavisIndex(str(tmp_path), "train", year="2017"), *DavisIndex(str(tmp_path), sequences="synth02")]
    halo_left, halo_right = fast // 2, -(-fast // 2) - 1
    decoded = 0
    for info in infos:
        seq = load_sequence(info, max_gt=3)
        assert traced.take()["counters"] == {}
        for k, _ in enumerate(data.train_windows(seq, fast=fast, n_center=n_center)):
            touched = min(seq.length, (k + 1) * n_center + halo_right)
            frames = traced.take()["counters"].get("data.frames", 0)
            decoded += frames
            assert frames == touched - (min(seq.length, k * n_center + halo_right) if k else 0)
            held = sorted(seq._frames)  # the decoded frames the sequence still holds
            assert held == list(range(max(0, (k + 1) * n_center - halo_left), touched))
            assert len(held) <= n_center + fast - 1
    assert decoded == sum(len(info.images) for info in infos) == 16


class HostPipe:
    """What `extract_masks` and `extract_rpn_proposals` ask of a pipeline,
    answered on the host."""

    cfg = CFG
    device = torch.device("cpu")

    def infer_sequence(self, images, instance_masks=False):
        return [{"union_mask": np.zeros(images.shape[1:3], bool)} for _ in images]

    def compute_sequence_features(self, images):
        return None, torch.zeros((len(images), 4, 4)), torch.zeros((len(images), 4), dtype=torch.bool)


class HostDeviceParallel:
    def __init__(self, pipe, devices, instance_masks=False):
        self.pipe, self.n = pipe, len(devices)

    def infer_group(self, clips):
        return [self.pipe.infer_sequence(clip) for clip in clips]


@pytest.mark.parametrize("route", ["serial", "device_parallel", "proposals"])
def test_whole_sequence_readers_decode_on_the_prefetch_thread(traced, tmp_path, monkeypatch, route):
    """Evaluation (serial and device-list routes) and the proposal dump
    read whole sequences: every frame is decoded on the prefetch thread,
    none on the thread that drives the device."""
    from slowfast_vos_tpu_torch.eval import glue
    from slowfast_vos_tpu_torch.train.pretrain import extract_rpn_proposals

    root = str(tmp_path / "davis")
    data.make_synthetic_davis(root, num_sequences=2, frames=3, hw=HW)
    traced.take()
    if route == "proposals":
        extract_rpn_proposals(HostPipe(), davis_root=root, output_path=str(tmp_path / "p.npz"))
    else:
        monkeypatch.setattr(glue, "DeviceParallelInference", HostDeviceParallel)
        devices = [torch.device("cpu")] * 2 if route == "device_parallel" else None
        glue.extract_masks(HostPipe(), root, str(tmp_path / "out"), subset="train", year="2017", devices=devices)
    snap = traced.take()
    assert snap["counters"]["data.frames"] == 6
    producers = {s["thread"] for s in by_name(snap, "prefetch.put_wait")}
    for name in ("data.decode_images", "data.decode_masks"):
        spans = by_name(snap, name)
        assert len(spans) == 6 and {s["thread"] for s in spans} == producers
        assert snap["main_thread"] not in producers


def tiny_pipeline():
    pipe, model = build_pipeline(3, 3, HW, dtype=torch.float32, device="cpu", superchunk=4, min_size=64,
                                 max_size=128, cfg=CFG)
    init_weights(model, seed=0)
    return pipe


def test_infer_sequence_traced_gives_the_same_outputs_and_its_spans():
    """Six frames: a first superchunk of 4 and a carried one of 2 real
    frames (2 padding). Tracing leaves every output as it was; the spans
    and counters are those of two superchunks on the eager path."""
    pipe = tiny_pipeline()
    clip = np.random.default_rng(3).integers(0, 256, (6, *HW, 3), dtype=np.uint8)
    want = pipe.infer_sequence(clip)
    TRACER.enable()
    try:
        got = pipe.infer_sequence(clip)
    finally:
        TRACER.disable()
        snap = TRACER.take()
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in g)
    calls = {k: v["calls"] for k, v in snap["totals"].items()}
    assert calls == {"pipeline.infer_sequence": 1, "pipeline.infer_chunks": 1, "pipeline.chunk_inputs": 2,
                     "pipeline.fetch": 1, "pipeline.fetch_wait": 1}
    assert snap["counters"] == {"pipeline.frames": 6}
    (root,) = by_name(snap, "pipeline.infer_sequence")
    assert len({s["unit"] for s in snap["spans"]}) == 1
    assert {s["parent"] for s in by_name(snap, "pipeline.fetch")} == {root["id"]}
    assert snap["totals"]["pipeline.fetch"]["self_s"] <= snap["totals"]["pipeline.fetch"]["total_s"]


def test_trainer_step_traced_gives_the_same_step_and_its_spans():
    """One step from the same weights and seed with the tracer off and on:
    the same metrics and gradients; the spans of one eager step and the
    loss fetch, in one unit."""
    from slowfast_vos_tpu_torch.train.trainer import finite_loss

    images, ids = data.draw_sequence(np.random.default_rng(3), 6, *HW, 2)
    batch = list(data.train_windows(data.sequence_arrays(images, ids, CFG.max_gt), fast=3))[1]
    pipe = tiny_pipeline()
    start = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    out = []
    for on in (False, True):
        pipe.model.load_state_dict(start)
        tr = Trainer(pipe, seed=3)
        if on:
            TRACER.enable()
        try:
            metrics = tr.step(batch)
            loss = finite_loss(metrics)
        finally:
            TRACER.disable()
            snap = TRACER.take()
        out.append((loss, metrics, [p.detach().clone() for p in tr.params.values()], snap))
    (loss_off, m_off, p_off, snap_off), (loss_on, m_on, p_on, snap) = out
    assert loss_on == loss_off and all(torch.equal(m_on[k], m_off[k]) for k in m_off)
    assert all(torch.equal(a, b) for a, b in zip(p_on, p_off))
    assert snap_off["totals"] == {} and snap_off["spans"] == []
    calls = {k: v["calls"] for k, v in snap["totals"].items()}
    assert calls == {"train.step": 1, "train.stage_batch": 1, "train.loss_fetch": 1}
    assert snap["counters"] == {"train.steps": 1}
    assert len({s["unit"] for s in snap["spans"]}) == 1


def test_graph_keys_hold_the_tracer_state():
    pipe = tiny_pipeline()
    clip = np.random.default_rng(3).integers(0, 256, (6, *HW, 3), dtype=np.uint8)
    images, valid = pipe.chunk_inputs(clip, 0, False)
    images2, ids = data.draw_sequence(np.random.default_rng(3), 6, *HW, 2)
    batch = stage_batch(list(data.train_windows(data.sequence_arrays(images2, ids, CFG.max_gt), fast=3))[0],
                        torch.device("cpu"))
    keys = []
    for on in (False, True):
        if on:
            TRACER.enable()
        try:
            keys.append((graphs.superchunk_key(images, valid, None, False), train_graphs.step_key(pipe, batch, None, 2)))
        finally:
            TRACER.disable()
            TRACER.take()
    assert keys[0][0] != keys[1][0] and keys[0][1] != keys[1][1]


def snapshot(**kw):
    base = {"t0_ns": 0, "t1_ns": 10_000_000_000, "main_thread": 1, "spans": [], "open": [], "dropped": 0,
            "totals": {}, "counters": {}, "launches": {}, "stages": {}}
    return base | kw


def tot(total_s, self_s=None, calls=1):
    return {"calls": calls, "total_s": total_s, "self_s": total_s if self_s is None else self_s}


def test_training_readings_on_a_synthetic_snapshot():
    mod = trace_cell()
    window = snapshot(
        totals={"data.load_sequence": tot(0.001, calls=2), "data.decode_images": tot(0.6, calls=70),
                "data.decode_masks": tot(1.3, calls=70), "train.stage_batch": tot(0.5), "prefetch.put_wait": tot(3.0)},
        counters={"data.frames": 70, "train.steps": 100},
        # a decode open across the window's start: its 0.5 s before it are not the window's
        spans=[{"name": "prefetch.put_wait", "thread": 2, "start_ns": -1_000_000_000, "end_ns": 500_000_000},
               {"name": "data.decode_masks", "thread": 2, "start_ns": -500_000_000, "end_ns": 10_000_000}],
        open=[{"name": "prefetch.put_wait", "thread": 2, "start_ns": 9_000_000_000, "id": 9}],
        stages={"train.gradient[4]": {"replays": 100, "samples": 50, "unread": 0,
                                      "ms": {"backbone": 500.0, "loss": 100.0, "backward": 1400.0}},
                "train.update": {"replays": 100, "samples": 100, "unread": 0, "ms": {"update": 50.0}}},
    )
    setup = snapshot(totals={"graphs.capture": tot(2.5, calls=2)})
    r = mod.readings("train", window, setup)
    assert r["decode_ms_per_frame.train"] == pytest.approx(20.0)
    assert r["stage_ms_per_step.train"] == pytest.approx(5.0)
    # waits: 3 s, less the 1 s before the window, plus the 1 s still open: 3 s of 10
    assert r["producer_busy.train"] == pytest.approx(70.0)
    assert r["device_step_ms.train"] == pytest.approx(40.0 + 0.5)
    assert r["graph_capture_s"] == 2.5
    assert mod.readings("train", snapshot(), None) == {
        "graph_capture_s": None, "decode_ms_per_frame.train": None, "producer_busy.train": None,
        "stage_ms_per_step.train": None, "device_step_ms.train": None}


def test_inference_readings_weight_each_graph_by_its_replays():
    mod = trace_cell()
    window = snapshot(
        totals={"pipeline.chunk_inputs": tot(0.2), "pipeline.fetch": tot(0.5, self_s=0.3)},
        counters={"pipeline.frames": 1000},
        stages={"superchunk.first[34]": {"replays": 10, "samples": 2, "unread": 8,
                                         "ms": {"transform": 2.0, "backbone": 38.0, "rpn": 4.0, "slowfast": 20.0,
                                                "roi_heads": 10.0, "finalize": 6.0}},
                "superchunk.carried[32]": {"replays": 30, "samples": 3, "unread": 27,
                                           "ms": {"transform": 3.0, "backbone": 45.0, "slowfast": 30.0,
                                                  "rpn": 6.0, "roi_heads": 12.0, "finalize": 9.0}}},
    )
    r = mod.readings("infer", window, snapshot())
    assert r["stage_ms_per_frame.infer"] == pytest.approx(0.2)
    assert r["fetch_host_ms_per_frame.infer"] == pytest.approx(0.3)
    assert r["backbone_device_ms_per_frame.infer"] == pytest.approx((20.0 * 10 + 16.0 * 30) / 1000)
    assert r["slowfast_device_ms_per_frame.infer"] == pytest.approx((10.0 * 10 + 10.0 * 30) / 1000)
    assert r["heads_device_ms_per_frame.infer"] == pytest.approx((10.0 * 10 + 9.0 * 30) / 1000)
    assert r["graph_capture_s"] is None


def test_idle_gaps_go_to_the_innermost_span_and_the_producers_beside_get_wait():
    """Spans on the tracer's clock, ranges 100 s later on the profiler's:
    the gaps land in the innermost main-thread span, and under
    `prefetch.get_wait` beside what the producer had open."""
    mod = trace_cell()
    s = 1_000_000_000
    spans = [
        {"id": 1, "name": "train.step", "thread": 1, "start_ns": 0, "end_ns": 4 * s},
        {"id": 2, "name": "train.stage_batch", "thread": 1, "start_ns": 1 * s, "end_ns": 2 * s},
        {"id": 3, "name": "prefetch.get_wait", "thread": 1, "start_ns": 5 * s, "end_ns": 8 * s},
        {"id": 4, "name": "data.decode_images", "thread": 2, "start_ns": 4 * s, "end_ns": 7 * s},
    ]
    ranges = [("train.step", 100.0), ("train.stage_batch", 101.0), ("prefetch.get_wait", 105.0)]
    gaps = [(101.2, 101.6), (103.0, 103.5), (105.5, 106.5), (107.5, 107.9), (109.0, 109.5)]
    labels, match = mod.idle_by_program_span(gaps, snapshot(spans=spans), ranges)
    assert match["matched"] == 3 and match["offset_spread_s"] == pytest.approx(0.0)
    assert labels == pytest.approx({"train.stage_batch": 0.4, "train.step": 0.5,
                                    "prefetch.get_wait < data.decode_images": 1.0,
                                    "prefetch.get_wait < none": 0.4, "none": 0.5})
