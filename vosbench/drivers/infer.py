"""Inference over whole sequences, back to back: what an evaluation or a
`predict` run does.

One caller, closed loop: each sequence goes through the port's
`Pipeline.infer_sequence`, whose detections and packed union masks reach
the host before the next sequence starts. The traffic's distinct sequences
are drawn in set-up and held in host memory; the window replays them in
passes, each pass over every sequence in an order drawn from the seed, and
ends with the first pass that ends after `--seconds`: every window holds
whole passes, the same frames in another order.

`infer_fps` counts the real frames of the sequences completed in the
window over the time from its start to the last completion; a superchunk's
padding frames do not count. The benchmark's spans: `sequence` around each
call, `infer_chunks` (the host's part, which never waits for the card) and
`fetch` (`frame_detections`, which does) inside it.

Correctness: the sampled sequences' outputs, kept as the window produced
them, against the reference (`reference/run.py::infer_sequence`) run after
the window on the same frames and weights, by `compare.inference_gaps`.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from vosbench import compare, stats, weights
from vosbench.reference import model as ref_model
from vosbench.reference import run as ref_run


def _timed(spans, name, fn):
    def wrapper(*args, **kwargs):
        with spans(name):
            return fn(*args, **kwargs)

    return wrapper


class Cell:
    def __init__(self, config: dict, traffic: dict, generator, seed: int, device, spans):
        self.cfg, self.traffic, self.gen, self.seed = config, traffic, generator, seed
        self.device = torch.device(device)
        self.spans = spans

    def prepare(self) -> None:
        """What the program and the reference share: the weights, the
        traffic's sequences and the sample that `correct` compares."""
        cfg = self.cfg
        self.state = weights.make_state(cfg["slow"], cfg["fast"], cfg["detection"], self.seed, self.device)
        self.sequences = self.gen.sequences(self.traffic, self.seed, tuple(cfg["original_hw"]), self.device)
        self.order = self.gen.passes(self.traffic, self.seed, self.traffic["passes"])
        self.next = 0
        rng = np.random.default_rng([self.seed, 3])
        self.sample = {int(i) for i in rng.choice(len(self.sequences), self.traffic["sample"], replace=False)}
        self.kept = {}

    def setup(self) -> None:
        from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod
        from slowfast_vos_tpu_torch.models.config import DetectionConfig

        cfg = self.cfg
        self.prepare()
        self.pipeline_mod = pipeline_mod
        self.pipe, model = pipeline_mod.build_pipeline(
            cfg["slow"], cfg["fast"], tuple(cfg["original_hw"]), cfg=DetectionConfig(**cfg["detection"]),
            dtype=getattr(torch, cfg["dtype"]), min_size=cfg["min_size"], max_size=cfg["max_size"],
            device=self.device, superchunk=cfg["superchunk"], graphs=cfg["graphs"])
        model.load_state_dict(self.state, strict=True)
        self.pipe.infer_chunks = _timed(self.spans, "infer_chunks", self.pipe.infer_chunks)
        self._fetch = pipeline_mod.frame_detections
        pipeline_mod.frame_detections = _timed(self.spans, "fetch", self._fetch)
        # Warm-up: the first and the carried superchunk of the longest
        # sequence, the two graph keys every sequence of the traffic uses.
        longest = max(self.sequences, key=len)
        self.pipe.infer_sequence(longest[: cfg["superchunk"] + 1], transport=cfg["transport"])
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, trace=None, trace_seconds: float = 0.0) -> dict:
        """Sequences back to back until `seconds` have passed. With a device
        trace, a traced segment of `trace_seconds` comes first, and the
        window follows it untraced."""
        traced = None
        if trace is not None:
            trace.start()
            traced = self.segment(trace_seconds, whole_passes=False)["counts"]
            trace.stop()
        run = self.segment(seconds, whole_passes=True)
        run["traced"] = traced
        self.counters = program_counters(self.pipe.graphs.graphs if self.pipe.graphs is not None else {})
        return run

    def segment(self, seconds: float, whole_passes: bool) -> dict:
        """Sequences until `seconds` have passed, and with `whole_passes` on
        to the end of the pass, so that every window holds the same mix."""
        frames = sequences = attempted = failed = superchunks = 0
        per_pass = len(self.sequences)
        t0 = time.perf_counter()
        last = t0
        while last - t0 < seconds or (whole_passes and self.next % per_pass):
            idx = self.order[self.next]
            self.next += 1
            seq = self.sequences[idx]
            attempted += 1
            with self.spans("sequence"):
                dets = self.pipe.infer_sequence(seq, transport=self.cfg["transport"])
            last = time.perf_counter()
            if len(dets) != seq.shape[0]:
                failed += 1
                continue
            if idx in self.sample and idx not in self.kept:
                self.kept[idx] = dets
            frames += seq.shape[0]
            sequences += 1
            superchunks += -(-seq.shape[0] // self.cfg["superchunk"])
        window_s = last - t0
        return {"e2e": {"infer_fps": stats.rate(frames, window_s)}, "attempted": attempted, "failed": failed,
                "counts": {"frames": frames, "sequences": sequences, "superchunks": superchunks,
                           "window_s": window_s}}

    def release(self) -> None:
        """Free the program's state, so that the reference fits."""
        self.close()
        del self.pipe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Put back the function that `setup` wrapped in a span."""
        if hasattr(self, "_fetch"):
            self.pipeline_mod.frame_detections = self._fetch

    def check(self) -> tuple[dict, dict]:
        """(gaps, details) of the sampled sequences against the reference."""
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        cfg = self.cfg
        model = ref_run.build(cfg["slow"], cfg["fast"], ref_model.Detection(**cfg["detection"]), self.state, self.device,
                              rank_dtype=getattr(torch, cfg["dtype"]))
        geom = ref_model.Geometry(tuple(cfg["original_hw"]), cfg["min_size"], cfg["max_size"])
        program, reference = [], []
        timings = {}
        for idx in sorted(self.kept):
            dets = self.kept[idx]
            teacher = {k: torch.as_tensor(np.stack([d[k] for d in dets])).to(self.device) for k in ("boxes", "labels", "valid")}
            frames = torch.from_numpy(self.sequences[idx]).to(self.device)
            out = ref_run.infer_sequence(model, geom, frames, teacher=teacher, timings=timings)
            program.append(dets)
            reference.append({k: v.cpu().numpy() for k, v in out.items()})
        details = {**getattr(self, "counters", {}), "sampled": [int(self.sequences[i].shape[0]) for i in sorted(self.kept)],
                   "reference_s": time.perf_counter() - t0, "reference_stages_s": timings}
        self.compared = program, reference
        if not program:
            return {"mask_gap": float("inf"), "score_gap": float("inf")}, details
        gaps, extra = compare.inference_gaps(program, reference)
        return gaps, {**details, **extra}


def program_counters(graphs) -> dict:
    """The graphs captured and the hand-kernel launches counted so far, as
    the program counts them (`ops/cuda_build.py::launches`): a check that a
    run went through K1, K3 and, in training, K5 and K6."""
    from slowfast_vos_tpu_torch.ops import cuda_build

    return {"graphs": len(graphs), "launches": {str(k): v for k, v in sorted(cuda_build.launches.items(), key=str)}}


def flops(config: dict, traffic: dict, counts: dict) -> float:
    from vosbench import yardstick

    return yardstick.infer_flops_per_frame(config) * counts["frames"]
