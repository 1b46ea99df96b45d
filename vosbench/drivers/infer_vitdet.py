"""Inference over whole sequences with ViTDet-B + SlowFast 3-3: the
`infer` driver (one caller, closed loop, passes over the traffic's
sequences, `infer_fps`) on the port's `build_pipeline(arch="vitdet-b")`.

What differs from `infer.py`: the weights (`weights_vitdet.py`), the
pipeline's backbone and heads (the configuration's `vit` widths on its
`square_pad` canvas), the reference (`reference/vitdet.py` on the same
square canvas, through `reference/run.py::infer_sequence`), the FLOPs
(`yardstick_vitdet.py`), and one more count, `backbone_frames`: the
frames each superchunk sends through the backbone (the first of a
sequence with its halo, the carried ones without), which K7's bound
counts. The harness's `canvas_hw` is never read.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from vosbench import compare, weights_vitdet
from vosbench.drivers import infer
from vosbench.reference import model as ref_model
from vosbench.reference import run as ref_run
from vosbench.reference import vitdet as ref_vitdet


def widths(cfg: dict) -> ref_vitdet.Widths:
    v = dict(cfg["vit"])
    v["global_blocks"] = tuple(v["global_blocks"])
    return ref_vitdet.Widths(**v)


def geometry(cfg: dict) -> ref_vitdet.SquareGeometry:
    return ref_vitdet.SquareGeometry(tuple(cfg["original_hw"]), cfg["min_size"], cfg["max_size"], cfg["square_pad"])


class Cell(infer.Cell):
    def prepare(self) -> None:
        cfg = self.cfg
        self.state = weights_vitdet.make_state(cfg["slow"], cfg["fast"], cfg["detection"], self.seed, self.device,
                                               widths(cfg))
        self.sequences = self.gen.sequences(self.traffic, self.seed, tuple(cfg["original_hw"]), self.device)
        self.order = self.gen.passes(self.traffic, self.seed, self.traffic["passes"])
        self.next = 0
        rng = np.random.default_rng([self.seed, 3])
        self.sample = {int(i) for i in rng.choice(len(self.sequences), self.traffic["sample"], replace=False)}
        self.kept = {}

    def setup(self) -> None:
        """As `infer.Cell.setup`, on ViTDet-B's pipeline."""
        from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod
        from slowfast_vos_tpu_torch.models.config import DetectionConfig
        from slowfast_vos_tpu_torch.models.vit import ViTConfig

        cfg = self.cfg
        if cfg["square_pad"] != cfg["vit"]["image"]:
            raise ValueError(f"square_pad {cfg['square_pad']} is not the ViT's image {cfg['vit']['image']}")
        self.prepare()
        self.pipeline_mod = pipeline_mod
        self.pipe, model = pipeline_mod.build_pipeline(
            cfg["slow"], cfg["fast"], tuple(cfg["original_hw"]), cfg=DetectionConfig(**cfg["detection"]),
            dtype=getattr(torch, cfg["dtype"]), min_size=cfg["min_size"], max_size=cfg["max_size"],
            device=self.device, superchunk=cfg["superchunk"], graphs=cfg["graphs"], arch="vitdet-b",
            vit=ViTConfig(**vars(widths(cfg))))
        model.load_state_dict(self.state, strict=True)
        self.pipe.infer_chunks = infer._timed(self.spans, "infer_chunks", self.pipe.infer_chunks)
        self._fetch = pipeline_mod.frame_detections
        pipeline_mod.frame_detections = infer._timed(self.spans, "fetch", self._fetch)
        # Warm-up: the first and the carried superchunk, the two graph keys.
        longest = max(self.sequences, key=len)
        self.pipe.infer_sequence(longest[: cfg["superchunk"] + 1], transport=cfg["transport"])
        self.sync()

    def segment(self, seconds: float, whole_passes: bool) -> dict:
        run = super().segment(seconds, whole_passes)
        c = run["counts"]
        c["backbone_frames"] = c["superchunks"] * self.cfg["superchunk"] + c["sequences"] * (self.cfg["fast"] - 1)
        return run

    def reference(self, fp8: bool = False):
        cfg = self.cfg
        return ref_vitdet.build(cfg["slow"], cfg["fast"], ref_model.Detection(**cfg["detection"]), self.state,
                                self.device, fp8=fp8, rank_dtype=getattr(torch, cfg["dtype"]), widths=widths(cfg))

    def check(self) -> tuple[dict, dict]:
        """(gaps, details) of the sampled sequences against the reference."""
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        model, geom = self.reference(), geometry(self.cfg)
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


def flops(config: dict, traffic: dict, counts: dict) -> float:
    from vosbench import yardstick_vitdet

    return yardstick_vitdet.infer_flops_per_frame(config) * counts["frames"]
