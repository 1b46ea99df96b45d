"""Unsupervised training fed from disk: the inner loop of the port's
`train/trainer.py::train_unsupervised`, without its evaluation,
checkpoints and logger.

Set-up writes the traffic's DAVIS-2017-layout tree (JPEG frames, palette
PNG annotations) under a fresh directory of TMPDIR, builds the trainer as
the driver does (SGD with the traffic's rate, momentum and weight decay,
its generator seeded from the run's seed) and feeds it as the driver does:
`utils/prefetch.py::prefetch` over `data/davis.py::load_sequence` and
`data/windows.py::train_windows`, epochs over the tree in index order. The
first `checked_steps` steps run in set-up through that same feed and call;
they capture the step's graphs and are what the reference follows. The
window goes on with the next windows of the same feed, and ends with the
first epoch that ends after `--seconds`: every window holds the same
sequence boundaries, where `load_sequence` decodes the next sequence.

A step ends when its loss is on the host (`finite_loss`). `train_step_ms`
is the window over the steps completed in it; `train_step_p95_ms` the 95th
percentile of every step's time. Spans: `next_batch` around `next()` on
the prefetch iterator, `step` around `Trainer.step`, `loss_fetch` around
`finite_loss`.
"""
from __future__ import annotations

import gc
import itertools
import shutil
import tempfile
import time

import torch

from vosbench import compare, stats, weights
from vosbench.drivers.infer import program_counters
from vosbench.reference import data as ref_data
from vosbench.reference import model as ref_model
from vosbench.reference import run as ref_run


class Cell:
    def __init__(self, config: dict, traffic: dict, generator, seed: int, device, spans):
        self.cfg, self.traffic, self.gen, self.seed = config, traffic, generator, seed
        self.device = torch.device(device)
        self.spans = spans
        self.root = None
        self.feed = None

    def prepare(self) -> None:
        """What the program and the reference share: the weights and the
        tree of files."""
        cfg = self.cfg
        self.state = weights.make_state(cfg["slow"], cfg["fast"], cfg["detection"], self.seed, self.device)
        self.root = tempfile.mkdtemp(prefix="vosbench-davis17-")
        self.gen.write_tree(self.traffic, self.seed, tuple(cfg["original_hw"]), self.root, self.device)

    def setup(self) -> None:
        from slowfast_vos_tpu_torch.data.davis import DavisIndex, load_sequence
        from slowfast_vos_tpu_torch.data.windows import train_windows
        from slowfast_vos_tpu_torch.models.config import DetectionConfig
        from slowfast_vos_tpu_torch.models.pipeline import build_pipeline
        from slowfast_vos_tpu_torch.train.trainer import finite_loss
        from slowfast_vos_tpu_torch.train.train_step import Trainer
        from slowfast_vos_tpu_torch.utils.prefetch import prefetch

        cfg, tr = self.cfg, self.traffic
        self.finite_loss = finite_loss
        self.prepare()
        pipe, model = build_pipeline(
            cfg["slow"], cfg["fast"], tuple(cfg["original_hw"]), cfg=DetectionConfig(**cfg["detection"]),
            dtype=getattr(torch, cfg["dtype"]), min_size=cfg["min_size"], max_size=cfg["max_size"],
            device=self.device, superchunk=cfg["superchunk"], graphs=cfg["graphs"])
        model.load_state_dict(self.state, strict=True)
        self.trainer = Trainer(pipe, lr=tr["lr"], momentum=tr["momentum"], weight_decay=tr["weight_decay"],
                               n_center=tr["n_center"], seed=self.seed, graphs=cfg["graphs"])
        index = DavisIndex(self.root, "train", year="2017")
        fast, n_center, max_gt = cfg["fast"], tr["n_center"], cfg["detection"]["max_gt"]

        def epochs():
            for _ in itertools.count():
                for info in index:
                    yield from train_windows(load_sequence(info, max_gt=max_gt), fast=fast, n_center=n_center)

        self.feed = prefetch(epochs(), depth=2)
        self.per_epoch = sum(-(-t // n_center) for t in tr["lengths"])
        self.consumed = tr["checked_steps"]
        params = self.trainer.params
        start = {k: p.detach().clone() for k, p in params.items()}
        buffers = {k: b for k, b in self.trainer.model.named_buffers()
                   if k.startswith(ref_run.STATISTICS) and k.endswith(ref_run.RUNNING)}
        start_buffers = {k: b.detach().clone() for k, b in buffers.items()}
        losses, grad = [], None
        for i in range(tr["checked_steps"]):
            losses.append(self.finite_loss(self.trainer.step(next(self.feed))))
            if i == 0:
                state = self.trainer.optimizer.state
                grad = {k: state[p]["momentum_buffer"] - tr["weight_decay"] * start[k] for k, p in params.items()}
        self.program = {"losses": losses, "grad": grad,
                        "change": {k: p.detach() - start[k] for k, p in params.items()},
                        "buffers": {k: b.detach() - start_buffers[k] for k, b in buffers.items()}}
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, trace=None, trace_seconds: float = 0.0) -> dict:
        """Steps until `seconds` have passed. With a device trace, a traced
        segment of `trace_seconds` comes first, and the window follows it
        untraced."""
        traced = None
        if trace is not None:
            trace.start()
            traced = self.segment(trace_seconds, whole_epochs=False)["counts"]
            trace.stop()
        run = self.segment(seconds, whole_epochs=True)
        run["traced"] = traced
        runner = self.trainer.graphs
        self.counters = program_counters({} if runner is None else {**runner.graphs, "update": runner.update})
        return run

    def segment(self, seconds: float, whole_epochs: bool) -> dict:
        """Steps until `seconds` have passed, and with `whole_epochs` on to
        the end of the epoch, so that every window holds the same sequence
        boundaries, each with its decode."""
        times = []
        attempted = failed = 0
        t0 = time.perf_counter()
        last = t0
        while last - t0 < seconds or (whole_epochs and self.consumed % self.per_epoch):
            self.consumed += 1
            attempted += 1
            with self.spans("next_batch"):
                batch = next(self.feed)
            with self.spans("step"):
                metrics = self.trainer.step(batch)
            with self.spans("loss_fetch"):
                try:
                    self.finite_loss(metrics)
                except FloatingPointError:
                    failed += 1
            now = time.perf_counter()
            times.append(now - last)
            last = now
        window_s = last - t0
        return {"e2e": {"train_step_ms": 1e3 * window_s / len(times),
                        "train_step_p95_ms": 1e3 * stats.percentile(times, 95)},
                "attempted": attempted, "failed": failed, "counts": {"steps": len(times), "window_s": window_s}}

    def release(self) -> None:
        if self.feed is not None:
            self.feed.close()
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, fp8: bool = False, half_batch: bool = False) -> dict:
        """The reference's first steps on the same files, weights and draws."""
        cfg, tr = self.cfg, self.traffic
        det = ref_model.Detection(**cfg["detection"])
        model = ref_run.build(cfg["slow"], cfg["fast"], det, self.state, self.device, fp8=fp8,
                              rank_dtype=getattr(torch, cfg["dtype"]))
        geom = ref_model.Geometry(tuple(cfg["original_hw"]), cfg["min_size"], cfg["max_size"])
        n = tr["n_center"]
        batches = ref_data.first_windows(self.root, tr["checked_steps"], cfg["fast"], n, det.max_gt)
        anchors = sum(h * w * 3 for h, w in geom.feature_hws)
        boxes = det.rpn_post_nms_top_n_train + det.max_gt
        g = torch.Generator(device=self.device).manual_seed(self.seed)

        def draw(m):
            return torch.rand((n, m), generator=g, device=self.device)

        draws = [{"rpn_pos": draw(anchors), "rpn_neg": draw(anchors), "box_pos": draw(boxes), "box_neg": draw(boxes)}
                 for _ in batches]
        losses, grad, change, buffers = ref_run.train_steps(model, geom, batches, draws, n_center=n, lr=tr["lr"],
                                                   momentum=tr["momentum"], weight_decay=tr["weight_decay"],
                                                   half_batch=half_batch)
        return {"losses": losses, "grad": grad, "change": change, "buffers": buffers}

    def check(self) -> tuple[dict, dict]:
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        gaps, details = compare.training_gaps(self.program, self.reference_steps())
        details.update(getattr(self, "counters", {}), reference_s=time.perf_counter() - t0)
        return gaps, details

    def close(self) -> None:
        if self.feed is not None:
            self.feed.close()
        if self.root is not None:
            shutil.rmtree(self.root, ignore_errors=True)
            self.root = None


def flops(config: dict, traffic: dict, counts: dict) -> float:
    from vosbench import yardstick

    return yardstick.train_flops_per_step(config, traffic["n_center"]) * counts["steps"]
