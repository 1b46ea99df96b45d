"""Mask R-CNN DAVIS fine-tune path (no SlowFast) and RPN proposal extraction.

The port's copy of `slowfast_vos_tpu/train/pretrain.py`, a rebuild of the
reference driver `code/maskrcnn/maskrcnn_src.py:214-285` and the vendored
engine's behaviors (`code/maskrcnn/engine.py`):

* trains the detector (backbone layers 2-4, FPN, RPN, heads) on
  frame-level DAVIS data, SGD(1e-3, momentum 0.9, wd 5e-4), StepLR
  step_size=3 gamma=0.1 for 15 epochs (`maskrcnn_src.py:253-259`);
* linear LR warmup over the first min(1000, steps-1) updates of epoch 0
  (`engine.py:33-38`);
* abort on non-finite loss (`engine.py:48-51`);
* `extract_rpn_proposals`: per-frame RPN proposals to an .npz, the
  `predict_boxes` dump (`engine.py:166-236`).

Mixed-resolution data trains through one `Pipeline` per padded canvas over
the same model, and ONE `Trainer`: one optimizer, one momentum buffer per
weight and one schedule, as the JAX driver's one functional state across
its per-canvas trainers.
"""
from __future__ import annotations

import os

import numpy as np

from slowfast_vos_tpu_torch.data.davis import DavisIndex, load_sequence
from slowfast_vos_tpu_torch.data.frames import DavisFrameDataset, frame_batches
from slowfast_vos_tpu_torch.models.pipeline import Pipeline, build_pipeline
from slowfast_vos_tpu_torch.models.transform import ImageTransform
from slowfast_vos_tpu_torch.train.train_step import Trainer
from slowfast_vos_tpu_torch.train.trainer import finite_loss, start_weights
from slowfast_vos_tpu_torch.utils.checkpoint import save_checkpoint
from slowfast_vos_tpu_torch.utils.metrics import MetricsLogger
from slowfast_vos_tpu_torch.utils.prefetch import prefetch


def warmup_step_lr(base_lr: float, steps_per_epoch: int, *, warmup_iters: int,
                   step_size_epochs: int = 3, gamma: float = 0.1):
    """The learning rate at update `step` (0 for the first): linear warmup
    from base_lr / 1000 over `warmup_iters` updates, then StepLR every
    `step_size_epochs` epochs."""
    warmup_iters = max(warmup_iters, 1)

    def schedule(step: int) -> float:
        warm = min(step / warmup_iters, 1.0)
        factor = 1.0 / 1000 + (1 - 1.0 / 1000) * warm  # engine.py warmup_factor
        epoch = step // steps_per_epoch
        decay = gamma ** (epoch // step_size_epochs)
        return base_lr * (factor if step < warmup_iters else 1.0) * decay

    return schedule


def build_maskrcnn_pipeline(original_hw=(480, 854), **kw):
    """Single-frame Mask R-CNN: fast=1 (no temporal halo), no SlowFast."""
    return build_pipeline(slow=1, fast=1, original_hw=original_hw, use_slow_fast=False, **kw)


def train_maskrcnn(
    pipe: Pipeline,
    *,
    davis_root: str,
    output_dir: str,
    epochs: int = 15,
    lr: float = 1e-3,
    weight_decay: float = 5e-4,
    batch_size: int = 2,
    year: str = "2017",
    seed: int = 63,
    max_steps_per_epoch: int | None = None,
    state_dict: dict | None = None,
):
    """Train `pipe.model` in place from `state_dict` (None: seeded random
    weights). Returns (the `Trainer`, history). Checkpoints
    `<output_dir>/maskrcnn_model.pt` each epoch (the artifact the SlowFast
    stage starts from, reference `model.py:173`)."""
    os.makedirs(output_dir, exist_ok=True)
    dataset = DavisFrameDataset(davis_root, "train", year=year, max_gt=pipe.cfg.max_gt)
    steps_per_epoch = max_steps_per_epoch or max(len(dataset) // batch_size, 1)
    schedule = warmup_step_lr(
        lr, steps_per_epoch, warmup_iters=min(1000, steps_per_epoch - 1) or 1
    )
    start_weights(pipe.model, state_dict, seed)
    # trainable_backbone_layers=3 = torchvision's pretrained-detector
    # default: conv1/bn1/layer1 frozen (`maskrcnn_src.py:190`, optimizer
    # filtered on requires_grad at :253-255).
    trainer = Trainer(
        pipe, lr=schedule, weight_decay=weight_decay, n_center=batch_size,
        train_backbone=True, trainable_backbone_layers=3, seed=seed,
    )
    # One Pipeline per padded canvas, all over pipe.model (the reference's
    # GroupedBatchSampler + batch_images pairing); DAVIS uses only `pipe`.
    pipes = {tuple(pipe.transform.original_hw): pipe}

    def pipeline_for(images_hw) -> Pipeline:
        if images_hw not in pipes:
            tf = ImageTransform(
                images_hw,
                min_size=pipe.transform.min_size,
                max_size=pipe.transform.max_size,
                divisor=pipe.transform.divisor,
            )
            pipes[images_hw] = Pipeline(pipe.model, tf, superchunk=pipe.superchunk)
        return pipes[images_hw]

    history = []
    step = 0
    with MetricsLogger(os.path.join(output_dir, "logs"), "maskrcnn") as logger:
        for epoch in range(epochs):
            epoch_loss = 0.0
            n = 0
            # Background decode and pack of the next batches; the batch order
            # is unchanged. train_flip: the reference's
            # RandomHorizontalFlip(0.5) train transform (`maskrcnn_src.py:207-212`).
            with prefetch(
                frame_batches(dataset, batch_size, seed=seed + epoch, train_flip=True), depth=2
            ) as bs:
                for batch in bs:
                    trainer.use_pipeline(pipeline_for(tuple(batch["images"].shape[1:3])))
                    loss = finite_loss(trainer.step(batch))
                    epoch_loss += loss
                    logger.scalar("pretrain/loss", loss, step)
                    step += 1
                    n += 1
                    if max_steps_per_epoch and n >= max_steps_per_epoch:
                        break
            history.append({"epoch": epoch, "loss": epoch_loss / max(n, 1)})
            save_checkpoint(os.path.join(output_dir, "maskrcnn_model.pt"), trainer, meta={"epoch": epoch})
    trainer.use_pipeline(pipe)
    return trainer, history


def extract_rpn_proposals(
    pipe: Pipeline,
    *,
    davis_root: str,
    output_path: str,
    subset: str = "train",
    year: str = "2017",
):
    """Dump per-frame RPN proposals of `pipe.model` for every sequence to
    one .npz, the `predict_boxes` workload (`engine.py:195-236`)."""
    index = DavisIndex(davis_root, subset, year=year)
    out = {}
    with prefetch(
        ((info, dict(load_sequence(info, max_gt=pipe.cfg.max_gt))) for info in index), depth=1
    ) as decoded:
        for info, seq in decoded:
            _feats, proposals, pvalid = pipe.compute_sequence_features(seq["images"])
            out[f"{info.name}/proposals"] = proposals.cpu().numpy()
            out[f"{info.name}/valid"] = pvalid.cpu().numpy()
    np.savez_compressed(output_path, **out)
    return output_path
