"""Training step: the window loss, its gradient and the SGD update.

Port of `slowfast_vos_tpu/train/train_step.py`. One step consumes a window
of `n_center` consecutive frames plus the F-1 temporal halo; the loss is
the sum of the centre frames' losses (the reference's per-frame backward
with a gradient accumulation of 2, `code/helpers/model.py:353-374`), and
one optimizer step follows.

Only the SlowFast module and the RoI heads train by default; the backbone
and the RPN are frozen and their losses, still reported, carry no gradient.
The freeze partition is the PyTorch idiom of the JAX `trainable_labels`:
the parameters the optimizer updates have `requires_grad`, all others do
not, and the FrozenBatchNorm statistics are buffers, never updated or
decayed.

The optimizer is `torch.optim.SGD(lr, momentum, weight_decay,
fused=True)`, which equals the JAX package's
`optax.chain(add_decayed_weights(wd), sgd(lr, momentum))`: both add wd * p
to the gradient before the momentum trace, and on the first step both
traces equal that gradient. The trainer keeps every address that a step
writes fixed, so that a CUDA graph can replay it (`train/graphs.py`): the
gradients and momentum buffers exist from the start and are zeroed in
place, never freed (0 + g is g, and a zero trace times the momentum plus g
is g: the first step is unchanged), and the learning rate is a 0-d tensor
on the device, which the schedule fills in place and the fused step reads
there.

RoI pooling of the sampled rois goes through the differentiable
`multiscale_roi_align`: the forward kernel and, for the gradient, the
backward kernel on CUDA; the plain versions on the CPU.

Tracer spans (`utils/profiling.py::TRACER`): `train.step` (a unit of work)
> `train.stage_batch`, `graphs.run`, `graphs.update`; counter
`train.steps`. Stage marks, read under graphs: `transform`, `backbone`,
`rpn`, `slowfast`, `roi_heads`, `loss`, `backward`; the update's `update`.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from slowfast_vos_tpu_torch.models.heads import (
    fastrcnn_loss,
    maskrcnn_loss,
    project_masks_on_boxes,
    select_training_samples,
)
from slowfast_vos_tpu_torch.models.pipeline import Pipeline
from slowfast_vos_tpu_torch.models.rpn import filter_proposals, rpn_loss
from slowfast_vos_tpu_torch.models.segmentation import TRAINABLE_TOPLEVEL
from slowfast_vos_tpu_torch.ops.roi_align import ROI_SCALES, multiscale_roi_align
from slowfast_vos_tpu_torch.train.graphs import TrainStepGraphs
from slowfast_vos_tpu_torch.utils.profiling import TRACER


def body_layers_to_train(trainable_backbone_layers: int) -> list[str]:
    """torchvision `_resnet_fpn_extractor` freezing (`train_step.py:73-84`):
    the backbone body children that train for a given
    `trainable_backbone_layers` (3: conv1, bn1 and layer1 frozen)."""
    order = ["layer4", "layer3", "layer2", "layer1", "conv1"]
    to_train = order[:trainable_backbone_layers]
    if trainable_backbone_layers == 5:
        to_train.append("bn1")
    return to_train


def trainable_parameters(
    model: torch.nn.Module,
    trainable_keys: Iterable[str] = TRAINABLE_TOPLEVEL,
    trainable_backbone_layers: int | None = None,
) -> dict[str, torch.nn.Parameter]:
    """The parameters the optimizer updates, by name (`train_step.py:47-124`):
    those under the top-level modules `trainable_keys`, less, when
    `trainable_backbone_layers` is set, the backbone body children outside
    `body_layers_to_train` (the FPN stays trainable)."""
    keys = set(trainable_keys)
    to_train = None if trainable_backbone_layers is None else body_layers_to_train(trainable_backbone_layers)
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] not in keys:
            continue
        if to_train is not None and parts[:2] == ["backbone", "body"]:
            if not any(parts[2].startswith(prefix) for prefix in to_train):
                continue
        out[name] = p
    return out


def make_optimizer(params, lr: float | torch.Tensor = 1e-3, momentum: float = 0.9, weight_decay: float = 1e-4):
    """SGD with the weight decay added to the gradient before momentum
    (`train_step.py:53-57`, reference `code/train.py:80`), one fused kernel
    per step; `lr` a number or a 0-d float32 tensor on the parameters'
    device, which the step reads there."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay, fused=True)


def stage_batch(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """The batch's fields as tensors on `device`. A field on the host is
    copied into a fresh host buffer, page-locked on the card, and uploaded
    from there without a synchronize (as `Pipeline.chunk_inputs` uploads
    windows); a field already on the device passes as it is."""
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and (v.device == device or v.device.type != "cpu"):
            out[k] = v.to(device, non_blocking=True)
            continue
        host = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        staged = torch.empty(host.shape, dtype=torch.from_numpy(np.empty(0, host.dtype)).dtype, pin_memory=pin)
        staged.numpy()[...] = host
        out[k] = staged.to(device, non_blocking=True)
    return out


class Trainer:
    """The train step around a `Pipeline`, on the pipeline's device.

    A training batch (one window) is a dict of numpy arrays or tensors:
      images:      [W, H0, W0, 3] uint8, or float32 in [0, 1]; W = n_center + F - 1
      feat_valid:  [W] bool, False for frames outside the sequence
      frame_valid: [n] bool, centre frames that carry gt
      boxes:       [n, G, 4] float32, original-resolution XYXY
      labels:      [n, G] int32
      gt_valid:    [n, G] bool
      masks:       [n, G, H0, W0] uint8 binary

    The samplers' uniform draws (`make_draws`) come from the trainer's
    `torch.Generator` unless the caller passes its own to `step`.

    `lr` is a number or a schedule, a function of the update count (0 for
    the first optimizer step) that gives the learning rate, as an optax
    schedule does; a schedule runs as `LambdaLR` over an SGD whose base rate
    is 1, stepped after each optimizer step.

    `accumulate > 1` steps the optimizer every k-th call with the mean of
    the k gradients (optax `MultiSteps`, the reference OSVOS accumulation).
    Freeze policies of the reference's OSVOS (`osvos_model.py:12-29`):
    'none' = train_backbone and train_slow_fast, 'SF' = train_backbone
    only, 'BB_SF' = neither. The RoI heads always train.

    The trainer trains the pipeline's model in place and leaves it in eval
    mode after every step, so `pipe.infer_sequence` runs the SlowFast
    BatchNorms on their running statistics.

    `graphs`: on the card (the default there) every call's device work runs
    as a replay of a CUDA graph from the second call of its shape on, the
    gradient half and the update half each as one graph
    (`train/graphs.py`; `self.graphs` is the runner); `graphs=False` runs
    them eagerly, the yardstick. Off the card the trainer runs eagerly, and
    asking for graphs there raises."""

    def __init__(
        self,
        pipe: Pipeline,
        *,
        lr: float | Callable[[int], float] = 1e-3,
        momentum: float = 0.9,
        weight_decay: float = 1e-4,
        n_center: int = 2,
        train_slow_fast: bool = True,
        train_heads: bool = True,
        train_backbone: bool = False,
        trainable_backbone_layers: int | None = None,
        accumulate: int = 1,
        seed: int = 0,
        graphs: bool | None = None,
    ):
        on_card = pipe.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError(f"CUDA graphs run on a CUDA device; this trainer's model is on {pipe.device}")
        if getattr(pipe.model, "arch", "resnet50-fpn") != "resnet50-fpn":
            raise NotImplementedError(f"training runs arch='resnet50-fpn' only; {pipe.model.arch!r} runs inference")
        self.pipe = pipe
        self.model = pipe.model
        self.n_center = n_center
        keys = []
        if train_slow_fast:
            keys.append("slow_fast")
        if train_heads:
            keys.append("roi_heads")
        if train_backbone:
            keys += ["backbone", "rpn"]
        self.trainable_keys = tuple(keys)
        self.backbone_trainable = train_backbone
        tbl = trainable_backbone_layers if train_backbone else None
        self.params = trainable_parameters(self.model, self.trainable_keys, tbl)
        for name, p in self.model.named_parameters():
            p.requires_grad_(name in self.params)
            # Zero, not None: no gradient left over from an earlier trainer,
            # and a fixed address for this one's (module docstring).
            p.grad = torch.zeros_like(p) if name in self.params else None
        self.lr = torch.full((), 1.0 if callable(lr) else lr, dtype=torch.float32, device=pipe.device)
        self.optimizer = make_optimizer(list(self.params.values()), self.lr, momentum, weight_decay)
        for p in self.params.values():
            self.optimizer.state[p]["momentum_buffer"] = torch.zeros_like(p)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, lr) if callable(lr) else None
        self.accumulate = accumulate
        self.calls = 0
        self.generator = torch.Generator(device=pipe.device).manual_seed(seed)
        self.graphs = TrainStepGraphs(self) if (on_card if graphs is None else graphs) else None

    @property
    def num_anchors(self) -> int:
        return sum(a.shape[0] for a in self.pipe.anchors)

    def use_pipeline(self, pipe: Pipeline) -> None:
        """Train through `pipe`, another canvas over the same model: the
        optimizer, schedule, generator and call counter stay shared."""
        if pipe.model is not self.model:
            raise ValueError("use_pipeline: the pipeline wraps another model")
        self.pipe = pipe

    def make_draws(self, num_gt: int) -> dict[str, torch.Tensor]:
        """Uniform draws of one step's samplers: `rpn_pos`/`rpn_neg`
        [n, anchors] for the RPN loss and `box_pos`/`box_neg`
        [n, post-NMS proposals + num_gt] for the RoI sampling."""
        n = self.n_center
        boxes = self.pipe.cfg.rpn_post_nms_top_n_train + num_gt

        def draw(m):
            return torch.rand((n, m), generator=self.generator, device=self.pipe.device)

        return {"rpn_pos": draw(self.num_anchors), "rpn_neg": draw(self.num_anchors),
                "box_pos": draw(boxes), "box_neg": draw(boxes)}

    def loss(self, batch: dict, draws: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The window loss (`train_step.py:201-330`) and its metrics. Runs
        the SlowFast module in whatever mode the model is in (`step` puts it
        in train mode)."""
        pipe, cfg, model = self.pipe, self.pipe.cfg, self.model
        f, n = pipe.sf.fast, self.n_center
        b = stage_batch(batch, pipe.device)

        # Frozen backbone and RPN: no graph, as under the JAX stop_gradient.
        with torch.set_grad_enabled(self.backbone_trainable and torch.is_grad_enabled()):
            canvas = pipe.transform(b["images"])
            TRACER.mark("transform")
            feats = model.backbone_feats(canvas)
            zero = torch.zeros((), dtype=feats[0].dtype, device=feats[0].device)
            fv = b["feat_valid"].to(torch.bool)
            feats = [torch.where(fv[:, None, None, None], fl, zero) for fl in feats]
            TRACER.mark("backbone")
            center = slice(f // 2, f // 2 + n)
            obj, dlt = model.rpn_predict([fl[center] for fl in feats])
        with torch.no_grad():
            proposals, _scores, pvalid = filter_proposals(
                [o.detach() for o in obj], [d.detach() for d in dlt], pipe.anchors,
                image_hw=pipe.image_hw, cfg=cfg, training=True,
            )

        gt_boxes = pipe.transform.transform_boxes(b["boxes"].to(torch.float32))
        gt_valid = b["gt_valid"].to(torch.bool) & b["frame_valid"].to(torch.bool)[:, None]
        obj_loss, rpn_box_loss = rpn_loss(obj, dlt, pipe.anchors, gt_boxes, gt_valid, cfg, draws["rpn_pos"], draws["rpn_neg"])
        TRACER.mark("rpn")

        enhanced = [fl.contiguous() for fl in model.enhance(feats[:4], pre_padded=True)]
        TRACER.mark("slowfast")
        with torch.no_grad():
            samples = select_training_samples(
                proposals, pvalid, gt_boxes, b["labels"], gt_valid, cfg, draws["box_pos"], draws["box_neg"]
            )

        # Box branch over all [n, B] sampled rois.
        rois = samples["boxes"].contiguous()
        bsz = rois.shape[1]
        pooled7 = multiscale_roi_align(enhanced, rois, ROI_SCALES, output_size=7)
        cls, reg = model.box_predict(pooled7.reshape(n * bsz, *pooled7.shape[2:]))

        # Mask branch on the leading (positive-first) sampled rois.
        mr = min(cfg.mask_train_rois, bsz)
        mask_rois = rois[:, :mr].contiguous()
        with torch.no_grad():
            masks_canvas = pipe.transform.masks_to_canvas(b["masks"])
            mask_targets = project_masks_on_boxes(masks_canvas, samples["matched_gt"][:, :mr], mask_rois, cfg.mask_out_size)
        pooled14 = multiscale_roi_align(enhanced, mask_rois, ROI_SCALES, output_size=cfg.mask_roi_size)
        mo = cfg.mask_out_size
        mask_logits = model.mask_predict(pooled14.reshape(n * mr, *pooled14.shape[2:]))
        TRACER.mark("roi_heads")

        cls_l, box_l = fastrcnn_loss(cls.reshape(n, bsz, -1), reg.reshape(n, bsz, cfg.num_classes, 4), samples)
        mask_l = maskrcnn_loss(
            mask_logits.reshape(n, mr, mo, mo, cfg.num_classes), mask_targets,
            samples["labels"][:, :mr], samples["is_pos"][:, :mr],
        )

        fvalid = b["frame_valid"].to(torch.float32)
        # The sum over centre frames: the reference's per-frame backward.
        trainable_loss = ((cls_l + box_l + mask_l) * fvalid).sum()
        rpn_total = obj_loss + rpn_box_loss
        if not self.backbone_trainable:
            rpn_total = rpn_total.detach()
        total = trainable_loss + rpn_total * fvalid.sum() / fvalid.sum().clamp(min=1)
        metrics = {
            "loss": total,
            "loss_classifier": (cls_l * fvalid).sum(),
            "loss_box_reg": (box_l * fvalid).sum(),
            "loss_mask": (mask_l * fvalid).sum(),
            "loss_objectness": obj_loss,
            "loss_rpn_box_reg": rpn_box_loss,
        }
        TRACER.mark("loss")
        return total, {k: v.detach() for k, v in metrics.items()}

    def step(self, batch: dict, draws: dict | None = None) -> dict[str, torch.Tensor]:
        """One call: loss and gradient of the window in train mode, and an
        optimizer step on every `accumulate`-th call. Returns the metrics
        (`train_step.py:318-325`) as 0-d tensors on the device."""
        with TRACER.span("train.step", unit=True):
            TRACER.count("train.steps")
            metrics = self.accumulate_gradient(batch, draws)
            if self.calls % self.accumulate == 0:
                self.apply_update()
            return metrics

    def accumulate_gradient(self, batch: dict, draws: dict | None = None) -> dict[str, torch.Tensor]:
        """The first half of `step`: the loss and its gradient (divided by
        `accumulate`, added to the parameters' `.grad`) in train mode, the
        SlowFast running statistics updated, the call counted."""
        with TRACER.span("train.stage_batch"):
            batch = stage_batch(batch, self.pipe.device)
        if self.graphs is not None:
            metrics = self.graphs.gradient(batch, draws)
        else:
            metrics = self.device_gradient(batch, draws)
        self.calls += 1
        return metrics

    def device_gradient(self, batch: dict[str, torch.Tensor], draws: dict | None = None) -> dict[str, torch.Tensor]:
        """The device work of `accumulate_gradient` on a staged batch, which
        a gradient graph captures: the draws (unless given), the loss and
        its backward in train mode."""
        if draws is None:
            draws = self.make_draws(int(batch["boxes"].shape[1]))
        self.model.train()
        try:
            total, metrics = self.loss(batch, draws)
            (total / self.accumulate).backward()
            TRACER.mark("backward")
        finally:
            self.model.eval()
        return metrics

    def apply_update(self) -> None:
        """The second half of `step`: the optimizer step on the accumulated
        gradient, which it then zeroes, and the schedule's step."""
        group = self.optimizer.param_groups[0]
        if group["lr"] is not self.lr:  # a restored optimizer state brings its own rate
            self.lr.fill_(group["lr"])
            group["lr"] = self.lr
        if self.graphs is not None:
            self.graphs.apply_update()
        else:
            self.device_update()
        if self.scheduler is not None:
            self.scheduler.step()

    def device_update(self) -> None:
        """The device work of `apply_update`, which the update graph
        captures: the fused SGD step at the rate in `self.lr`, and the
        gradients zeroed in place."""
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=False)
        TRACER.mark("update")

    def eval_state_dict(self) -> dict[str, torch.Tensor]:
        """A copy of the model's state dict (weights and the SlowFast running
        statistics) that an inference `Pipeline`'s model loads
        (`train_step.py:353-357`)."""
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}
