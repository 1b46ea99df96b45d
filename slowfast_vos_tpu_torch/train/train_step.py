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

The optimizer is `torch.optim.SGD(lr, momentum, weight_decay)`, which
equals the JAX package's `optax.chain(add_decayed_weights(wd), sgd(lr,
momentum))`: both add wd * p to the gradient before the momentum trace,
and on the first step both traces equal that gradient.

RoI pooling of the sampled rois goes through the differentiable
`multiscale_roi_align`: the forward kernel and, for the gradient, the
backward kernel on CUDA; the plain versions on the CPU.
"""
from __future__ import annotations

from typing import Iterable

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


def make_optimizer(params, lr: float = 1e-3, momentum: float = 0.9, weight_decay: float = 1e-4):
    """SGD with the weight decay added to the gradient before momentum
    (`train_step.py:53-57`, reference `code/train.py:80`)."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


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

    `accumulate > 1` steps the optimizer every k-th call with the mean of
    the k gradients (optax `MultiSteps`, the reference OSVOS accumulation).
    Freeze policies of the reference's OSVOS (`osvos_model.py:12-29`):
    'none' = train_backbone and train_slow_fast, 'SF' = train_backbone
    only, 'BB_SF' = neither. The RoI heads always train.

    The trainer trains the pipeline's model in place and leaves it in eval
    mode after every step, so `pipe.infer_sequence` runs the SlowFast
    BatchNorms on their running statistics."""

    def __init__(
        self,
        pipe: Pipeline,
        *,
        lr: float = 1e-3,
        momentum: float = 0.9,
        weight_decay: float = 1e-4,
        n_center: int = 2,
        train_slow_fast: bool = True,
        train_heads: bool = True,
        train_backbone: bool = False,
        trainable_backbone_layers: int | None = None,
        accumulate: int = 1,
        seed: int = 0,
    ):
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
        self.optimizer = make_optimizer(list(self.params.values()), lr, momentum, weight_decay)
        self.accumulate = accumulate
        self.calls = 0
        self.num_anchors = sum(a.shape[0] for a in pipe.anchors)
        self.generator = torch.Generator(device=pipe.device).manual_seed(seed)

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
        b = {k: torch.as_tensor(v, device=pipe.device) for k, v in batch.items()}

        # Frozen backbone and RPN: no graph, as under the JAX stop_gradient.
        with torch.set_grad_enabled(self.backbone_trainable and torch.is_grad_enabled()):
            feats = model.backbone_feats(pipe.transform(b["images"]))
            zero = torch.zeros((), dtype=feats[0].dtype, device=feats[0].device)
            fv = b["feat_valid"].to(torch.bool)
            feats = [torch.where(fv[:, None, None, None], fl, zero) for fl in feats]
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

        enhanced = [fl.contiguous() for fl in model.enhance(feats[:4], pre_padded=True)]
        with torch.no_grad():
            samples = select_training_samples(
                proposals, pvalid, gt_boxes, b["labels"], gt_valid, cfg, draws["box_pos"], draws["box_neg"]
            )

        # Box branch over all [n, B] sampled rois.
        rois = samples["boxes"].contiguous()
        bsz = rois.shape[1]
        pooled7 = multiscale_roi_align(enhanced, rois, ROI_SCALES, output_size=7)
        cls, reg = model.box_predict(pooled7.reshape(n * bsz, *pooled7.shape[2:]))
        cls_l, box_l = fastrcnn_loss(cls.reshape(n, bsz, -1), reg.reshape(n, bsz, cfg.num_classes, 4), samples)

        # Mask branch on the leading (positive-first) sampled rois.
        mr = min(cfg.mask_train_rois, bsz)
        mask_rois = rois[:, :mr].contiguous()
        with torch.no_grad():
            masks_canvas = pipe.transform.masks_to_canvas(b["masks"])
            mask_targets = project_masks_on_boxes(masks_canvas, samples["matched_gt"][:, :mr], mask_rois, cfg.mask_out_size)
        pooled14 = multiscale_roi_align(enhanced, mask_rois, ROI_SCALES, output_size=cfg.mask_roi_size)
        mo = cfg.mask_out_size
        mask_logits = model.mask_predict(pooled14.reshape(n * mr, *pooled14.shape[2:]))
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
        return total, {k: v.detach() for k, v in metrics.items()}

    def step(self, batch: dict, draws: dict | None = None) -> dict[str, torch.Tensor]:
        """One call: loss and gradient of the window in train mode, and an
        optimizer step on every `accumulate`-th call. Returns the metrics
        (`train_step.py:318-325`) as 0-d tensors on the device."""
        if draws is None:
            draws = self.make_draws(int(batch["boxes"].shape[1]))
        self.model.train()
        try:
            total, metrics = self.loss(batch, draws)
            (total / self.accumulate).backward()
        finally:
            self.model.eval()
        self.calls += 1
        if self.calls % self.accumulate == 0:
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        return metrics

    def eval_state_dict(self) -> dict[str, torch.Tensor]:
        """A copy of the model's state dict (weights and the SlowFast running
        statistics) that an inference `Pipeline`'s model loads
        (`train_step.py:353-357`)."""
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}
