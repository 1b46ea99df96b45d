"""What `correct` is held against: the reference's inference over a
sequence and its first training steps, in plain PyTorch.

`infer_sequence` computes the backbone of every frame, pads the feature
clip with the temporal halo of zero frames once for the whole sequence (no
superchunks, so no carry), and runs the RPN, SlowFast, the RoI heads and
the paste a block of frames at a time. Given the program's detections
(`teacher`), it also pastes its own mask probabilities at the program's
boxes and labels, so that the program's masks can be judged apart from its
choice of boxes.

`train_steps` rebuilds the unsupervised training step (the port's
`Trainer.loss`: frozen backbone and RPN, SlowFast in train mode, the
sampled RoI heads' losses summed over the centre frames) and SGD with
momentum and weight decay added to the gradient, over given windows and
sampler draws.
"""
from __future__ import annotations

import time

import torch

from vosbench.reference import ops
from vosbench.reference.model import (
    Detection,
    Geometry,
    Model,
    anchors_for,
    fastrcnn_loss,
    filter_proposals,
    maskrcnn_loss,
    postprocess,
    project_masks,
    rpn_loss,
    select_training_samples,
    set_fp8,
)

TRAINABLE = ("slow_fast.", "roi_heads.")
STATISTICS = "slow_fast.bn_"  # SlowFast's train-mode BatchNorms: their running statistics move in a step
RUNNING = ("running_mean", "running_var")


def build(slow: int, fast: int, cfg: Detection, state: dict, device, fp8: bool = False,
          rank_dtype=torch.float32) -> Model:
    """The reference model in float32 with `state` loaded (the benchmark's
    weights, never the program's); scores rank as values of `rank_dtype`,
    the configuration's compute dtype (`model.filter_proposals`)."""
    model = Model(slow, fast, cfg, rank_dtype).to(device)
    model.load_state_dict(state, strict=True)
    set_fp8(model, fp8)
    return model.eval()


def _masks(model, enhanced, canvas_boxes, labels, cfg):
    """Mask probabilities [T, D, 28, 28] of `labels` at canvas boxes [T, D, 4]."""
    t, d = canvas_boxes.shape[:2]
    pooled = ops.multiscale_roi_align(enhanced, canvas_boxes, output_size=cfg.mask_roi_size)
    logits = model.roi_heads.mask_predict(pooled.reshape(t * d, *pooled.shape[2:]))
    logits = logits.reshape(t, d, cfg.mask_out_size, cfg.mask_out_size, -1)
    idx = labels.long()[..., None, None, None].expand(t, d, cfg.mask_out_size, cfg.mask_out_size, 1)
    return torch.sigmoid(torch.gather(logits, -1, idx)[..., 0])


def _margin(probs, orig_boxes, valid, hw):
    """[T, H, W]: the largest pasted probability of a valid detection at each
    pixel, less 0.5 (-0.5 where none covers it); the union is margin >= 0."""
    t, d = valid.shape
    pasted = ops.paste_masks(probs.reshape(t * d, *probs.shape[2:]), orig_boxes.reshape(-1, 4), hw, valid.reshape(-1))
    pasted = torch.where(valid[..., None, None], pasted.reshape(t, d, *hw), 0.0)
    return pasted.amax(dim=1) - 0.5


class _Clock:
    def __init__(self, timings, device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def __call__(self, stage):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + now - self.t
        self.t = now


@torch.no_grad()
def infer_sequence(model: Model, geom: Geometry, frames: torch.Tensor, *, block: int = 8, teacher: dict | None = None,
                   timings: dict | None = None):
    """frames: uint8 [T, H, W, 3] on the model's device. `teacher`: the
    program's `boxes` [T, D, 4] (original resolution), `labels` and `valid`
    [T, D]. Returns per-frame tensors: the reference's own detections
    (`boxes` at original resolution, `scores`, `valid`, `union`), every
    proposal's foreground candidate (`cand_boxes`, `cand_scores`) and, with
    a teacher, `teacher_margin`: the reference's masks at the
    program's boxes and labels, pasted as the program does, as the margin
    of `_margin`, whose sign is the union the program should have made.
    `timings`, where given, gathers the seconds of each stage (each stage
    then ends in a synchronize)."""
    clock = _Clock(timings, frames.device)
    cfg = model.cfg
    f = model.slow_fast.fast
    t = frames.shape[0]
    hw = geom.original_hw
    image_hw = tuple(float(v) for v in geom.resized_hw)
    anchors = anchors_for(geom.feature_hws, frames.device)
    levels = [[] for _ in range(5)]
    for a in range(0, t, block):
        for lvl, x in zip(levels, model.backbone(geom.canvas(frames[a : a + block]))):
            lvl.append(x)
    feats = [torch.cat(lvl) for lvl in levels]
    clock("backbone")
    left, right = f // 2, -(-f // 2) - 1
    padded = [torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, left, right)) for x in feats[:4]]
    out = {k: [] for k in ("boxes", "scores", "valid", "union", "cand_boxes", "cand_scores", "teacher_margin")}
    for a in range(0, t, block):
        b = min(a + block, t)
        obj, dlt = model.rpn([x[a:b] for x in feats])
        proposals, pvalid = filter_proposals(obj, dlt, anchors, image_hw, cfg, training=False,
                                             rank_dtype=model.rank_dtype)
        clock("rpn")
        enhanced = [model.slow_fast(x[a : b + f - 1]) for x in padded]
        clock("slowfast")
        n, p = proposals.shape[:2]
        pooled = ops.multiscale_roi_align(enhanced, proposals, output_size=7)
        cls, reg = model.roi_heads.box_predict(pooled.reshape(n * p, *pooled.shape[2:]))
        (boxes, scores, labels, valid), (cand_boxes, cand_scores) = postprocess(
            cls.reshape(n, p, -1), reg.reshape(n, p, cfg.num_classes, 4), proposals, pvalid, image_hw, cfg,
            model.rank_dtype)
        clock("box")
        orig = geom.to_original(boxes)
        out["boxes"].append(orig)
        out["scores"].append(torch.where(valid, scores, 0.0))
        out["valid"].append(valid)
        out["union"].append(_margin(_masks(model, enhanced, boxes, labels, cfg), orig, valid, hw) >= 0)
        out["cand_boxes"].append(geom.to_original(cand_boxes))
        out["cand_scores"].append(cand_scores)
        if teacher is not None:
            tb = teacher["boxes"][a:b]
            probs = _masks(model, enhanced, geom.to_canvas(tb), teacher["labels"][a:b], cfg)
            out["teacher_margin"].append(_margin(probs, tb, teacher["valid"][a:b], hw))
        clock("masks")
    return {k: torch.cat(v) for k, v in out.items() if v}


def window_loss(model: Model, geom: Geometry, batch: dict, draws: dict, anchors, n_center: int, half_batch: bool = False):
    """The window's loss, as the program's train step defines it: the RoI
    heads' losses summed over the valid centre frames, plus the frozen
    RPN's losses (no gradient). `half_batch` keeps the first half of the
    centre frames and scales it to the whole: a planted fault."""
    cfg = model.cfg
    f = model.slow_fast.fast
    dev = anchors[0].device
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    image_hw = tuple(float(v) for v in geom.resized_hw)
    with torch.no_grad():
        feats = model.backbone(geom.canvas(b["images"]))
        fv = b["feat_valid"].bool()
        feats = [torch.where(fv[:, None, None, None], x, 0.0) for x in feats]
        obj, dlt = model.rpn([x[f // 2 : f // 2 + n_center] for x in feats])
        proposals, pvalid = filter_proposals(obj, dlt, anchors, image_hw, cfg, training=True,
                                             rank_dtype=model.rank_dtype)
        gt_boxes = geom.to_canvas(b["boxes"].float())
        gt_valid = b["gt_valid"].bool() & b["frame_valid"].bool()[:, None]
        obj_loss, rpn_box = rpn_loss(obj, dlt, anchors, gt_boxes, gt_valid, cfg, draws["rpn_pos"], draws["rpn_neg"])
        samples = select_training_samples(proposals, pvalid, gt_boxes, b["labels"], gt_valid, cfg,
                                          draws["box_pos"], draws["box_neg"])
    enhanced = [model.slow_fast(x) for x in feats[:4]]
    rois = samples["boxes"]
    n, nb = rois.shape[:2]
    pooled7 = ops.multiscale_roi_align(enhanced, rois, output_size=7)
    cls, reg = model.roi_heads.box_predict(pooled7.reshape(n * nb, *pooled7.shape[2:]))
    cls_l, box_l = fastrcnn_loss(cls.reshape(n, nb, -1), reg.reshape(n, nb, cfg.num_classes, 4), samples)
    mr = min(cfg.mask_train_rois, nb)
    with torch.no_grad():
        targets = project_masks(geom.masks_to_canvas(b["masks"]), samples["matched_gt"][:, :mr], rois[:, :mr],
                                cfg.mask_out_size)
    pooled14 = ops.multiscale_roi_align(enhanced, rois[:, :mr], output_size=cfg.mask_roi_size)
    logits = model.roi_heads.mask_predict(pooled14.reshape(n * mr, *pooled14.shape[2:]))
    mask_l = maskrcnn_loss(logits.reshape(n, mr, cfg.mask_out_size, cfg.mask_out_size, -1), targets,
                           samples["labels"][:, :mr], samples["is_pos"][:, :mr])
    fvalid = b["frame_valid"].float()
    weight = fvalid
    if half_batch:
        keep = torch.arange(n, device=dev) < n // 2
        weight = torch.where(keep, fvalid * n / (n // 2), 0.0)
    rpn_total = (obj_loss + rpn_box).detach()
    return ((cls_l + box_l + mask_l) * weight).sum() + rpn_total * fvalid.sum() / fvalid.sum().clamp(min=1)


def train_steps(model: Model, geom: Geometry, batches: list, draws: list, *, n_center: int, lr: float,
                momentum: float, weight_decay: float, half_batch: bool = False):
    """SGD steps of `model` over `batches` with the samplers' `draws`.
    Returns (losses, the first step's gradient by name, each trainable
    parameter's change over the steps by name, each running statistic's
    change over the steps by name)."""
    params = {k: p for k, p in model.named_parameters() if k.startswith(TRAINABLE)}
    stats = {k: b for k, b in model.named_buffers() if k.startswith(STATISTICS) and k.endswith(RUNNING)}
    start_stats = {k: b.detach().clone() for k, b in stats.items()}
    for k, p in model.named_parameters():
        p.requires_grad_(k in params)
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = torch.optim.SGD(list(params.values()), lr=lr, momentum=momentum, weight_decay=weight_decay, foreach=False)
    anchors = anchors_for(geom.feature_hws, next(model.parameters()).device)
    losses, first = [], None
    for batch, dr in zip(batches, draws):
        model.slow_fast.train()
        loss = window_loss(model, geom, batch, dr, anchors, n_center, half_batch)
        loss.backward()
        model.eval()
        if first is None:
            first = {k: p.grad.detach().clone() for k, p in params.items()}
        opt.step()
        opt.zero_grad(set_to_none=False)
        losses.append(float(loss.detach()))
    return (losses, first, {k: p.detach() - start[k] for k, p in params.items()},
            {k: b.detach() - start_stats[k] for k, b in stats.items()})
